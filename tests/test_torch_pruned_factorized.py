"""The port's factorized stage-1 == ``conzic_tpu``'s, caption ids byte for
byte.

One tiny fp32 pair (``init_mode="proper"`` towers, the CLIP text tower 4
layers deep) captions two images at k=16, sentence_len 5, 2 iterations; each
case runs the reference once and the port on the reference's tables and on
its own (``_torch_port.PrunedPair``). Cases: 2 of 4 layers, the automatic
depth, the proxy pre-cut, and the tower pre-cut (1 layer) under every
``attn_impl``. Also held: the windowed stage-1 encode equals the full
width's, and the reference's, on rows that fit the window.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import (  # noqa: F401  (one_torch_thread: a fixture)
    PrunedPair,
    jax_tiny_captioner,
    one_torch_thread,
)
from conzic_tpu.engine import gibbs as jax_gibbs
from conzic_tpu.models.clip import CLIPTextTower as JaxTextTower
from conzic_tpu.models.clip import truncated_text_params
from conzic_torch.engine import gibbs
from conzic_torch.models.clip import TruncatedTextTower
from conzic_torch.text.bridge import assemble_clip_ids_substitute

_PAIR = []
RUN = dict(max_len=5, top_k=16, max_iter=2)
FACT = dict(prune_k=4, prune_stage1="factorized", prune_stage1_layers=2)


def _pair() -> PrunedPair:
    if not _PAIR:
        _PAIR.append(PrunedPair(jax_tiny_captioner(text_layers=4)))
    return _PAIR[0]


def _embeds(batch=2):
    dim = _pair().jax.clip_model.config.projection_dim
    return np.random.RandomState(1).randn(batch, dim).astype(np.float32)


@pytest.mark.parametrize("cfg_kw", [
    FACT,
    dict(FACT, prune_stage1_layers=0),  # the automatic depth
    dict(FACT, prune_stage1_precut=8),  # the proxy pre-cut
])
def test_factorized_tier_matches_reference(cfg_kw):
    _pair().check(cfg_kw, _embeds(), order="sequential", **RUN)


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_out",
                                       "pallas_block"])
def test_factorized_tower_precut_matches_reference(attn_impl):
    _pair().check(dict(FACT, prune_stage1_precut=8,
                       prune_stage1_precut_mode="tower",
                       prune_stage1_precut_layers=1),
                  _embeds(), attn_impl=attn_impl, order="sequential", **RUN)


@pytest.mark.parametrize("prefix", [0, 4])
def test_windowed_stage1_encode_is_the_full_width(prefix):
    """The stage-1 encode of (2, 6) candidate rows that end inside the
    window: over the window's columns only, over the full width, and the
    reference's windowed encode, on the same projection."""
    pair = _pair()
    port, _ = pair.ports()
    jc = pair.jax
    seed_len = port.seed_len("Image of a")
    init = port.init_ids("Image of a", 5, 2)
    rng = np.random.RandomState(2)
    idxs = rng.randint(5, port.wp.vocab_size, size=(2, 6))
    col = np.full(2, seed_len + 1)
    t = port.tables
    ids, mask = assemble_clip_ids_substitute(
        torch.from_numpy(init[:, 1:-1]).long(), torch.from_numpy(idxs),
        torch.from_numpy(col - 1), t["bridge_ids"], t["bridge_lens"],
        bos_id=port.bridge.bos_id, eos_id=port.bridge.eos_id,
        pad_id=port.bridge.pad_id, clip_len=32)
    assert not mask[:, :, 24:].any()  # the rows fit the window
    wcal = np.random.RandomState(3).randn(64, 32).astype(np.float32)
    out = {}
    for window in (0, 24):
        spec = gibbs.EngineSpec(
            seed_len=seed_len, sentence_len=5, seq_len=init.shape[1],
            candidate_k=6, clip_len=32, mask_token_id=port.wp.mask_token_id,
            clip_bos_id=port.bridge.bos_id, clip_eos_id=port.bridge.eos_id,
            clip_pad_id=port.bridge.pad_id, clip_window=window)
        tower = TruncatedTextTower(port.clip_model.text_model, 2)
        with torch.inference_mode():
            out[window] = gibbs._encode_candidates(
                spec, port.clip_model, ids, mask, prefix,
                s1=(tower, torch.from_numpy(wcal))).numpy()
    # the same function; the products round apart over the narrower rows
    np.testing.assert_allclose(out[24], out[0], rtol=1e-5, atol=1e-5)
    jspec = jax_gibbs.EngineSpec(**{
        f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
        if f.name in {g.name for g in dataclasses.fields(
            jax_gibbs.EngineSpec)}})
    text = dataclasses.replace(jc.clip_model.config.text, num_layers=2)
    want = jax_gibbs._encode_candidates(
        jspec, jc.clip_model, jc.params, jnp.asarray(ids.numpy()),
        jnp.asarray(mask.numpy()), prefix,
        s1=(JaxTextTower(text, dtype=jnp.float32),
            truncated_text_params(jc.params["clip"], 2), jnp.asarray(wcal)))
    np.testing.assert_allclose(out[24], np.asarray(want), rtol=0, atol=2e-4)
