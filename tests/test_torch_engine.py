"""The port's ``Captioner.run`` == ``conzic_tpu``'s, caption ids byte for byte.

Both captioners carry the same fp32 towers (tiny random ones initialised
as ``init_mode="proper"`` does, and the ``trained_tiny/`` checkpoint) and get the same image
embeddings and the same seeded schedule ``RandomState``. The caption ids of
every iteration and of the best-by-cosine pick must be identical, and the
cosines agree within 1e-4.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import TRAINED_TINY, port_captioner
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.sampler import Captioner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PAIRS = {}


def _pair(source):
    """(jax captioner, port captioner) on fp32 towers, built once."""
    if source not in _PAIRS:
        cfg = JaxConfig(dtype="float32")
        if source == "random":
            # init_mode="proper" params, with the flax init compiled: run
            # eagerly it takes seconds per tower
            fast = JaxCaptioner.from_random(config=cfg, seed=3)
            key = jax.random.PRNGKey(3)
            bp = jax.jit(fast.bert_model.init_params)(
                jax.random.fold_in(key, 0))
            cp = jax.jit(fast.clip_model.init_params)(
                jax.random.fold_in(key, 1))
            jc = JaxCaptioner(fast.bert_model, bp, fast.clip_model, cp,
                              fast.wp, fast.bpe, cfg)
            _PAIRS[source] = (jc, port_captioner(jc, dtype="float32"))
        else:
            jc = JaxCaptioner.from_tiny_dir(cfg, TRAINED_TINY)
            _PAIRS[source] = (jc, port_captioner(jc, bpe_dir=TRAINED_TINY,
                                                 dtype="float32"))
    return _PAIRS[source]


def _assert_same_run(source, cfg_kw, embeds, **run_kw):
    """Run both captioners with the config fields ``cfg_kw`` set on both
    (both read them at run time), then restore them."""
    caps = _pair(source)
    saved = [{k: getattr(c.cfg, k) for k in cfg_kw} for c in caps]
    for c in caps:
        for k, v in cfg_kw.items():
            setattr(c.cfg, k, v)
    try:
        jc, pc = caps
        args = dict(prompt="Image of a", temperature=0.1, alpha=0.02,
                    beta=2.0, **run_kw)
        want = jc.run(jnp.asarray(embeds), rng=np.random.RandomState(7),
                      **args)
        got = pc.run(embeds, rng=np.random.RandomState(7), **args)
    finally:
        for c, old in zip(caps, saved):
            for k, v in old.items():
                setattr(c.cfg, k, v)
    np.testing.assert_array_equal(got.iter_ids, np.asarray(want.iter_ids))
    np.testing.assert_array_equal(got.best_ids, np.asarray(want.best_ids))
    assert got.gen_texts_list == want.gen_texts_list
    np.testing.assert_allclose(np.asarray(got.clip_score_sequence),
                               np.asarray(want.clip_score_sequence),
                               rtol=0, atol=1e-4)
    return got


def _embeds(source, batch):
    dim = _pair(source)[0].clip_model.config.projection_dim
    return np.random.RandomState(1).randn(batch, dim).astype(np.float32)


# kv_chunk_size only splits the sequential sweep: the other orders take
# one prefix chunk whatever its value
@pytest.mark.parametrize("order,kv_chunk_size", [
    ("sequential", 16), ("sequential", 2), ("shuffle", 16), ("random", 16),
])
def test_run_matches_reference(order, kv_chunk_size):
    _assert_same_run("random", dict(kv_chunk_size=kv_chunk_size),
                     _embeds("random", 2), max_len=5, top_k=12, max_iter=2,
                     order=order)


@pytest.mark.parametrize("cfg_kw", [
    dict(clip_row_chunk=8),  # 2 images x 12 candidates -> 3 row chunks
    dict(kv_chunk_size=0),  # no prefix K/V: every candidate row in full
])
def test_run_matches_reference_chunked_and_full_rows(cfg_kw):
    _assert_same_run("random", cfg_kw, _embeds("random", 2), max_len=5,
                     top_k=12, max_iter=2, order="sequential")


def test_run_n_samples_matches_reference_and_splits():
    got = _assert_same_run("random", {}, _embeds("random", 2), max_len=4,
                           top_k=8, max_iter=2, order="shuffle", n_samples=2)
    parts = Captioner.split_samples(got, 2)
    assert [p.iter_ids.shape[1] for p in parts] == [2, 2]
    np.testing.assert_array_equal(
        np.concatenate([p.best_ids for p in parts]), got.best_ids)


@pytest.mark.parametrize("order", ["sequential", "shuffle"])
def test_trained_tiny_run_matches_reference(order):
    got = _assert_same_run("trained_tiny", {}, _embeds("trained_tiny", 3),
                           max_len=6, top_k=16, max_iter=2, order=order,
                           n_samples=2)
    assert len(got.gen_texts_list) == 3  # two iterations, then the best


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Captioner.from_random()


@pytest.mark.parametrize("knob,value", [
    ("bridge_mode", "exact"), ("prune_k", 4), ("clip_window", 16),
    ("quant", "int8"), ("topk_mode", "approx"), ("mask_impl", "compare"),
    ("scan_layers", True), ("mesh_data_axis", 2),
])
def test_unported_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        ConzicConfig(**{knob: value}).validate()


def test_controlled_generation_raises():
    _, pc = _pair("random")
    with pytest.raises(NotImplementedError, match="ctl"):
        pc.run(_embeds("random", 1), prompt="Image of a", max_len=3, top_k=4,
               temperature=0.1, max_iter=1, alpha=0.02, beta=2.0,
               ctl="sentiment")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without JAX and
    without the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import conzic_torch
        for m in pkgutil.walk_packages(conzic_torch.__path__, "conzic_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "conzic_tpu"))
        assert not bad, bad
        print("ok", len([m for m in sys.modules
                         if m.startswith("conzic_torch.")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
