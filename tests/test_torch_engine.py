"""The port's ``Captioner.run`` == ``conzic_tpu``'s, caption ids byte for byte.

Both captioners carry the same fp32 towers (tiny random ones initialised
as ``init_mode="proper"`` does, and the ``trained_tiny/`` checkpoint) and get the same image
embeddings and the same seeded schedule ``RandomState``. The caption ids of
every iteration and of the best-by-cosine pick must be identical, and the
cosines agree within 1e-4. The port runs under each of its ``attn_impl``
values (those cases, and the span and parallel orders, are in
``tests/test_torch_engine_orders.py``); the reference keeps its plain
attention route, which is what its own ``pallas_out`` and
``pallas_block`` take on the CPU.
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

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import TRAINED_TINY, port_captioner
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_tpu.engine.primitives import generate_step as jax_generate_step
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.primitives import generate_step
from conzic_torch.engine.sampler import Captioner
from conzic_torch.models.layers import TransformerBlock
from conzic_torch.ops.attention import AttnMask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PAIRS = {}
_PORTS = {}
_WANT = {}


def _pair(source, attn_impl="pallas"):
    """(jax captioner, port captioner under ``attn_impl``) on the same fp32
    towers, each built once."""
    jc, pc = _base_pair(source)
    if attn_impl != "pallas" and (source, attn_impl) not in _PORTS:
        bpe_dir = TRAINED_TINY if source == "trained_tiny" else None
        _PORTS[source, attn_impl] = port_captioner(
            jc, bpe_dir=bpe_dir, dtype="float32", attn_impl=attn_impl)
    return jc, _PORTS.get((source, attn_impl), pc)


def _base_pair(source):
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


def _assert_same_run(source, cfg_kw, embeds, attn_impl="pallas", **run_kw):
    """Run both captioners with the config fields ``cfg_kw`` set on both
    (both read them at run time), then restore them. The reference's result
    is kept: it is the same for every ``attn_impl`` of the port."""
    caps = _pair(source, attn_impl)
    saved = [{k: getattr(c.cfg, k) for k in cfg_kw} for c in caps]
    for c in caps:
        for k, v in cfg_kw.items():
            setattr(c.cfg, k, v)
    try:
        jc, pc = caps
        args = dict(prompt="Image of a", temperature=0.1, alpha=0.02,
                    beta=2.0, **run_kw)
        key = repr((source, sorted(cfg_kw.items()), embeds.shape,
                    sorted(run_kw.items())))
        if key not in _WANT:
            _WANT[key] = jc.run(jnp.asarray(embeds),
                                rng=np.random.RandomState(7), **args)
        want = _WANT[key]
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


def _step_logits():
    return np.random.RandomState(5).randn(6, 4, 50).astype(np.float32)


@pytest.mark.parametrize("temperature", [None, 0.5])
def test_generate_step_greedy_matches_reference(temperature):
    out = _step_logits()
    want = jax_generate_step(jnp.asarray(out), 2, temperature=temperature)
    got = generate_step(torch.from_numpy(out), 2, temperature=temperature)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_step_top_k_is_seeded_and_stays_in_the_top_k():
    out = torch.from_numpy(_step_logits())
    top = torch.topk(out[:, 1], 5, dim=-1).indices
    draws = [generate_step(out, 1, torch.Generator().manual_seed(s),
                           temperature=0.7, top_k=5, sample=True)
             for s in (11, 11, 12, 13, 14)]
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    assert any((d != draws[0]).any() for d in draws[2:])
    for d in draws:
        assert (top == d[:, None].long()).any(dim=1).all()
    full = generate_step(out, 1, torch.Generator().manual_seed(3),
                         sample=True)
    assert full.shape == (6,) and ((0 <= full) & (full < 50)).all()


@pytest.mark.parametrize("kw", [dict(top_k=3), dict(sample=True)])
def test_generate_step_sampling_needs_a_generator(kw):
    with pytest.raises(ValueError, match="generator"):
        generate_step(torch.from_numpy(_step_logits()), 0, **kw)


def test_pooled_final_layer_refuses_several_causal_rows():
    block = TransformerBlock(2, 4, 16, "quick_gelu", 1e-5, pre_ln=True)
    x = torch.zeros(2, 5, 8)
    with pytest.raises(NotImplementedError, match="causal"):
        block(x, AttnMask(causal=True),
              query_idx=torch.tensor([[1, 2], [0, 3]]))


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Captioner.from_random()


# the pruned tiers, the int8 tier and the mesh are ported: the pruned
# refusals are in tests/test_torch_pruned.py
@pytest.mark.parametrize("knob,value", [("scan_layers", True)])
def test_unported_knobs_raise(knob, value):
    with pytest.raises(NotImplementedError, match=knob):
        ConzicConfig(**{knob: value}).validate()


@pytest.mark.parametrize("knob", ["bridge_mode", "ctl_mode"])
def test_unknown_host_modes_raise(knob):
    ConzicConfig(**{knob: "exact"}).validate()
    with pytest.raises(ValueError, match=knob):
        ConzicConfig(**{knob: "approximate"}).validate()


def test_controlled_generation_raises():
    """An unknown control raises; "sentiment" and "pos" run
    (tests/test_torch_control_engine.py)."""
    _, pc = _pair("random")
    with pytest.raises(ValueError, match="ctl"):
        pc.run(_embeds("random", 1), prompt="Image of a", max_len=3, top_k=4,
               temperature=0.1, max_iter=1, alpha=0.02, beta=2.0,
               ctl="style")


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
