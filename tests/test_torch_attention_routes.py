"""The reference's XLA attention routes in the port (``attn_impl`` "xla",
"xla_bhsd", "twoblock"), against ``conzic_tpu`` on the CPU.

The formulations themselves (``conzic_torch/ops/attention.py``) against the
reference's functions on seeded inputs, fp32 within 1e-6 (sums in another
order); the additive bias equal to the reference's; and captioning under
each route with the reference's towers built for the same route: caption
ids byte for byte, with the prompt's prefix K/V (kv_chunk_size 16) and
without (0, every candidate row in full), and under the int8 tier, where
``twoblock`` leaves its two-block form as the reference does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import port_captioner
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_tpu.models.bert import BertForMaskedLM as JaxBert
from conzic_tpu.models.clip import CLIPModel as JaxClip
from conzic_tpu.ops import attention as jax_attention
from conzic_torch.config import ATTN_IMPLS, ConzicConfig
from conzic_torch.engine.sampler import tower_quants
from conzic_torch.ops import attention
from test_torch_engine import _base_pair, _embeds

ROUTES = ("xla", "xla_bhsd", "twoblock")
TOL = dict(rtol=1e-6, atol=1e-6)


def _qkv(seed, N=6, Sq=5, Sk=7, H=2, D=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(N, S, H, D).astype(np.float32)
            for S in (Sq, Sk, Sk)]


@pytest.mark.parametrize("causal", [False, True])
def test_additive_bias_equals_the_reference(causal):
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                    np.int32)
    want = jax_attention.make_attention_bias(jnp.asarray(mask), 5,
                                             causal=causal)
    got = attention.additive_bias(
        attention.make_attn_mask(torch.from_numpy(mask), causal=causal),
        3, 5, 5, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert attention.additive_bias(attention.AttnMask(), 3, 5, 5,
                                   torch.device("cpu")) is None


@pytest.mark.parametrize("impl", ["xla", "xla_bhsd"])
@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches_reference(impl, causal):
    q, k, v = _qkv(0)
    lens = np.array([7, 3, 5, 7, 1, 6], np.int32)
    mask = attention.AttnMask(lens=torch.from_numpy(lens), causal=causal)
    bias = attention.additive_bias(mask, 6, 5, 7, torch.device("cpu"))
    want = jax_attention.dot_product_attention(
        *(jnp.asarray(t) for t in (q, k, v)), bias=jnp.asarray(bias.numpy()),
        impl=impl)
    got = attention.dot_product_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), bias, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_two_block_prefix_attention_matches_reference():
    q, k, v = _qkv(1, N=6, Sq=4, Sk=4)
    rng = np.random.RandomState(2)
    pk, pv = (rng.randn(2, 3, 2, 8).astype(np.float32) for _ in range(2))
    lens = torch.tensor([7, 5, 6, 4, 7, 3], dtype=torch.int32)
    bias = attention.additive_bias(attention.AttnMask(lens=lens, causal=True),
                                   6, 4, 7, torch.device("cpu"))
    want = jax_attention.two_block_prefix_attention(
        *(jnp.asarray(t) for t in (q, k, v, pk, pv)),
        jnp.asarray(bias.numpy()))
    got = attention.two_block_prefix_attention(
        *(torch.from_numpy(t) for t in (q, k, v, pk, pv)), bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_routes_are_accepted_and_unknown_ones_raise():
    for impl in ATTN_IMPLS:
        ConzicConfig(attn_impl=impl).validate()
    with pytest.raises(ValueError, match="attn_impl"):
        ConzicConfig(attn_impl="xla?").validate()


_PAIRS = {}


def _route_pair(attn_impl, quant="none"):
    """(reference, port) captioners on test_torch_engine's tiny fp32
    towers, both built for ``attn_impl`` and the ``quant`` tier."""
    key = (attn_impl, quant)
    if key not in _PAIRS:
        jc, _ = _base_pair("random")
        bq, cq = tower_quants(quant)
        cfg = type(jc.cfg)(dtype="float32", attn_impl=attn_impl,
                           quant=quant)
        jq = JaxCaptioner(
            JaxBert(jc.bert_model.config, dtype=jnp.float32,
                    attn_impl=attn_impl, quant=bq), jc.params["bert"],
            JaxClip(jc.clip_model.config, dtype=jnp.float32,
                    attn_impl=attn_impl, quant=cq), jc.params["clip"],
            jc.wp, jc.bpe, cfg)
        _PAIRS[key] = (jq, port_captioner(jc, dtype="float32",
                                          attn_impl=attn_impl, quant=quant))
    return _PAIRS[key]


def _assert_same(attn_impl, quant="none", **run_kw):
    jq, pq = _route_pair(attn_impl, quant)
    kv = run_kw.pop("kv_chunk_size", 16)
    jq.cfg.kv_chunk_size = pq.cfg.kv_chunk_size = kv
    embeds = _embeds("random", 2)
    args = dict(prompt="Image of a", temperature=0.1, alpha=0.02, beta=2.0,
                max_len=5, top_k=12, max_iter=2, **run_kw)
    want = jq.run(jnp.asarray(embeds), rng=np.random.RandomState(7), **args)
    got = pq.run(embeds, rng=np.random.RandomState(7), **args)
    np.testing.assert_array_equal(got.iter_ids, np.asarray(want.iter_ids))
    np.testing.assert_array_equal(got.best_ids, np.asarray(want.best_ids))
    assert got.gen_texts_list == want.gen_texts_list
    np.testing.assert_allclose(np.asarray(got.clip_score_sequence),
                               np.asarray(want.clip_score_sequence),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("kv_chunk_size", [16, 0])
@pytest.mark.parametrize("order", ["sequential", "shuffle"])
@pytest.mark.parametrize("attn_impl", ROUTES)
def test_route_matches_reference(attn_impl, order, kv_chunk_size):
    _assert_same(attn_impl, order=order, kv_chunk_size=kv_chunk_size)


@pytest.mark.parametrize("attn_impl", ["twoblock", "xla_bhsd"])
def test_route_under_int8_matches_reference(attn_impl):
    _assert_same(attn_impl, quant="int8", order="sequential")


def test_route_with_samples_matches_reference():
    _assert_same("twoblock", order="shuffle", n_samples=2)
