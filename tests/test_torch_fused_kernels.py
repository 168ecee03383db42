"""The plain versions of the port's two fused attention kernels == the
Pallas kernels they replace.

``conzic_torch.kernels.attention_with_out`` and
``conzic_torch.kernels.attention_block`` take their plain PyTorch versions
for CPU tensors. Both are held against the JAX package's Pallas kernels run
in interpret mode, as tests/test_fused_attention.py runs them: at fp32 with
that file's tolerances (1e-4 for the with-out kernel, 2e-4 for the block
kernel), every row compared, and once each in bf16. The port's weights are
those of PyTorch ``Linear``s, the transposes of the flax kernels. The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import np_tree, port_bert_config
from conzic_tpu.models import configs as jax_configs
from conzic_tpu.models.bert import BertForMaskedLM as JaxBert
from conzic_tpu.ops.fused_attention import fused_attention_with_out
from conzic_tpu.ops.fused_attn_block import fused_attention_block
from conzic_torch.kernels.attention_block import (
    attention_block,
    attention_block_plain,
)
from conzic_torch.kernels.attention_with_out import (
    attention_with_out,
    attention_with_out_plain,
)
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.convert import from_jax_params

WITH_OUT_TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16: the two frameworks round at the same places but sum in fp32 in
# another order, which can flip a rounding of q, k, v or the context before
# the output is rounded again: two bf16 ulps (2^-7 each) of max(|ref|, 1)
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _edge_lens(rng, N, hi):
    """Key lengths from 0 (no key kept: a uniform softmax over all keys,
    not NaN) to ``hi``, both ends present."""
    lens = rng.randint(0, hi + 1, size=N).astype(np.int32)
    lens[0], lens[-1] = 0, hi
    return lens


def _with_out_inputs(rng, N, Sq, Sk, H, D, E, with_lens):
    q = rng.randn(N, Sq, H, D).astype(np.float32)
    k = rng.randn(N, Sk, H, D).astype(np.float32)
    v = rng.randn(N, Sk, H, D).astype(np.float32)
    wo = (rng.randn(H * D, E) * 0.1).astype(np.float32)  # the flax layout
    bo = rng.randn(E).astype(np.float32)
    lens = None
    if with_lens == "edge":
        lens = _edge_lens(rng, N, Sk)
    elif with_lens:
        lens = rng.randint(Sk - Sq + 1, Sk + 1, size=N).astype(np.int32)
    return q, k, v, wo, bo, lens


def _with_out_both(q, k, v, wo, bo, lens, causal, dtype=torch.float32):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = fused_attention_with_out(
        *(jnp.asarray(a, jdt) for a in (q, k, v, wo)), jnp.asarray(bo),
        None if lens is None else jnp.asarray(lens), causal=causal, group=3,
        interpret=True)
    args = (_t(q, dtype), _t(k, dtype), _t(v, dtype),
            _t(wo, dtype).T.contiguous(), _t(bo),
            None if lens is None else torch.from_numpy(lens), causal)
    return (np.asarray(ref.astype(jnp.float32)),
            attention_with_out_plain(*args).float().numpy(),
            attention_with_out(*args).float().numpy())


# (N, Sq, Sk, H, D, E, causal, with_lens). N = 7 is not a multiple of the
# reference's group of 3; Sq < Sk is the suffix-over-prefix shape the engine
# gives the kernel. The first eight are at one small width; the others are
# the ragged shapes the CUDA kernel is held to on the card by chip_smoke.py
# (edge_cases), so that the plain version it is compared with there is
# itself pinned to the Pallas kernel here: key lengths of 0 and Sk, a row
# count that no row group divides, Sk = Sq, one query row, more than one
# 16-row tile, and head widths on both sides of the tensor-core kernel's
# condition (D and E multiples of 16).
WITH_OUT_CASES = [
    pytest.param((7, Sq, Sk, 2, 8, 16, causal, with_lens),
                 id=f"{Sq}-{Sk}-{causal}-{with_lens}")
    for with_lens in (True, False) for causal in (True, False)
    for Sq, Sk in ((5, 8), (6, 6))
] + [
    pytest.param((7, 16, 24, 2, 16, 32, True, "edge"), id="lens-0-to-Sk"),
    pytest.param((6, 16, 24, 2, 16, 32, False, "edge"),
                 id="not-causal-lens-0-to-Sk"),
    pytest.param((5, 16, 16, 2, 16, 32, True, False), id="Sk-eq-Sq"),
    pytest.param((9, 1, 24, 2, 16, 32, False, "edge"), id="Sq-1"),
    pytest.param((20, 8, 12, 2, 16, 32, True, "edge"), id="Sq-8-Sk-12"),
    pytest.param((3, 40, 77, 2, 16, 32, True, "edge"), id="Sq-40-Sk-77"),
    pytest.param((5, 16, 24, 2, 24, 40, True, "edge"), id="D-24"),
]


@pytest.mark.parametrize("case", WITH_OUT_CASES)
def test_attention_with_out_matches_pallas(case):
    N, Sq, Sk, H, D, E, causal, with_lens = case
    rng = np.random.RandomState(Sq * 10 + Sk + causal)
    ref, plain, wrapped = _with_out_both(
        *_with_out_inputs(rng, N, Sq, Sk, H, D, E, with_lens), causal)
    assert ref.shape == (N, Sq, E)
    assert np.isfinite(plain).all()
    np.testing.assert_allclose(plain, ref, **WITH_OUT_TOL)
    np.testing.assert_allclose(wrapped, ref, **WITH_OUT_TOL)


def test_attention_with_out_wider_output_than_input():
    """wo maps H * D inputs to E outputs; the two need not be equal."""
    rng = np.random.RandomState(9)
    ref, plain, _ = _with_out_both(
        *_with_out_inputs(rng, 4, 3, 5, 2, 8, 24, True), True)
    assert ref.shape == (4, 3, 24)
    np.testing.assert_allclose(plain, ref, **WITH_OUT_TOL)


def test_attention_with_out_bf16():
    rng = np.random.RandomState(10)
    ref, plain, _ = _with_out_both(
        *_with_out_inputs(rng, 5, 4, 7, 2, 16, 32, True), True,
        dtype=torch.bfloat16)
    np.testing.assert_allclose(plain, ref, **BF16_TOL)


def _block_inputs(rng, N, S, H, D, with_lens):
    E = H * D
    x = rng.randn(N, S, E).astype(np.float32)
    res = rng.randn(N, S, E).astype(np.float32)
    # flax layout (E_in, E_out)
    ws = [(rng.randn(E, E) * 0.05).astype(np.float32) for _ in range(4)]
    bs = [(rng.randn(E) * 0.1).astype(np.float32) for _ in range(4)]
    lens = None
    if with_lens == "edge":
        lens = _edge_lens(rng, N, S)
    elif with_lens:
        lens = rng.randint(1, S + 1, size=N).astype(np.int32)
        lens[0] = S
    return x, res, ws, bs, lens


def _block_both(x, res, ws, bs, lens, heads, causal, dtype=torch.float32):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jparams = [a for w, b in zip(ws, bs)
               for a in (jnp.asarray(w, jdt), jnp.asarray(b))]
    ref = fused_attention_block(
        jnp.asarray(x, jdt), jnp.asarray(res, jdt), *jparams,
        None if lens is None else jnp.asarray(lens), heads=heads,
        causal=causal, group=4, interpret=True)
    tparams = [a for w, b in zip(ws, bs)
               for a in (_t(w, dtype).T.contiguous(), _t(b))]
    args = (_t(x, dtype), _t(res, dtype), *tparams,
            None if lens is None else torch.from_numpy(lens))
    kw = dict(heads=heads, causal=causal)
    return (np.asarray(ref.astype(jnp.float32)),
            attention_block_plain(*args, **kw).float().numpy(),
            attention_block(*args, **kw).float().numpy())


# (N, S, H, D, causal, with_lens). N = 5 is not a multiple of the
# reference's group of 4. The first four are at one small shape; the others
# are the ragged shapes of chip_smoke.py's edge_cases (see WITH_OUT_CASES).
BLOCK_CASES = [
    pytest.param((5, 10, 4, 16, causal, with_lens),
                 id=f"{causal}-{with_lens}")
    for with_lens in (True, False) for causal in (True, False)
] + [
    pytest.param((7, 15, 4, 16, False, "edge"), id="lens-0-to-S"),
    pytest.param((7, 15, 4, 16, True, "edge"), id="causal-lens-0-to-S"),
    pytest.param((5, 1, 2, 16, False, False), id="S-1"),
    pytest.param((5, 17, 4, 16, True, "edge"), id="S-17-causal"),
    pytest.param((5, 17, 4, 16, False, False), id="S-17"),
    pytest.param((5, 15, 4, 24, False, "edge"), id="D-24"),
]


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_attention_block_matches_pallas(case):
    N, S, H, D, causal, with_lens = case
    rng = np.random.RandomState(2 + causal + 2 * bool(with_lens))
    ref, plain, wrapped = _block_both(
        *_block_inputs(rng, N, S, H, D, with_lens), heads=H, causal=causal)
    assert np.isfinite(plain).all()
    np.testing.assert_allclose(plain, ref, **BLOCK_TOL)
    np.testing.assert_allclose(wrapped, ref, **BLOCK_TOL)


def test_attention_block_bf16():
    rng = np.random.RandomState(11)
    ref, plain, _ = _block_both(*_block_inputs(rng, 3, 6, 2, 16, True),
                                heads=2, causal=True, dtype=torch.bfloat16)
    np.testing.assert_allclose(plain, ref, **BF16_TOL)


def test_converted_linears_are_the_kernels_weights():
    """The flax tree holds q/k/v kernels as (E, H, D) and the out kernel as
    (H, D, E); ``from_jax_params`` turns them into ``Linear`` weights
    (E_out, E_in). The fused kernels read those weights as they lie: the
    reference kernels on the flax kernels flattened to (E, E) and the
    port's on the converted ``Linear``s must agree."""
    cfg = jax_configs.BertConfig.tiny()
    params = np_tree(jax.jit(JaxBert(cfg).init_params)(jax.random.PRNGKey(5)))
    rng = np.random.RandomState(12)
    attn = params["encoder"]["layer_0"]["attention"]
    for name in ("query", "key", "value", "out"):  # the init leaves zeros
        attn[name]["bias"] = (rng.randn(*attn[name]["bias"].shape) * 0.1
                              ).astype(np.float32)
    H, D = cfg.num_heads, cfg.head_dim
    E = H * D
    assert attn["out"]["kernel"].shape == (H, D, E)
    assert attn["query"]["kernel"].shape == (E, H, D)
    port = from_jax_params(BertForMaskedLM(port_bert_config(cfg)), params)
    mha = port.encoder.layers[0].attention
    names = ("query", "key", "value", "out")
    flax = [a for n in names for a in (attn[n]["kernel"].reshape(E, E),
                                       attn[n]["bias"].reshape(E))]
    lins = [a for n in names for a in (getattr(mha, n).weight.detach(),
                                       getattr(mha, n).bias.detach())]
    np.testing.assert_array_equal(mha.out.weight.detach().numpy(),
                                  attn["out"]["kernel"].reshape(E, E).T)

    N, S, P = 3, 5, 2
    x = rng.randn(N, S, E).astype(np.float32)
    res = rng.randn(N, S, E).astype(np.float32)
    lens = np.array([5, 2, 4], np.int32)
    want = fused_attention_block(
        jnp.asarray(x), jnp.asarray(res), *(jnp.asarray(a) for a in flax),
        jnp.asarray(lens), heads=H, causal=False, interpret=True)
    got = attention_block(_t(x), _t(res), *lins, torch.from_numpy(lens),
                          heads=H, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)

    q = rng.randn(N, S, H, D).astype(np.float32)
    k = rng.randn(N, P + S, H, D).astype(np.float32)
    v = rng.randn(N, P + S, H, D).astype(np.float32)
    klens = (P + lens).astype(np.int32)
    want = fused_attention_with_out(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(flax[6]),
        jnp.asarray(flax[7]), jnp.asarray(klens), causal=True,
        interpret=True)
    got = attention_with_out(_t(q), _t(k), _t(v), lins[6], lins[7],
                             torch.from_numpy(klens), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WITH_OUT_TOL)


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty(1, 2, 1, 8, device="meta")
    w, b = torch.empty(8, 8, device="meta"), torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attention_with_out(q, q, q, w, b)
    x = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attention_block(x, x, w, b, w, b, w, b, w, b, heads=1)
