"""The prefix form of ``conzic_torch.kernels.attention_with_out`` on the CPU.

``attention_with_out(q, k, v, wo, bo, lens, causal, prefix_kv=(pk, pv))``
attends the row's image prefix (B, P, H, D) followed by the row's own keys,
then projects with ``wo``. Its plain version is held against
``conzic_tpu``'s Pallas kernel ``fused_attention_with_out`` (interpret
mode, as tests/test_torch_fused_kernels.py runs it) on the explicitly
broadcast and concatenated keys, with that file's tolerances: 1e-4
relative and absolute in fp32, two bf16 ulps (2^-6) of max(|ref|, 1) in
bf16. The plain prefix form equals the plain concatenated form bit for bit.
``MultiHeadAttention`` under ``attn_impl="pallas_out"`` hands the prefix to
the kernel's wrapper and concatenates nothing, except under ``return_kv``.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_tpu.ops.fused_attention import fused_attention_with_out
from conzic_torch.kernels.attention_with_out import (
    attention_with_out,
    attention_with_out_plain,
)
from conzic_torch.kernels.masked_attention import with_prefix
from conzic_torch.models import layers
from conzic_torch.models.layers import MultiHeadAttention
from conzic_torch.ops.attention import AttnMask

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)
# N = B * G rows of q, Sq query rows, P prefix and SS own keys a row
N, SQ, P, SS, H, D, E = 6, 4, 3, 5, 2, 16, 24


def _inputs(seed, G, with_lens):
    rng = np.random.RandomState(seed)
    B, Sk = N // G, P + SS
    q = rng.randn(N, SQ, H, D).astype(np.float32)
    k, v = (rng.randn(N, SS, H, D).astype(np.float32) for _ in range(2))
    pk, pv = (rng.randn(B, P, H, D).astype(np.float32) for _ in range(2))
    wo = (rng.randn(H * D, E) * 0.1).astype(np.float32)  # the flax layout
    bo = rng.randn(E).astype(np.float32)
    lens = None
    if with_lens:  # 0 (no key kept) .. Sk, inside the prefix too
        lens = rng.randint(0, Sk + 1, size=N).astype(np.int32)
        lens[0], lens[1], lens[-1] = 0, 1, Sk
    return q, k, v, pk, pv, wo, bo, lens


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# N is the same for both G, so the reference compiles once per dtype,
# causal flag and lens
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("with_lens", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_prefix_form_matches_pallas_on_concatenated_keys(dtype, causal,
                                                         with_lens, G):
    q, k, v, pk, pv, wo, bo, lens = _inputs(10 * G + 2 * causal + with_lens,
                                            G, with_lens)
    image = np.arange(N) // G
    k_all = np.concatenate([pk[image], k], axis=1)
    v_all = np.concatenate([pv[image], v], axis=1)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = fused_attention_with_out(
        *(jnp.asarray(a, jdt) for a in (q, k_all, v_all, wo)),
        jnp.asarray(bo), None if lens is None else jnp.asarray(lens),
        causal=causal, group=3, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    args = (_t(q, dtype), _t(k, dtype), _t(v, dtype),
            _t(wo, dtype).T.contiguous(), _t(bo, torch.float32),
            None if lens is None else torch.from_numpy(lens), causal)
    prefix = (_t(pk, dtype), _t(pv, dtype))
    plain = attention_with_out_plain(*args, prefix).float().numpy()
    wrapped = attention_with_out(*args, prefix_kv=prefix).float().numpy()
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    np.testing.assert_allclose(plain, ref, **tol)
    np.testing.assert_array_equal(wrapped, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_plain_prefix_form_equals_concatenated_form(dtype):
    q, k, v, pk, pv, wo, bo, lens = _inputs(7, 3, True)
    q, k, v, pk, pv = (_t(a, dtype) for a in (q, k, v, pk, pv))
    wo = _t(wo, dtype).T.contiguous()
    bo, lens = _t(bo, dtype), torch.from_numpy(lens)
    k_all, v_all = with_prefix(k, v, (pk, pv))
    for causal in (True, False):
        got = attention_with_out_plain(q, k, v, wo, bo, lens, causal,
                                       (pk, pv))
        want = attention_with_out_plain(q, k_all, v_all, wo, bo, lens,
                                        causal)
        assert got.dtype == dtype
        assert torch.equal(got, want)


def test_attention_with_out_prefix_refuses_what_it_cannot_serve():
    q = torch.zeros(6, 4, 2, 8)
    k = torch.zeros(6, 4, 2, 8)
    w, b = torch.zeros(16, 16), torch.zeros(16)
    with pytest.raises(ValueError, match="B must divide N"):
        attention_with_out(q, k, k, w, b,
                           prefix_kv=(torch.zeros(4, 3, 2, 8),) * 2)
    with pytest.raises(ValueError, match="at least Sq"):
        attention_with_out(q, k[:, :3], k[:, :3], w, b,
                           prefix_kv=(torch.zeros(2, 3, 2, 8),) * 2)


def _layer(attn_impl):
    torch.manual_seed(0)
    mha = MultiHeadAttention(H, D, attn_impl=attn_impl)
    for p in mha.parameters():
        torch.nn.init.normal_(p, std=0.3)
    return mha


def test_pallas_out_hands_the_prefix_to_the_kernel(monkeypatch):
    """The suffix pass under ``pallas_out``: the wrapper gets the (B, P, H,
    D) prefix and the rows' own keys, the layer's own concatenation is
    never called, and the output equals the masked-attention route's."""
    B = N // 3
    mha = _layer("pallas_out")
    x = torch.randn(N, SS, H * D)
    pk, pv = torch.randn(B, P, H, D), torch.randn(B, P, H, D)
    lens = torch.tensor([P + 1, P + SS, P + 2, P + SS, P + 3, P + 4],
                        dtype=torch.int32)
    mask = AttnMask(lens=lens, causal=True)
    concatenations, calls = [], []

    def no_concatenation(*args, **kw):
        concatenations.append(args)
        return with_prefix(*args, **kw)

    def recording(q, k, v, wo, bo, lens, causal, prefix_kv=None):
        calls.append((k.shape, prefix_kv))
        return attention_with_out(q, k, v, wo, bo, lens, causal, prefix_kv)

    monkeypatch.setattr(layers, "with_prefix", no_concatenation)
    monkeypatch.setattr(layers, "attention_with_out", recording)
    with torch.no_grad():
        got = mha(x, mask, residual=x, prefix_kv=(pk, pv))
        mha.attn_impl = "pallas"
        want = mha(x, mask, residual=x, prefix_kv=(pk, pv))
    assert concatenations == []
    assert len(calls) == 1
    k_shape, prefix = calls[0]
    assert k_shape == (N, SS, H, D)
    assert prefix is not None and prefix[0].shape == (B, P, H, D)
    assert torch.equal(prefix[0], pk) and torch.equal(prefix[1], pv)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)

    # return_kv: the layer still concatenates, and hands the keys back
    mha.attn_impl = "pallas_out"
    with torch.no_grad():
        out, (k_all, _) = mha(x, mask, residual=x, prefix_kv=(pk, pv),
                              return_kv=True)
    assert len(concatenations) == 1
    assert k_all.shape == (N, P + SS, H, D)
    assert len(calls) == 1  # return_kv does not take the fused kernel
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
