"""The prefix form of ``conzic_torch.kernels.masked_attention`` on the CPU.

``masked_attention(q, k, v, lens, causal, prefix_kv=(pk, pv))`` attends
the row's image prefix (B, P, H, D) followed by the row's own keys. Its
plain version is held against ``conzic_tpu``'s Pallas kernel
``fused_masked_attention`` (interpret mode, as tests/test_fused_attention.py
runs it) on the explicitly broadcast and concatenated keys, at fp32 with
tolerance 1e-5 absolute. ``MultiHeadAttention`` with ``prefix_kv`` is held
against an explicit concatenation, the pooled final layer (``x_kv``)
included. The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_tpu.ops.fused_attention import fused_masked_attention
from conzic_torch.kernels.masked_attention import (
    masked_attention,
    masked_attention_plain,
)
from conzic_torch.models.layers import MultiHeadAttention
from conzic_torch.ops.attention import AttnMask

ATOL = 1e-5
N, H, D, SS = 6, 2, 16, 5  # N = B * G rows of q; SS of each row's own keys


def _lens(rng, mode, Sq, Sk, P):
    if mode is None:
        return None
    if mode == "reach":  # every row keeps its whole causal reach
        return rng.randint(Sk - Sq + 1, Sk + 1, size=N).astype(np.int32)
    lens = rng.randint(0, Sk + 1, size=N).astype(np.int32)  # 0 .. Sk
    lens[0], lens[1], lens[-1] = 0, min(P, 1), Sk  # inside the prefix too
    return lens


# N is the same for both G, so the reference compiles once per shape
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("P", [1, 8])
@pytest.mark.parametrize("lens_mode", [None, "reach", "0..Sk"])
@pytest.mark.parametrize("Sq", [SS, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_prefix_form_matches_pallas_on_concatenated_keys(causal, Sq, lens_mode,
                                                         P, G):
    rng = np.random.RandomState(100 * P + 10 * G + Sq + causal)
    B, Sk = N // G, P + SS
    q = rng.randn(N, Sq, H, D).astype(np.float32)
    k, v = (rng.randn(N, SS, H, D).astype(np.float32) for _ in range(2))
    pk, pv = (rng.randn(B, P, H, D).astype(np.float32) for _ in range(2))
    lens = _lens(rng, lens_mode, Sq, Sk, P)
    image = np.arange(N) // G
    k_all = np.concatenate([pk[image], k], axis=1)
    v_all = np.concatenate([pv[image], v], axis=1)
    ref = np.asarray(fused_masked_attention(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
        None if lens is None else jnp.asarray(lens), causal=causal, group=4,
        interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    prefix = (torch.from_numpy(pk), torch.from_numpy(pv))
    tl = None if lens is None else torch.from_numpy(lens)
    plain = masked_attention_plain(*t, tl, causal, prefix).numpy()
    wrapped = masked_attention(*t, tl, causal, prefix_kv=prefix).numpy()
    np.testing.assert_allclose(plain, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(wrapped, plain)


def test_prefix_form_refuses_what_it_cannot_serve():
    q = torch.zeros(6, 4, 2, 8)
    k = torch.zeros(6, 4, 2, 8)
    with pytest.raises(ValueError, match="B must divide N"):
        masked_attention(q, k, k, prefix_kv=(torch.zeros(4, 3, 2, 8),) * 2)
    with pytest.raises(ValueError, match="at least Sq"):
        masked_attention(q, k[:, :3], k[:, :3],
                         prefix_kv=(torch.zeros(2, 3, 2, 8),) * 2)
    with pytest.raises(TypeError, match="prefix types"):
        masked_attention(q, k, k, prefix_kv=(
            torch.zeros(2, 3, 2, 8, dtype=torch.bfloat16),) * 2)


def _concat_reference(mha, x, mask, pk, pv, residual, x_kv=None):
    """What ``MultiHeadAttention`` computed before the prefix form: the
    prefix broadcast to the rows of its image and concatenated in front of
    each row's keys, then the masked attention over all of them."""
    Hh, Dh = mha.num_heads, mha.head_dim
    kv_src = x if x_kv is None else x_kv
    n, sq, skv = x.shape[0], x.shape[1], kv_src.shape[1]
    q = mha.query(x).view(n, sq, Hh, Dh)
    k = mha.key(kv_src).view(n, skv, Hh, Dh)
    v = mha.value(kv_src).view(n, skv, Hh, Dh)
    image = torch.arange(n) // (n // pk.shape[0])
    k = torch.cat([pk[image], k], dim=1)
    v = torch.cat([pv[image], v], dim=1)
    out = masked_attention_plain(q, k, v, mask.lens, mask.causal)
    return mha.out(out.reshape(n, sq, Hh * Dh)) + residual


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_out", "pallas_block"])
def test_multi_head_attention_prefix_equals_explicit_concatenation(attn_impl):
    torch.manual_seed(0)
    Hh, Dh, B, G, P, S = 2, 8, 2, 3, 4, 5
    n, E = B * G, Hh * Dh
    mha = MultiHeadAttention(Hh, Dh, attn_impl=attn_impl)
    for p in mha.parameters():
        torch.nn.init.normal_(p, std=0.3)
    x = torch.randn(n, S, E)
    pk, pv = torch.randn(B, P, Hh, Dh), torch.randn(B, P, Hh, Dh)
    lens = torch.tensor([P + 1, P + S, P + 2, P + S, P + 3, P + 4],
                        dtype=torch.int32)
    with torch.no_grad():
        # suffix pass: causal over the prefix and the row's own keys
        mask = AttnMask(lens=lens, causal=True)
        got = mha(x, mask, residual=x, prefix_kv=(pk, pv))
        want = _concat_reference(mha, x, mask, pk, pv, x)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        # pooled final layer: one query row per sequence, keys from x_kv
        xq = x[:, 2:3]
        pmask = AttnMask(lens=lens, causal=False)
        got = mha(xq, pmask, residual=xq, prefix_kv=(pk, pv), x_kv=x)
        want = _concat_reference(mha, xq, pmask, pk, pv, xq, x_kv=x)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        # return_kv still hands back the concatenated keys
        out, (k_all, _) = mha(x, mask, residual=x, prefix_kv=(pk, pv),
                              return_kv=True)
        assert k_all.shape == (n, P + S, Hh, Dh)
        torch.testing.assert_close(out, _concat_reference(
            mha, x, mask, pk, pv, x), rtol=0, atol=1e-6)
