"""The port's kernel modules on the CPU == the Pallas kernels they replace.

``conzic_torch.kernels.layer_norm`` and ``conzic_torch.kernels.masked_attention``
take their plain PyTorch versions for CPU tensors. Both are held against the
JAX package's Pallas kernels run in interpret mode, as tests/test_fused_ln.py
and tests/test_fused_attention.py run them, at fp32 with tolerance 2e-5.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_tpu.ops.fused_attention import fused_masked_attention
from conzic_tpu.ops.fused_ln import fused_layer_norm
from conzic_torch.kernels.layer_norm import layer_norm, layer_norm_plain
from conzic_torch.kernels.masked_attention import (
    masked_attention,
    masked_attention_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rows", [1, 37, 301])
@pytest.mark.parametrize("features", [64, 512])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_matches_pallas(rows, features, eps):
    rng = np.random.RandomState(rows + features)
    x = rng.randn(rows, features).astype(np.float32) * 3 + 1
    scale = rng.rand(features).astype(np.float32) + 0.5
    bias = rng.randn(features).astype(np.float32)
    ref = np.asarray(fused_layer_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), eps=eps,
        interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(scale),
            torch.from_numpy(bias), eps)
    np.testing.assert_allclose(layer_norm_plain(*args).numpy(), ref, **TOL)
    np.testing.assert_allclose(layer_norm(*args).numpy(), ref, **TOL)


def test_layer_norm_keeps_bf16_and_leading_axes():
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 6, 32)
                         .astype(np.float32)).to(torch.bfloat16)
    out = layer_norm(x, torch.ones(32), torch.zeros(32), 1e-5)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    f = out.float().numpy()
    assert abs(f.mean()) < 0.05 and abs(f.std() - 1) < 0.1


def _qkv(rng, N, Sq, Sk, H, D):
    q = rng.randn(N, Sq, H, D).astype(np.float32)
    k = rng.randn(N, Sk, H, D).astype(np.float32)
    v = rng.randn(N, Sk, H, D).astype(np.float32)
    return q, k, v


def _both(q, k, v, lens, causal):
    ref = np.asarray(fused_masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens), causal=causal, group=4,
        interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tl = None if lens is None else torch.from_numpy(lens)
    return ref, masked_attention_plain(*t, tl, causal).numpy(), \
        masked_attention(*t, tl, causal).numpy()


# every row is compared, query rows past ``lens`` included: the kernel keeps
# them as masked_softmax_core computes them
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(12, 12), (5, 9), (1, 7)])
def test_masked_attention_matches_pallas(causal, Sq, Sk):
    rng = np.random.RandomState(Sq * 10 + Sk + causal)
    N, H, D = 7, 4, 16
    q, k, v = _qkv(rng, N, Sq, Sk, H, D)
    lens = rng.randint(Sk - Sq + 1, Sk + 1, size=N).astype(np.int32)
    lens[0] = Sk
    ref, plain, wrapped = _both(q, k, v, lens, causal)
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_allclose(wrapped, ref, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_masked_attention_without_lens(causal):
    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 4, 6, 8, 2, 8)
    ref, plain, wrapped = _both(q, k, v, None, causal)
    np.testing.assert_allclose(plain, ref, **TOL)
    np.testing.assert_allclose(wrapped, ref, **TOL)


def test_pooled_row_equals_full_causal_row():
    """The pooled final layer's call (Sq=1, causal=False, the same lens)
    gives the first-EOS row of the full causal attention exactly: the EOS
    row of a padded CLIP row is its last valid one, so its causal reach is
    col < lens."""
    rng = np.random.RandomState(4)
    N, P, S, H, D = 6, 3, 9, 2, 16
    Sk = P + S
    q, k, v = _qkv(rng, N, S, Sk, H, D)
    suffix_valid = rng.randint(1, S + 1, size=N)
    lens = (P + suffix_valid).astype(np.int32)
    full, _, _ = _both(q, k, v, lens, causal=True)
    eos = suffix_valid - 1
    q1 = np.stack([q[n, eos[n]][None] for n in range(N)])  # (N, 1, H, D)
    _, plain, wrapped = _both(q1, k, v, lens, causal=False)
    want = np.stack([full[n, eos[n]][None] for n in range(N)])
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(wrapped, want, **TOL)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        layer_norm(x, torch.ones(64), torch.zeros(64), 1e-5)
    q = torch.empty(1, 2, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        masked_attention(q, q, q)
