"""The port's kernel modules on the CPU == the Pallas kernels they replace.

``conzic_torch.kernels.layer_norm`` and ``conzic_torch.kernels.masked_attention``
take their plain PyTorch versions for CPU tensors. Both are held against the
JAX package's Pallas kernels run in interpret mode, as tests/test_fused_ln.py
and tests/test_fused_attention.py run them, at fp32 with tolerance 2e-5;
``conzic_torch.kernels.quick_gelu`` against the reference's activation,
which has no Pallas kernel; with it the plain version's arithmetic, its
autograd Function's gradient and the towers' route to ``layers.quick_gelu``.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_tpu.models.layers import quick_gelu as jax_quick_gelu
from conzic_tpu.ops.fused_attention import fused_masked_attention
from conzic_tpu.ops.fused_ln import fused_layer_norm
from conzic_torch.kernels.layer_norm import layer_norm, layer_norm_plain
from conzic_torch.kernels.masked_attention import (
    masked_attention,
    masked_attention_plain,
)
from conzic_torch.kernels import build
from conzic_torch.kernels.quick_gelu import (
    QuickGeluFunction,
    quick_gelu,
    quick_gelu_plain,
)
from conzic_torch.models import layers
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPTextTower, CLIPVisionTower
from conzic_torch.models.configs import (
    BertConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from conzic_torch.models.init import init_params

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


@pytest.mark.parametrize("shape", [(5,), (37, 64), (4, 28, 128)])
def test_quick_gelu_matches_the_reference_activation(shape):
    # the reference's activation has no Pallas kernel: XLA fuses it
    x = (np.random.RandomState(5).randn(*shape) * 4).astype(np.float32)
    ref = np.asarray(jax_quick_gelu(jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_allclose(quick_gelu_plain(t).numpy(), ref, **TOL)
    np.testing.assert_allclose(quick_gelu(t).numpy(), ref, **TOL)


def _draw(shape, seed=0, scale=4.0):
    # wide enough to reach both tails of the sigmoid
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale)


@pytest.mark.parametrize("shape", [(1,), (7, 33), (2, 28, 128)])
def test_plain_equals_the_library_expression_in_fp32(shape):
    x = _draw(shape)
    assert torch.equal(quick_gelu_plain(x), x * torch.sigmoid(1.702 * x))
    assert torch.equal(quick_gelu(x), quick_gelu_plain(x))


def test_plain_in_bf16_is_the_fp32_result_rounded_once():
    x = _draw((64, 96), seed=1).to(torch.bfloat16)
    xf = x.float()
    want = (xf * torch.sigmoid(1.702 * xf)).to(torch.bfloat16)
    got = quick_gelu_plain(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # the library's three bf16 kernels round three times: they differ
    assert not torch.equal(x * torch.sigmoid(1.702 * x), want)


@pytest.mark.parametrize("shape", [(5, 40), (2, 28, 128)])
def test_function_gradient_equals_autograd_of_the_formula(shape):
    x = _draw(shape, seed=2)
    dy = _draw(shape, seed=3, scale=1.0)
    a = x.clone().requires_grad_()
    (a * torch.sigmoid(1.702 * a)).backward(dy)
    b = x.clone().requires_grad_()
    y = QuickGeluFunction.apply(b)
    y.backward(dy)
    assert torch.equal(y.detach(), quick_gelu_plain(x))
    # fp32: the two sum the same terms, in another order
    torch.testing.assert_close(b.grad, a.grad, rtol=1e-6, atol=1e-6)


def test_wrapper_takes_the_function_only_under_grad():
    x = _draw((3, 8)).requires_grad_()
    assert type(quick_gelu(x).grad_fn).__name__ == "QuickGeluFunctionBackward"
    with torch.no_grad():
        assert quick_gelu(x).grad_fn is None
    with torch.inference_mode():
        assert quick_gelu(x).grad_fn is None
    assert quick_gelu(x.detach()).grad_fn is None


def _tower_call(kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "text":
        cfg = CLIPTextConfig.tiny()
        tower = init_params(CLIPTextTower(cfg), gen)
        ids = torch.randint(0, cfg.vocab_size - 1, (2, 6), generator=gen)
        return cfg.num_layers, lambda: tower(ids)
    if kind == "vision":
        cfg = CLIPVisionConfig.tiny()
        tower = init_params(CLIPVisionTower(cfg), gen)
        px = torch.randn(2, cfg.image_size, cfg.image_size, 3, generator=gen)
        return cfg.num_layers, lambda: tower(px)
    cfg = BertConfig.tiny()
    bert = init_params(BertForMaskedLM(cfg), gen)
    ids = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    return 0, lambda: bert(ids)


@pytest.mark.parametrize("kind", ["text", "vision", "bert"])
def test_towers_reach_the_module_quick_gelu_at_call_time(kind, monkeypatch):
    # the towers are built before the module's function is replaced, as
    # the benchmark's recording replaces it around a traced request
    layers_per_call, call = _tower_call(kind)
    seen = []

    def counting(x):
        seen.append(tuple(x.shape))
        return quick_gelu(x)

    monkeypatch.setattr(layers, "quick_gelu", counting)
    with torch.inference_mode():
        call()
    assert len(seen) == layers_per_call


def test_quick_gelu_is_built_with_the_kernels():
    assert "quick_gelu" in build.SOURCES
    assert (build.CSRC / "quick_gelu.cu").is_file()


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
    with pytest.raises(ValueError, match="no kernel"):
        quick_gelu(x)
