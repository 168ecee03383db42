"""The LayerNorm kernel (``conzic_torch/csrc/layer_norm.cu``) on the card
against its plain version, ``layer_norm_plain``.

Every test here needs a CUDA card (marker ``cuda``) and skips elsewhere
with its reason: the kernel has no CPU form. On the card's machine, which
has no JAX, run them without ``tests/conftest.py`` (it sets up JAX; this
file imports neither JAX nor the JAX package):

    python3 -m pytest --noconftest -m cuda tests/test_torch_layer_norm_cuda.py

Widths: the towers' (512 CLIP B/32 text; 768 BERT, RoBERTa, B/32 vision and
L/14 text; 1,024 L/14 vision; 1,152 SigLIP so400m), a tiny one and the
widest the kernel takes in bf16 (2,048; fp32 up to 1,024). Rows: one, a
ragged count, the pooled 800 and a cell's chunk of 51,200. bf16 outputs
are held within one bf16 ulp of max(|plain|, 1), fp32 within 1e-4
absolute, the bounds of ``chip_smoke.py`` phase 2: the kernel sums in
another order than the plain version and rounds once where it does.
"""

import pytest
import torch

from conzic_torch.kernels.layer_norm import (
    _lib,
    layer_norm,
    layer_norm_plain,
    layer_norm_plan,
)
from conzic_torch.runtime import profiling

pytestmark = pytest.mark.cuda

BF16, FP32 = torch.bfloat16, torch.float32
BF16_ULP = 2.0 ** -7
FP32_ATOL = 1e-4
WIDTHS = (64, 512, 768, 1024, 1152, 2048)
ROWS = (1, 37, 800, 51200)
PAIRS = ((BF16, BF16), (BF16, FP32), (FP32, BF16), (FP32, FP32))
CASES = [pytest.param(rows, feat, xt, pt,
                      id=f"{rows}x{feat}-x_{str(xt)[6:]}-p_{str(pt)[6:]}")
         for xt, pt in PAIRS for feat in WIDTHS for rows in ROWS
         if xt == BF16 or feat <= 1024]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the LayerNorm kernel has no CPU form")
    return torch.device("cuda")


def draw(card, rows, feat, x_dtype, p_dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = (torch.randn(rows, feat, device=card, generator=gen) * 3 + 1)
    scale = torch.rand(feat, device=card, generator=gen) + 0.5
    bias = torch.randn(feat, device=card, generator=gen)
    return x.to(x_dtype), scale.to(p_dtype), bias.to(p_dtype)


def assert_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if got.dtype == BF16:
        ulps = diff / (BF16_ULP * want.float().abs().clamp(min=1.0))
        assert float(ulps.max()) <= 1.0, float(ulps.max())
    else:
        assert float(diff.max()) <= FP32_ATOL, float(diff.max())


@pytest.mark.parametrize("rows,feat,x_dtype,p_dtype", CASES)
def test_kernel_matches_the_plain_version(card, rows, feat, x_dtype,
                                          p_dtype):
    x, scale, bias = draw(card, rows, feat, x_dtype, p_dtype, rows + feat)
    eps = 1e-6 if feat == 1152 else 1e-5
    assert_close(layer_norm(x, scale, bias, eps),
                 layer_norm_plain(x, scale, bias, eps))


@pytest.mark.parametrize("x_dtype,p_dtype", PAIRS)
def test_parameters_off_the_vector_alignment(card, x_dtype, p_dtype):
    """Scale and bias one element past an aligned address take the
    kernel's element loads, with the same result."""
    x, scale, bias = draw(card, 300, 768, x_dtype, p_dtype)
    s_off = torch.empty(769, device=card, dtype=p_dtype)[1:]
    b_off = torch.empty(769, device=card, dtype=p_dtype)[1:]
    s_off.copy_(scale)
    b_off.copy_(bias)
    assert s_off.data_ptr() % 8 and b_off.data_ptr() % 8
    got = layer_norm(x, s_off, b_off, 1e-5)
    assert torch.equal(got, layer_norm(x, scale, bias, 1e-5))
    assert_close(got, layer_norm_plain(x, scale, bias, 1e-5))


@pytest.mark.parametrize("feat", (768, 1152))
def test_a_row_reads_the_same_in_any_grid(card, feat):
    """A row of a 51,200-row call (warps that walk many rows) equals the
    same row normalised alone, bit for bit."""
    x, scale, bias = draw(card, 51200, feat, BF16, FP32)
    full = layer_norm(x, scale, bias, 1e-6)
    for r in (0, 4099, 51199):
        alone = layer_norm(x[r:r + 1].contiguous(), scale, bias, 1e-6)
        assert torch.equal(full[r:r + 1], alone)


def test_leading_axes_and_empty_rows(card):
    x, scale, bias = draw(card, 8 * 257, 1024, BF16, FP32)
    x3 = x.view(8, 257, 1024)
    assert torch.equal(layer_norm(x3, scale, bias, 1e-5),
                       layer_norm(x, scale, bias, 1e-5).view(8, 257, 1024))
    empty = layer_norm(x[:0], scale, bias, 1e-5)
    assert empty.shape == (0, 1024)


def test_the_wrapper_refuses_a_row_wider_than_the_kernel(card):
    for dtype in (BF16, FP32):
        widest = _lib().conzic_layer_norm_max_features(
            torch.empty((), dtype=dtype).element_size())
        assert widest == (2048 if dtype == BF16 else 1024)
        x, scale, bias = draw(card, 4, widest + 8, dtype, FP32)
        with pytest.raises(ValueError, match="exceeds"):
            layer_norm(x, scale, bias, 1e-5)
        layer_norm(x[:, :widest].contiguous(), scale[:widest],
                   bias[:widest], 1e-5)


def test_the_plan_follows_width_and_rows(card):
    """The instance from the width alone (16-byte vectors a lane, rounded
    up to 1 to 6 or 8), the grid from the rows: one row a warp while the
    card holds every warp, then one resident wave, its warps' rows within
    one of each other."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for feat, x_bf16, vecs in ((64, 1, 1), (512, 1, 2), (768, 1, 3),
                               (1024, 1, 4), (1152, 1, 5), (2048, 1, 8),
                               (768, 0, 6), (1024, 0, 8)):
        for p_bf16 in (0, 1):
            assert layer_norm_plan(800, feat, x_bf16, p_bf16) == (vecs, 200,
                                                                  1)
            got_vecs, blocks, per_warp = layer_norm_plan(51200, feat, x_bf16,
                                                         p_bf16)
            assert got_vecs == vecs and blocks % sms == 0
            assert per_warp == -(-51200 // (blocks * 4))


def test_the_counter_records_each_call_with_its_plan(card):
    from torch.profiler import ProfilerActivity, profile

    x, scale, bias = draw(card, 51200, 1152, BF16, FP32)
    vecs, _, per_warp = layer_norm_plan(51200, 1152, 1, 0)
    profiling.take_counts()
    layer_norm(x, scale, bias, 1e-6)
    assert profiling.take_counts() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.request_span("engine.generate"):
            for _ in range(3):
                layer_norm(x, scale, bias, 1e-6)
            layer_norm(x[:800], scale, bias, 1e-6)
    assert profiling.take_counts() == {
        f"{profiling.LAYER_NORM_CALLS}.vecs5.rows_per_warp{per_warp}": 3,
        f"{profiling.LAYER_NORM_CALLS}.vecs5.rows_per_warp1": 1,
    }
    assert vecs == 5
