"""The reduction of a trace: the idle share's union of spans, the kernel
classes by name, the readers and the breakdown, on synthetic spans."""

from pathlib import Path

import pytest
import torch

from bench_port import peaks
from bench_port import trace as tracing
from bench_port.metrics import (
    elementwise_ms_per_step,
    idle_share,
    launches_per_step,
    matmul_ms_per_step,
    mfu,
)

ROOT = Path(__file__).resolve().parents[2]


def make_trace(kernels, window_s=1e-3, steps=2, calls=None, flops=0.0,
               transfers=()):
    busy, _ = tracing._union(sorted(list(kernels) + list(transfers)), 0.0,
                             window_s * 1e6)
    return tracing.Trace(
        counts=tracing.counts_modules(ROOT), kernels=list(kernels),
        transfers=list(transfers), window_s=window_s, busy_s=busy / 1e6,
        steps=steps, calls=calls or {}, model_flops=flops, gaps=[])


def test_union_counts_overlap_once_and_finds_gaps():
    spans = [(0, 10, "a"), (5, 15, "b"), (20, 30, "c"), (25, 28, "d")]
    busy, gaps = tracing._union(spans, 0, 40)
    assert busy == 25  # [0, 15] and [20, 30]
    assert gaps == [(15, 20), (30, 40)]


def test_union_clips_to_the_window():
    busy, gaps = tracing._union([(-5, 5, "a"), (8, 50, "b")], 0, 10)
    assert busy == 7 and gaps == [(5, 8)]


@pytest.mark.parametrize("name, matmul, elementwise", [
    ("nvjet_tst_128x64_64x8_1x2_h_bz_TNT", True, False),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", True,
     False),
    ("cutlass::Kernel2<cutlass_80_wmma_tensorop_s161616gemm>", True, False),
    ("void masked_attention_mma_kernel<64, 2>(...)", False, False),
    ("void layer_norm_kernel<__nv_bfloat16, float>(...)", False, False),
    ("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernel>",
     False, True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy", False,
     True),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", False,
     False),
    ("void at::native::index_elementwise_kernel<128, 4>", False, False),
])
def test_kernel_classes(name, matmul, elementwise):
    assert matmul_ms_per_step.is_matmul(name) is matmul
    assert elementwise_ms_per_step.is_elementwise(name) is elementwise


def test_readers_per_step():
    kernels = [(0, 100, "nvjet_a"), (100, 150, "elementwise_kernel"),
               (150, 200, "layer_norm_kernel"), (300, 400, "nvjet_b")]
    tr = make_trace(kernels, window_s=1e-3, steps=2, flops=989e12 * 1e-3 / 4)
    assert launches_per_step.read(tr) == 2.0
    assert matmul_ms_per_step.read(tr) == pytest.approx(0.1)  # 200 us / 2
    assert elementwise_ms_per_step.read(tr) == pytest.approx(0.025)
    assert idle_share.read(tr) == pytest.approx(70.0)  # 300 of 1000 us busy
    assert mfu.read(tr) == pytest.approx(25.0)


def test_readers_find_nothing_in_an_empty_trace():
    tr = make_trace([], steps=2)
    for reader in (launches_per_step, matmul_ms_per_step,
                   elementwise_ms_per_step, idle_share, mfu):
        assert reader.read(tr) is None


def test_roofline_share_and_no_kernel_no_share():
    from bench_port.metrics import layer_norm_roofline

    x = torch.empty(1000, 1000, dtype=torch.bfloat16)
    rec = tracing.counts_modules(ROOT)["layer_norm"].record(
        (x, torch.empty(1000), torch.empty(1000), 1e-5), {})
    least_us = (2 * 1e6 * 2 + 2 * 1000 * 4) / peaks.HBM_BYTES_PER_S * 1e6
    tr = make_trace([(0, 2 * least_us, "layer_norm_kernel<bf16>")],
                    calls={"layer_norm": [rec]})
    assert layer_norm_roofline.read(tr) == pytest.approx(50.0)
    assert layer_norm_roofline.read(make_trace([(0, 5, "nvjet")])) is None


def test_gap_labels_name_the_innermost_host_operation():
    host = [(0, 1000, "bench_port.request"), (100, 400, "aten::linear"),
            (150, 350, "aten::addmm"), (600, 700, "aten::copy_")]
    gaps = [(200, 300), (500, 560), (620, 640), (900, 905)]
    by = dict(tracing._label_gaps(gaps, host))
    assert by["aten::addmm"] == pytest.approx(100e-6)
    assert by["bench_port.request"] == pytest.approx(60e-6)
    assert by["aten::copy_"] == pytest.approx(20e-6)
    assert by[f"gaps under {tracing.SHORT_GAP_US:g} us"] == pytest.approx(
        5e-6)


def test_top_device_ops_sum_by_name():
    tr = make_trace([(0, 10, "a"), (10, 40, "b"), (50, 60, "a")],
                    transfers=[(60, 61, "Memcpy HtoD")])
    assert tracing.top_device_ops(tr) == [["b", 30e-6], ["a", 20e-6],
                                          ["Memcpy HtoD", 1e-6]]
