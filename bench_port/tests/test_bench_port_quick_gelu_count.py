"""``counts/quick_gelu.py``: bytes and operations of CLIP's activation at
the cells' text-chunk shapes, worked out by hand, and targets that exist."""

import importlib

import pytest
import torch

from bench_port.counts import quick_gelu
from bench_port.metrics import quick_gelu_roofline
from bench_port.trace import Trace


@pytest.mark.parametrize("F,dtype,n_bytes", [
    (2048, torch.bfloat16, 183_500_800),  # b32: 800 rows x 28 x 2,048
    (3072, torch.bfloat16, 275_251_200),  # l14: 800 rows x 28 x 3,072
    (2048, torch.float32, 367_001_600),
])
def test_text_chunk_bytes_and_operations(F, dtype, n_bytes):
    x = torch.empty(800, 28, F, dtype=dtype)
    rec = quick_gelu.record((x,), {})
    flops, got = quick_gelu.cost(rec)
    assert got == 2 * x.numel() * x.element_size() == n_bytes
    assert flops == 5 * 800 * 28 * F
    assert rec["dtype"] == str(dtype).replace("torch.", "")


def test_targets_exist_on_this_tree():
    for target in quick_gelu.TARGETS:
        mod_name, attr = target.split(":")
        assert callable(getattr(importlib.import_module(mod_name), attr))


def test_roofline_of_one_call_and_none_without_the_kernel():
    x = torch.empty(800, 28, 2048, dtype=torch.bfloat16)
    # one call at twice its bytes bound (54.776 us at 3.35 TB/s)
    name = "void (anonymous namespace)::quick_gelu_kernel<__nv_bfloat16>"
    trace = Trace(counts={"quick_gelu": quick_gelu},
                  kernels=[(0.0, 2 * 183_500_800 / 3.35e6, name)],
                  transfers=[], window_s=1.0, busy_s=0.1, steps=1,
                  calls={"quick_gelu": [quick_gelu.record((x,), {})]},
                  model_flops=0.0, gaps=[])
    assert quick_gelu_roofline.read(trace) == pytest.approx(50.0)
    trace.kernels = [(0.0, 5.0, "vectorized_elementwise_kernel")]
    assert quick_gelu_roofline.read(trace) is None
