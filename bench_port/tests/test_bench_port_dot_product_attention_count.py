"""``counts/dot_product_attention.py``: bytes and operations of the library
route's attention kernel at so400m's and l14's text-chunk shapes, worked
out by hand, targets that exist, its device time counted as elementwise
work, and its roofline reader."""

import importlib

import pytest
import torch

from bench_port.counts import dot_product_attention as dpa_count
from bench_port.metrics import dot_product_attention_roofline
from bench_port.metrics.elementwise_ms_per_step import is_elementwise
from bench_port.trace import Trace
from conzic_torch.kernels.dot_product_attention import (
    fused_dot_product_attention,
)


def test_the_benchmark_counts_the_siglip_text_call():
    q = torch.empty(800, 64, 16, 72, dtype=torch.bfloat16)
    rec = dpa_count.record((q, q, q, None, False), {})
    flops, nbytes = dpa_count.cost(rec)
    assert nbytes == 4 * 800 * 64 * 16 * 72 * 2 == 471_859_200
    assert flops == 4 * 800 * 16 * 64 * 64 * 72
    lens = torch.ones(800, dtype=torch.int32)
    kv = torch.empty(800, 32, 12, 64, dtype=torch.bfloat16)
    q = torch.empty(800, 24, 12, 64, dtype=torch.bfloat16)
    rec = dpa_count.record((q, kv, kv), {"lens": lens, "causal": True})
    assert dpa_count.cost(rec)[1] == 2 * 800 * (24 + 32) * 12 * 64 * 2 + 3200
    for target in dpa_count.TARGETS:
        mod_name, attr = target.split(":")
        assert getattr(importlib.import_module(mod_name), attr) is (
            fused_dot_product_attention)
    # one call at twice its bytes bound; none without the kernel
    name = ("void (anonymous namespace)::dot_product_attention_kernel<4>"
            "(__nv_bfloat16 const*, __nv_bfloat16 const*)")
    # its device time is counted as elementwise work, not as a product
    assert is_elementwise(name)
    q = torch.empty(800, 64, 16, 72, dtype=torch.bfloat16)
    trace = Trace(counts={"dot_product_attention": dpa_count},
                  kernels=[(0.0, 2 * 471_859_200 / 3.35e6, name)],
                  transfers=[], window_s=1.0, busy_s=0.1, steps=1,
                  calls={"dot_product_attention": [
                      dpa_count.record((q, q, q), {})]},
                  model_flops=0.0, gaps=[])
    assert dot_product_attention_roofline.read(trace) == pytest.approx(50.0)
    trace.kernels = [(0.0, 5.0, "elementwise_kernel")]
    assert dot_product_attention_roofline.read(trace) is None
