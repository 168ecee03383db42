"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit). Every share of a peak and
every roofline share is taken against these; the run prints the card's
power limit beside them."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12  # tensor cores, bf16 and fp16
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores


def flops_per_s(dtype: str) -> float:
    """The peak rate of a kernel computing in ``dtype`` ("bfloat16",
    "float16" or "float32")."""
    if dtype in ("bfloat16", "float16"):
        return BF16_FLOPS_PER_S
    if dtype == "float32":
        return FP32_FLOPS_PER_S
    raise ValueError(f"no peak rate for {dtype!r}")
