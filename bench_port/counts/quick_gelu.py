"""``quick_gelu`` (``conzic_torch/kernels/quick_gelu.py``): CLIP's
activation ``x * sigmoid(1.702 x)`` over x of any shape. Bytes: x read and
y written once. Operations: 5 a value (the scale, the exponential, the
add, the division and the product); the kernel is bound by its bytes."""

from __future__ import annotations

TARGETS = ("conzic_torch.models.layers:quick_gelu",)
KERNEL_NAMES = ("quick_gelu_kernel",)


def record(args, kwargs) -> dict:
    x = args[0]
    return {"numel": x.numel(), "elem": x.element_size(),
            "dtype": str(x.dtype).replace("torch.", "")}


def cost(rec: dict):
    return 5 * rec["numel"], 2 * rec["numel"] * rec["elem"]
