"""``layer_norm`` (``conzic_torch/kernels/layer_norm.py``): x (..., F),
scale and bias (F,). Bytes: x read and y written once, scale and bias
read once. Operations: 8 a value (mean, variance, normalise, scale and
shift); the kernel is bound by its bytes. The same counts as
``chip_smoke.py``'s ``ln_case``."""

from __future__ import annotations

TARGETS = ("conzic_torch.models.layers:layer_norm",)
KERNEL_NAMES = ("layer_norm_kernel",)


def record(args, kwargs) -> dict:
    x, scale = args[0], args[1]
    return {"numel": x.numel(), "F": x.shape[-1], "elem": x.element_size(),
            "param_elem": scale.element_size(),
            "dtype": str(x.dtype).replace("torch.", "")}


def cost(rec: dict):
    n_bytes = 2 * rec["numel"] * rec["elem"] + 2 * rec["F"] * rec["param_elem"]
    return 8 * rec["numel"], n_bytes
