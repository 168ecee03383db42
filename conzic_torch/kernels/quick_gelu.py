"""quick_gelu: the CUDA kernel ``csrc/quick_gelu.cu`` and its plain version.

CLIP's activation ``x * sigmoid(1.702 x)``. It replaces no Pallas kernel:
the reference leaves it to XLA, which fuses it; PyTorch would run it as
three kernels. Every quick_gelu of the port's CLIP towers goes through
:func:`quick_gelu`: a tensor on the CPU takes :func:`quick_gelu_plain`, a
tensor on a CUDA device takes the kernel, and anything the kernel does not
take raises.

Under autograd (grad mode on and an input that requires grad) the call goes
through :class:`QuickGeluFunction`: the same forward, and the formula's
gradient in plain PyTorch, as :class:`LayerNormFunction` does for LayerNorm.
"""

from __future__ import annotations

import ctypes

import torch

from conzic_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def quick_gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)`` computed in fp32 and rounded once to x's
    type: the kernel's arithmetic."""
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def quick_gelu_backward_plain(x: torch.Tensor,
                              dy: torch.Tensor) -> torch.Tensor:
    """The gradient of ``x * sigmoid(1.702 x)`` in fp32, with
    ``s = sigmoid(1.702 x)``: ``dy s + 1.702 dy x (1 - s) s``, the terms
    autograd of the formula sums; returned in x's type."""
    xf, dyf = x.float(), dy.float()
    s = torch.sigmoid(1.702 * xf)
    return (dyf * s + 1.702 * (dyf * xf * (1 - s) * s)).to(x.dtype)


class QuickGeluFunction(torch.autograd.Function):
    """quick_gelu with the formula's gradient: the forward of
    :func:`quick_gelu` (the kernel on a CUDA tensor), the backward
    :func:`quick_gelu_backward_plain` on the saved ``x``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _quick_gelu(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return quick_gelu_backward_plain(x, dy)


def _lib() -> ctypes.CDLL:
    lib = build.load("quick_gelu")
    if not getattr(lib, "_conzic_typed", False):
        p = ctypes.c_void_p
        lib.conzic_quick_gelu.argtypes = [
            p, p, ctypes.c_longlong, ctypes.c_int, p,
        ]
        lib.conzic_quick_gelu.restype = ctypes.c_int
        lib._conzic_typed = True
    return lib


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(1.702 x)`` elementwise, in x's type. Differentiable
    through :class:`QuickGeluFunction` when grad mode is on and ``x``
    requires grad; otherwise the forward alone."""
    if torch.is_grad_enabled() and x.requires_grad:
        return QuickGeluFunction.apply(x)
    return _quick_gelu(x)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return quick_gelu_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quick_gelu: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quick_gelu: unsupported type {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quick_gelu: x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("quick_gelu: x must be 16-byte aligned")
    lib = _lib()
    out = torch.empty_like(x)
    code = lib.conzic_quick_gelu(
        x.data_ptr(), out.data_ptr(), x.numel(),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, code, "quick_gelu")
    build.count_launch(quick_gelu)
    return out


quick_gelu.launches = 0
