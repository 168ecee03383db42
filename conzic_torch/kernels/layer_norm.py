"""LayerNorm: the CUDA kernel ``csrc/layer_norm.cu`` and its plain version.

Counterpart of the Pallas kernel in ``conzic_tpu/ops/fused_ln.py``. Every
LayerNorm of the port's three towers and of the MLM head goes through
:func:`layer_norm`: a tensor on the CPU takes :func:`layer_norm_plain`, a
tensor on a CUDA device takes the kernel, and anything the kernel does not
take raises.

Under autograd (grad mode on and an input that requires grad) the call goes
through :class:`LayerNormFunction`, the counterpart of the reference's custom
VJP (``fused_ln.py:34-72``): the same forward, and the reference's backward
in plain PyTorch (:func:`layer_norm_backward_plain`), as the reference's is
plain jnp. Serving runs under ``inference_mode`` and calls the forward alone.

The kernel picks its instance (the 16-byte vectors a lane holds) from the
row's width and its grid from the row count and the card; while the
program's spans are live each call counts under
``profiling.LAYER_NORM_CALLS`` with the plan it took.
"""

from __future__ import annotations

import ctypes

import torch

from conzic_torch.kernels import build
from conzic_torch.runtime import profiling

_DTYPES = (torch.float32, torch.bfloat16)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics: a transcription of
    the TPU kernel body (one-pass variance clamped at 0)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                              dy: torch.Tensor, eps: float):
    """The reference's LayerNorm backward (``_fused_ln_bwd``): fp32
    statistics recomputed from ``x``; returns ``dx`` in x's type and
    ``dscale``, ``dbias`` in fp32, summed over every leading axis."""
    xf = x.float()
    dyf = dy.float()
    mean = xf.mean(-1, keepdim=True)
    mean2 = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    r = torch.rsqrt(var + eps)
    xhat = (xf - mean) * r
    dyg = dyf * scale.float()
    dx = r * (dyg - dyg.mean(-1, keepdim=True)
              - xhat * (dyg * xhat).mean(-1, keepdim=True))
    lead = tuple(range(dy.dim() - 1))
    dscale = (dyf * xhat).sum(lead)
    dbias = dyf.sum(lead)
    return dx.to(x.dtype), dscale, dbias


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm with the reference's gradient: the forward of
    :func:`layer_norm` (the kernel on a CUDA tensor), the backward
    :func:`layer_norm_backward_plain` on the saved ``(x, scale)``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        return _layer_norm(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward_plain(x, scale, dy, ctx.eps)
        return dx, dscale.to(scale.dtype), dbias.to(ctx.bias_dtype), None


def _lib() -> ctypes.CDLL:
    lib = build.load("layer_norm")
    if not getattr(lib, "_conzic_typed", False):
        p = ctypes.c_void_p
        lib.conzic_layer_norm.argtypes = [
            p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, p,
        ]
        lib.conzic_layer_norm.restype = ctypes.c_int
        lib.conzic_layer_norm_max_features.argtypes = [ctypes.c_int]
        lib.conzic_layer_norm_max_features.restype = ctypes.c_int
        lib.conzic_layer_norm_plan.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.conzic_layer_norm_plan.restype = ctypes.c_int
        lib._conzic_typed = True
    return lib


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (..., F) with ``scale`` and
    ``bias`` (F,); output in ``x``'s type. Differentiable through
    :class:`LayerNormFunction` when grad mode is on and an input requires
    grad; otherwise the forward alone."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return LayerNormFunction.apply(x, scale, bias, eps)
    return _layer_norm(x, scale, bias, eps)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    F = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"layer_norm: unsupported types x={x.dtype}, "
                        f"scale={scale.dtype}")
    if bias.dtype != scale.dtype:
        raise TypeError("layer_norm: scale and bias must share a type")
    if scale.shape != (F,) or bias.shape != (F,):
        raise ValueError(f"layer_norm: scale/bias must be ({F},), got "
                         f"{tuple(scale.shape)} / {tuple(bias.shape)}")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"layer_norm: {name} is on {t.device}, "
                             f"x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"layer_norm: {name} must be contiguous")
    lib = _lib()
    elem = x.element_size()
    if F % (16 // elem) or x.data_ptr() % 16:
        raise ValueError(
            f"layer_norm: rows must be whole 16-byte vectors and x 16-byte "
            f"aligned (F={F}, {x.dtype})")
    if F > lib.conzic_layer_norm_max_features(elem):
        raise ValueError(f"layer_norm: F={F} exceeds the kernel's "
                         f"{lib.conzic_layer_norm_max_features(elem)}")
    out = torch.empty_like(x)
    rows = x.numel() // F if F else 0
    x_bf16 = int(x.dtype == torch.bfloat16)
    p_bf16 = int(scale.dtype == torch.bfloat16)
    code = lib.conzic_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, F, float(eps), x_bf16, p_bf16,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, code, "layer_norm")
    build.count_launch(layer_norm)
    if profiling.live() and rows:
        vecs, _, rows_per_warp = layer_norm_plan(rows, F, x_bf16, p_bf16)
        profiling.count(f"{profiling.LAYER_NORM_CALLS}.vecs{vecs}"
                        f".rows_per_warp{rows_per_warp}")
    return out


def layer_norm_plan(rows: int, features: int, x_bf16: int, p_bf16: int):
    """How the kernel runs ``rows`` x ``features`` on the current card:
    (16-byte vectors a lane holds, blocks of 128 threads, rows the busiest
    warp takes). Launches nothing."""
    lib = _lib()
    plan = (ctypes.c_int * 3)()
    build.check(lib, lib.conzic_layer_norm_plan(rows, features, x_bf16,
                                                p_bf16, plan),
                "layer_norm plan")
    return tuple(plan)


layer_norm.launches = 0
