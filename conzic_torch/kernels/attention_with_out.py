"""Masked attention with the output projection: the CUDA kernel
``csrc/attention_with_out.cu`` and its plain version.

Counterpart of ``fused_attention_with_out`` / ``_kernel_with_out`` in
``conzic_tpu/ops/fused_attention.py``, the kernel of
``attn_impl="pallas_out"``. One difference of layout: ``wo`` is the weight
of a PyTorch ``Linear``, (E, H * D), the transpose of the flax (H * D, E)
kernel, and is read as it lies. A tensor on the CPU takes
:func:`attention_with_out_plain`, a tensor on a CUDA device takes a kernel,
and anything the kernels do not take raises. Which kernel is the exported C
function's choice, by type and shape alone: bf16 with D and E multiples of
16 runs on the tensor cores, fp32 and other widths in exact scalar fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from conzic_torch.kernels import build
from conzic_torch.kernels.masked_attention import (
    check_limits,
    check_on_device,
    check_qkv,
    masked_attention_plain,
)

_DTYPES = (torch.float32, torch.bfloat16)


def attention_with_out_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, wo: torch.Tensor,
                             bo: torch.Tensor,
                             lens: Optional[torch.Tensor] = None,
                             causal: bool = True) -> torch.Tensor:
    """A transcription of ``_kernel_with_out``: the masked softmax core,
    the context rounded to the value type, ``bo + ctx @ wo^T`` accumulated
    in fp32 over all H * D inputs, rounded once to q's type. The residual
    is not added."""
    N, Sq, H, D = q.shape
    ctx = masked_attention_plain(q, k, v, lens, causal)  # in q's type
    y = bo.float() + ctx.reshape(N, Sq, H * D).float() @ wo.float().T
    return y.to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("attention_with_out")
    if not getattr(lib, "_conzic_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.conzic_attention_with_out.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, p,
        ]
        lib.conzic_attention_with_out.restype = i
        lib.conzic_attention_with_out_max_keys.restype = i
        lib.conzic_attention_with_out_max_head_dim.restype = i
        lib._conzic_typed = True
    return lib


def attention_with_out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       wo: torch.Tensor, bo: torch.Tensor,
                       lens: Optional[torch.Tensor] = None,
                       causal: bool = True) -> torch.Tensor:
    """q (N, Sq, H, D); k, v (N, Sk, H, D) with Sk >= Sq; wo (E, H * D) in
    q's type; bo (E,) fp32 or bf16; lens (N,) valid KEY lengths or None
    (= Sk); ``causal`` masks col > row + (Sk - Sq). Returns the projected
    attention output (N, Sq, E) in q's type, without a residual."""
    if q.device.type == "cpu":
        return attention_with_out_plain(q, k, v, wo, bo, lens, causal)
    what = "attention_with_out"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    check_qkv(what, q, k, v, lens)
    N, Sq, H, D = q.shape
    Sk = k.shape[1]
    if wo.dim() != 2 or wo.shape[1] != H * D or bo.shape != (wo.shape[0],):
        raise ValueError(f"{what}: wo must be (E, {H * D}) and bo (E,), got "
                         f"{tuple(wo.shape)} and {tuple(bo.shape)}")
    if wo.dtype != q.dtype or bo.dtype not in _DTYPES:
        raise TypeError(f"{what}: types wo={wo.dtype} bo={bo.dtype} for "
                        f"q={q.dtype}")
    check_on_device(what, q, [("wo", wo), ("bo", bo)])
    E = wo.shape[0]
    lib = _lib()
    check_limits(what, Sk, D, lib.conzic_attention_with_out_max_keys(),
                 lib.conzic_attention_with_out_max_head_dim())
    out = torch.empty((N, Sq, E), dtype=q.dtype, device=q.device)
    code = lib.conzic_attention_with_out(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr() if lens is not None else None, wo.data_ptr(),
        bo.data_ptr(), out.data_ptr(), N, Sq, Sk, H, D, E, int(causal),
        float(D ** -0.5), int(q.dtype == torch.bfloat16),
        int(bo.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, code, what)
    build.count_launch(attention_with_out)
    return out


attention_with_out.launches = 0
