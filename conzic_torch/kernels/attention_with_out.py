"""Masked attention with the output projection: the CUDA kernel
``csrc/attention_with_out.cu`` and its plain version.

Counterpart of ``fused_attention_with_out`` / ``_kernel_with_out`` in
``conzic_tpu/ops/fused_attention.py``, the kernel of
``attn_impl="pallas_out"``. One difference of layout: ``wo`` is the weight
of a PyTorch ``Linear``, (E, H * D), the transpose of the flax (H * D, E)
kernel, and is read as it lies. A tensor on the CPU takes
:func:`attention_with_out_plain`, a tensor on a CUDA device takes a kernel,
and anything the kernels do not take raises. Which kernel is the exported C
function's choice, by type and shape alone: bf16 with a head width of 16,
32 or 64, E a multiple of 16 and at most 64 query rows runs on the tensor
cores (wgmma fed by TMA), fp32 and other shapes in exact scalar fp32.

The prefix form is ``masked_attention``'s: with ``prefix_kv=(pk, pv)``,
each (B, P, H, D), the keys and values of row n are ``concat(pk[n // G],
k[n])`` and ``concat(pv[n // G], v[n])`` with N = B * G. The kernels read
each image's prefix at image width; the plain version broadcasts and
concatenates it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from conzic_torch.kernels import build
from conzic_torch.kernels.masked_attention import (
    PrefixKV,
    check_limits,
    check_on_device,
    check_prefix,
    check_qkv,
    masked_attention_plain,
)

_DTYPES = (torch.float32, torch.bfloat16)


def attention_with_out_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, wo: torch.Tensor,
                             bo: torch.Tensor,
                             lens: Optional[torch.Tensor] = None,
                             causal: bool = True,
                             prefix_kv: Optional[PrefixKV] = None
                             ) -> torch.Tensor:
    """A transcription of ``_kernel_with_out``: the masked softmax core,
    the context rounded to the value type, ``bo + ctx @ wo^T`` accumulated
    in fp32 over all H * D inputs, rounded once to q's type. The residual
    is not added. A prefix is broadcast and concatenated first."""
    N, Sq, H, D = q.shape
    ctx = masked_attention_plain(q, k, v, lens, causal,
                                 prefix_kv)  # in q's type
    y = bo.float() + ctx.reshape(N, Sq, H * D).float() @ wo.float().T
    return y.to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("attention_with_out")
    if not getattr(lib, "_conzic_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.conzic_attention_with_out.argtypes = [
            p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, i, i, p,
        ]
        lib.conzic_attention_with_out.restype = i
        lib.conzic_attention_with_out_max_keys.restype = i
        lib.conzic_attention_with_out_max_head_dim.restype = i
        lib._conzic_typed = True
    return lib


def attention_with_out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       wo: torch.Tensor, bo: torch.Tensor,
                       lens: Optional[torch.Tensor] = None,
                       causal: bool = True,
                       prefix_kv: Optional[PrefixKV] = None) -> torch.Tensor:
    """q (N, Sq, H, D); k, v (N, Ss, H, D) with Ss >= Sq; ``prefix_kv``
    None (Sk = Ss) or (pk, pv), each (B, P, H, D) with N = B * G, put before
    the keys of row n as image n // G's (Sk = P + Ss); wo (E, H * D) in q's
    type; bo (E,) fp32 or bf16; lens (N,) valid KEY lengths over the Sk
    keys or None (= Sk); ``causal`` masks col > row + (Sk - Sq). Returns the
    projected attention output (N, Sq, E) in q's type, without a
    residual."""
    if q.device.type == "cpu":
        return attention_with_out_plain(q, k, v, wo, bo, lens, causal,
                                        prefix_kv)
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
    pk = pv = None
    P = 0
    if prefix_kv is not None:
        check_prefix(what, q, k, prefix_kv)
        pk, pv = prefix_kv
        check_on_device(what, q, [("pk", pk), ("pv", pv)])
        P = pk.shape[1]
    E = wo.shape[0]
    lib = _lib()
    check_limits(what, P + Sk, D, lib.conzic_attention_with_out_max_keys(),
                 lib.conzic_attention_with_out_max_head_dim())
    out = torch.empty((N, Sq, E), dtype=q.dtype, device=q.device)
    code = lib.conzic_attention_with_out(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pk.data_ptr() if pk is not None else None,
        pv.data_ptr() if pv is not None else None,
        lens.data_ptr() if lens is not None else None, wo.data_ptr(),
        bo.data_ptr(), out.data_ptr(), N, Sq, Sk, P,
        N // pk.shape[0] if pk is not None else 1, H, D, E, int(causal),
        float(D ** -0.5), int(q.dtype == torch.bfloat16),
        int(bo.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, code, what)
    build.count_launch(attention_with_out)
    return out


attention_with_out.launches = 0
