"""Masked multi-head attention: the CUDA kernel ``csrc/masked_attention.cu``
and its plain version.

Counterpart of ``fused_masked_attention`` / ``masked_softmax_core`` in
``conzic_tpu/ops/fused_attention.py``. Every attention of the port's three
towers goes through :func:`masked_attention`: a tensor on the CPU takes
:func:`masked_attention_plain`, a tensor on a CUDA device takes the kernel,
and anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from conzic_torch.kernels import build
from conzic_torch.ops.attention import NEG_INF, attention_keep_mask

_DTYPES = (torch.float32, torch.bfloat16)


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lens: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """A transcription of ``masked_softmax_core``: fp32 logits scaled by
    D^-0.5, masked logits replaced by -1e9, fp32 softmax, weights rounded
    to the value type, fp32 weighted sum, output in q's type."""
    N, Sq, H, D = q.shape
    Sk = k.shape[1]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    logits = (qf @ kf.transpose(-1, -2)) * D ** -0.5  # (N, H, Sq, Sk)
    keep = attention_keep_mask(lens, N, Sq, Sk, causal, q.device)
    logits = torch.where(keep, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    w = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    out = w.float() @ vf
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def _lib() -> ctypes.CDLL:
    lib = build.load("masked_attention")
    if not getattr(lib, "_conzic_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.conzic_masked_attention.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p,
        ]
        lib.conzic_masked_attention.restype = i
        lib.conzic_masked_attention_max_keys.restype = i
        lib.conzic_masked_attention_max_head_dim.restype = i
        lib._conzic_typed = True
    return lib


def check_on_device(what: str, first: torch.Tensor, tensors) -> None:
    """Raise unless every (name, tensor) lies on the device of ``first``
    and is contiguous."""
    for name, t in tensors:
        if t.device != first.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_lens(what: str, lens: Optional[torch.Tensor], N: int) -> None:
    if lens is not None and (lens.dtype != torch.int32
                             or lens.shape != (N,)):
        raise ValueError(f"{what}: lens must be int32 ({N},), got "
                         f"{lens.dtype} {tuple(lens.shape)}")


def check_qkv(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              lens: Optional[torch.Tensor]) -> None:
    """Raise on anything in q (N, Sq, H, D), k, v (N, Sk, H, D), lens (N,)
    that the attention kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be 4-D (N, S, H, D)")
    N, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (N, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"{what}: shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if Sk < Sq:
        raise ValueError(f"{what}: Sk={Sk} < Sq={Sq}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: types q={q.dtype} k={k.dtype} "
                        f"v={v.dtype}; one of {_DTYPES} expected")
    check_lens(what, lens, N)
    tensors = [("q", q), ("k", k), ("v", v)]
    if lens is not None:
        tensors.append(("lens", lens))
    check_on_device(what, q, tensors)


def check_limits(what: str, Sk: int, D: int, max_keys: int,
                 max_head_dim: int) -> None:
    if Sk > max_keys:
        raise ValueError(f"{what}: Sk={Sk} exceeds the kernel's {max_keys} "
                         f"keys")
    if D > max_head_dim:
        raise ValueError(f"{what}: D={D} exceeds the kernel's "
                         f"{max_head_dim}")


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: Optional[torch.Tensor] = None,
                     causal: bool = False) -> torch.Tensor:
    """q (N, Sq, H, D); k, v (N, Sk, H, D) with Sk >= Sq; lens (N,) valid
    KEY lengths or None (= Sk); ``causal`` masks col > row + (Sk - Sq).
    Returns (N, Sq, H, D) in q's type."""
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, lens, causal)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: no kernel for device {q.device}")
    check_qkv("masked_attention", q, k, v, lens)
    N, Sq, H, D = q.shape
    Sk = k.shape[1]
    lib = _lib()
    check_limits("masked_attention", Sk, D,
                 lib.conzic_masked_attention_max_keys(),
                 lib.conzic_masked_attention_max_head_dim())
    out = torch.empty_like(q)
    code = lib.conzic_masked_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        lens.data_ptr() if lens is not None else None, out.data_ptr(),
        N, Sq, Sk, H, D, int(causal), float(D ** -0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, code, "masked_attention")
    masked_attention.launches += 1
    return out


masked_attention.launches = 0
