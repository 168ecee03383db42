"""A whole attention block in one call: the CUDA kernels of
``csrc/attention_block.cu`` and their plain version.

Counterpart of ``fused_attention_block`` in
``conzic_tpu/ops/fused_attn_block.py``, the kernel of
``attn_impl="pallas_block"``: ``residual + OutProj(Attn(x))`` with the
q/k/v projections inside. One difference of layout: the four weights are
those of PyTorch ``Linear``s, (E_out, E_in), the transpose of the flax
kernels, and are read as they lie. A tensor on the CPU takes
:func:`attention_block_plain`, a tensor on a CUDA device takes a kernel,
and anything the kernels do not take raises. Which kernel is the exported C
function's choice, by type and shape alone: bf16 with the head width and E
multiples of 16 runs on the tensor cores (two launches behind one call, one
count of ``launches``), fp32 and other widths in exact scalar fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from conzic_torch.kernels import build
from conzic_torch.kernels.masked_attention import (
    check_lens,
    check_limits,
    check_on_device,
    masked_attention_plain,
)

_DTYPES = (torch.float32, torch.bfloat16)


def attention_block_plain(x: torch.Tensor, residual: torch.Tensor,
                          wq: torch.Tensor, bq: torch.Tensor,
                          wk: torch.Tensor, bk: torch.Tensor,
                          wv: torch.Tensor, bv: torch.Tensor,
                          wo: torch.Tensor, bo: torch.Tensor,
                          lens: Optional[torch.Tensor] = None, *,
                          heads: int, causal: bool = False) -> torch.Tensor:
    """A transcription of the TPU kernel body with its rounding points:
    q, k, v = round(x @ W^T + b) from an fp32 product and bias add; the
    masked softmax core; the context rounded to x's type;
    ``round(ctx @ wo^T + bo) + residual`` with the last add in x's type."""
    N, S, E = x.shape
    xf = x.float()

    def proj(w, b):
        y = xf @ w.float().T + b.float()
        return y.to(x.dtype).view(N, S, heads, E // heads)

    ctx = masked_attention_plain(proj(wq, bq), proj(wk, bk), proj(wv, bv),
                                 lens, causal)  # in x's type
    out = ctx.reshape(N, S, E).float() @ wo.float().T + bo.float()
    return out.to(x.dtype) + residual


def _lib() -> ctypes.CDLL:
    lib = build.load("attention_block")
    if not getattr(lib, "_conzic_typed", False):
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.conzic_attention_block.argtypes = (
            [p] * 13 + [i] * 5 + [ctypes.c_float, i, i, p])
        lib.conzic_attention_block.restype = i
        lib.conzic_attention_block_max_keys.restype = i
        lib.conzic_attention_block_max_head_dim.restype = i
        lib._conzic_typed = True
    return lib


def attention_block(x: torch.Tensor, residual: torch.Tensor,
                    wq: torch.Tensor, bq: torch.Tensor,
                    wk: torch.Tensor, bk: torch.Tensor,
                    wv: torch.Tensor, bv: torch.Tensor,
                    wo: torch.Tensor, bo: torch.Tensor,
                    lens: Optional[torch.Tensor] = None, *,
                    heads: int, causal: bool = False) -> torch.Tensor:
    """x, residual (N, S, E); wq, wk, wv, wo (E, E) in x's type, as a
    ``Linear`` holds them; bq, bk, bv, bo (E,), all fp32 or all bf16; lens
    (N,) valid key lengths or None (= S). Returns (N, S, E) in x's type."""
    if x.device.type == "cpu":
        return attention_block_plain(x, residual, wq, bq, wk, bk, wv, bv, wo,
                                     bo, lens, heads=heads, causal=causal)
    what = "attention_block"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dim() != 3 or residual.shape != x.shape:
        raise ValueError(f"{what}: x and residual must both be (N, S, E), "
                         f"got {tuple(x.shape)} and {tuple(residual.shape)}")
    N, S, E = x.shape
    if heads <= 0 or E % heads:
        raise ValueError(f"{what}: E={E} is not a multiple of heads={heads}")
    weights = [("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)]
    biases = [("bq", bq), ("bk", bk), ("bv", bv), ("bo", bo)]
    if any(w.shape != (E, E) for _, w in weights) or any(
            b.shape != (E,) for _, b in biases):
        raise ValueError(f"{what}: weights must be ({E}, {E}) and biases "
                         f"({E},)")
    if x.dtype not in _DTYPES or any(
            t.dtype != x.dtype for _, t in [("residual", residual)] + weights):
        raise TypeError(f"{what}: x, residual and the weights must share "
                        f"one of {_DTYPES}")
    if bq.dtype not in _DTYPES or any(b.dtype != bq.dtype for _, b in biases):
        raise TypeError(f"{what}: the biases must share one of {_DTYPES}")
    check_lens(what, lens, N)
    tensors = [("x", x), ("residual", residual)] + weights + biases
    if lens is not None:
        tensors.append(("lens", lens))
    check_on_device(what, x, tensors)
    lib = _lib()
    check_limits(what, S, E // heads, lib.conzic_attention_block_max_keys(),
                 lib.conzic_attention_block_max_head_dim())
    out = torch.empty_like(x)
    ctx = torch.empty_like(x)  # the kernels' scratch: the context, (N, S, E)
    D = E // heads
    code = lib.conzic_attention_block(
        x.data_ptr(), residual.data_ptr(), wq.data_ptr(), bq.data_ptr(),
        wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        wo.data_ptr(), bo.data_ptr(),
        lens.data_ptr() if lens is not None else None, ctx.data_ptr(),
        out.data_ptr(), N, S, E, heads, int(causal), float(D ** -0.5),
        int(x.dtype == torch.bfloat16), int(bq.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, code, what)
    build.count_launch(attention_block)
    return out


attention_block.launches = 0
