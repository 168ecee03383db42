"""The library route's attention in one pass: the CUDA kernel
``csrc/dot_product_attention.cu``.

The reference's ``"xla"`` attention (``conzic_tpu/ops/attention.py:153``,
transcribed as :func:`conzic_torch.ops.attention.dot_product_attention`):
fp32 logits from the bf16 products, scaled by D^-0.5, plus the additive
bias that :func:`conzic_torch.ops.attention.additive_bias` builds from the
key lengths and the causal rule, a softmax in fp32, the weights rounded to
q's type, then the value product. It replaces no Pallas kernel: XLA
compiles the formula into a few fusions, PyTorch runs it as a dozen passes.
The kernel takes bf16 q (N, Sq, H, D), k and v (N, Sk, H, D) with
1 <= Sq <= Sk <= :data:`MAX_KEYS` and D <= :data:`MAX_HEAD_DIM` a multiple
of 8; :func:`conzic_torch.ops.attention.xla_attention` decides which calls
take it, and sends it CUDA tensors only. Its plain version is the formula
itself, :func:`conzic_torch.ops.attention.fused_dot_product_attention_plain`.
The wrapper raises on what the kernel does not take.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from conzic_torch.kernels import build

MAX_KEYS = 128  # a row's keys and query rows: one row of logits a quad
MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = build.load("dot_product_attention")
    if not getattr(lib, "_conzic_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conzic_dot_product_attention.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p,
        ]
        lib.conzic_dot_product_attention.restype = ctypes.c_int
        lib._conzic_typed = True
    return lib


def fused_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                lens: Optional[torch.Tensor] = None,
                                causal: bool = False) -> torch.Tensor:
    """The reference's einsum attention with the bias of (``lens``,
    ``causal``), in one kernel on a CUDA device. Returns (N, Sq, H, D) in
    bf16. No gradient: the dispatcher keeps grad-mode calls on the library
    formula."""
    if q.device.type != "cuda":
        raise ValueError(f"dot_product_attention: no kernel for device "
                         f"{q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("dot_product_attention: the kernel takes bf16 only; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    N, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (N, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"dot_product_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (1 <= Sq <= Sk <= MAX_KEYS and D <= MAX_HEAD_DIM and D % 8 == 0):
        raise ValueError(f"dot_product_attention: Sq={Sq}, Sk={Sk}, D={D} "
                         f"(1 <= Sq <= Sk <= {MAX_KEYS}, D <= {MAX_HEAD_DIM} "
                         f"a multiple of 8)")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("dot_product_attention: q, k, v must be "
                             "contiguous on one device")
        if t.data_ptr() % 16:
            raise ValueError("dot_product_attention: q, k, v must be 16-byte "
                             "aligned")
    lens_ptr = None
    if lens is not None:
        lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (N,):
            raise ValueError(f"dot_product_attention: lens {tuple(lens.shape)}"
                             f" for {N} rows")
        lens_ptr = lens.data_ptr()
    lib = _lib()
    out = torch.empty_like(q)
    code = lib.conzic_dot_product_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr, out.data_ptr(),
        N, H, Sq, Sk, D, int(causal), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, code, "dot_product_attention")
    build.count_launch(fused_dot_product_attention)
    return out


fused_dot_product_attention.launches = 0
