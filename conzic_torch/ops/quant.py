"""Symmetric dynamic int8 products: the opt-in int8 tier (``--quant``).

Counterpart of ``conzic_tpu/ops/quant.py``. The projections and MLPs of a
quantized tower multiply int8 values with int32 accumulation:

  - weights: int8 per output channel, scale max|w| / 127, quantized once
    from the stored parameter (:func:`quantize_weight`; ``Linear`` keeps
    the result until the parameter changes, as XLA hoists the reference's
    loop-invariant quantization out of its Gibbs loop);
  - activations: int8 per row, scale max|x| / 127, at every call;
  - the int32 product rescaled in fp32: ``y * sx * sw``.

On the card the int32 product is ``torch._int_mm`` (cuBLASLt's int8 GEMM),
as the reference's is XLA's int8 ``dot_general``: no Pallas kernel stands
behind either. It changes numerics and is off by default.

Rounding as the reference compiles it: ``max(amax, 1e-8) / 127`` is a
division by a constant, which XLA turns into a product with the fp32
reciprocal of 127; ``x / scale`` is a true division by an array; both
sides round half to even. The int32 products are therefore equal to the
reference's, and the fp32 outputs lie within an ulp or two of them (XLA
may contract ``y * sx * sw + b`` into fused multiply-adds).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# the fp32 reciprocal of 127, as XLA folds the reference's "/ 127.0"
_INV_127 = (torch.tensor(1.0) / torch.tensor(127.0)).item()
# torch._int_mm on CUDA takes more than 16 rows and K, N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-8) * torch.full_like(amax, _INV_127)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: x (..., D) -> (int8 values, (..., 1) fp32
    scale)."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return _quantize(xf, scale), scale


def _quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a (D_in, D_out) kernel (the
    reference's layout) -> (int8 values, (1, D_out) fp32 scale)."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=0, keepdim=True))
    return _quantize(wf, scale), scale


class QuantizedWeight(NamedTuple):
    q: torch.Tensor  # (D_out, D_in) int8, torch's weight layout
    scale: torch.Tensor  # (D_out,) fp32


def quantize_weight(weight: torch.Tensor) -> QuantizedWeight:
    """A torch (D_out, D_in) weight, per output channel."""
    q, scale = _quantize_cols(weight.t())
    return QuantizedWeight(q.t().contiguous(), scale[0])


def _pad_to(n: int, multiple: int) -> int:
    return (-n) % multiple


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b_t.T, b_t (N, K) int8 -> (M, N) int32, on the
    integer path of ``torch._int_mm``. On CUDA, rows, K and N are padded
    with zeros to what cuBLASLt takes (exact under int32 accumulation) and
    the result is cut back."""
    M, K = a.shape
    N = b_t.shape[0]
    if a.device.type != "cuda":
        return torch._int_mm(a, b_t.t())
    pm = max(0, _MIN_ROWS - M)
    pk, pn = _pad_to(K, _ALIGN), _pad_to(N, _ALIGN)
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b_t = torch.nn.functional.pad(b_t, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:M, :N] if (pm or pn) else out


def int8_linear(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """``x (..., D_in)`` times a quantized (D_out, D_in) weight -> fp32
    (..., D_out): rows quantized here, int32 product, ``y * sx * sw``."""
    shape = x.shape
    xq, sx = _quantize_rows(x.reshape(-1, shape[-1]))
    y = int_mm(xq, w.q).float() * sx * w.scale
    return y.reshape(*shape[:-1], w.q.shape[0])


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., D_in) @ w (D_in, D_out)`` through int8, as the
    reference's ``int8_matmul`` (the weight in its layout, quantized on
    this call). Returns fp32."""
    return int8_linear(x, quantize_weight(w.t()))
