"""Attention masking, and the reference's XLA attention formulations.

Counterpart of ``conzic_tpu/ops/attention.py``. A mask is the kernels'
(``lens``, ``causal``) pair: key padding by valid key lengths and a
(rectangular) causal rule. :func:`attention_keep_mask` expands it to the
boolean (N, 1, Sq, Sk) mask that the plain version of the kernel and the
library yardstick apply; :func:`additive_bias` to the reference's additive
fp32 bias.

The ``attn_impl`` routes ``"xla"``, ``"xla_bhsd"`` and ``"twoblock"`` are
the reference's own formulations, which XLA compiles outside any Pallas
call: :func:`dot_product_attention` (einsums, fp32 logits, an additive
bias, softmax, the weights cast to the compute type before the value
product) and :func:`two_block_prefix_attention`. They run here as plain
PyTorch products, the library route on the card, and they are not the
attention kernels' plain versions (those replace masked logits; these add
the bias, as the reference does). :func:`xla_attention` is the einsum
form's one entry: where a row's keys fit on chip it computes the same
formula in one hand-written kernel (``kernels/dot_product_attention.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from conzic_torch.kernels.dot_product_attention import (
    MAX_HEAD_DIM,
    MAX_KEYS,
    fused_dot_product_attention,
)
from conzic_torch.runtime import profiling

NEG_INF = -1e9  # masked logits: replaced by it (kernels), or offset (XLA)
# the routes that run the reference's XLA formulations
XLA_IMPLS = ("xla", "xla_bhsd", "twoblock")


@dataclasses.dataclass(frozen=True)
class AttnMask:
    lens: Optional[torch.Tensor] = None  # (N,) int32 valid key lengths
    causal: bool = False


def make_attn_mask(padding_mask: Optional[torch.Tensor], *,
                   causal: bool = False, offset: int = 0) -> AttnMask:
    """(N, S) right-padded 0/1 mask -> lengths; ``offset`` keys (an
    unmasked shared prefix) are added to every length."""
    lens = None
    if padding_mask is not None:
        lens = (padding_mask.to(torch.int32).sum(-1) + offset).to(torch.int32)
    return AttnMask(lens=lens, causal=causal)


def attention_keep_mask(lens: Optional[torch.Tensor], N: int, Sq: int,
                        Sk: int, causal: bool,
                        device: torch.device) -> torch.Tensor:
    """Boolean (N, 1, Sq, Sk): key ``col`` is kept for query ``row`` iff
    ``col < lens[n]`` and, when causal, ``col <= row + (Sk - Sq)``."""
    col = torch.arange(Sk, device=device)
    keep = torch.ones((N, 1, Sq, Sk), dtype=torch.bool, device=device)
    if lens is not None:
        keep = keep & (col[None, :] < lens[:, None].to(device))[:, None, None]
    if causal:
        row = torch.arange(Sq, device=device)
        keep = keep & (col[None, :] <= row[:, None] + (Sk - Sq))
    return keep


def additive_bias(mask: AttnMask, N: int, Sq: int, Sk: int,
                  device: torch.device) -> Optional[torch.Tensor]:
    """The reference's additive fp32 bias (``make_attention_bias``, at full
    key width under a prefix): -1e9 at keys ``col >= lens[n]``, plus -1e9
    at ``col > row + (Sk - Sq)`` when causal (a key masked twice gets
    -2e9, as there). (N or 1, 1, Sq, Sk), or None without masking.

    The reference's pooled final layer gathers rows of that bias; the
    port folds a pooled causal row into its key length
    (``models/layers.py`` ``_pooled_mask``), which masks the same keys
    by -1e9 once. A masked key's weight underflows to exactly 0 either
    way, so the softmax is the same."""
    col = torch.arange(Sk, device=device)
    bias = None
    if mask.lens is not None:
        keep = (col[None, :] < mask.lens[:, None].to(device)).float()
        bias = ((1.0 - keep) * NEG_INF)[:, None, None, :]
    if mask.causal:
        row = torch.arange(Sq, device=device)
        causal = torch.where(col[None, :] <= row[:, None] + (Sk - Sq),
                             0.0, NEG_INF).float()[None, None]
        bias = causal if bias is None else bias + causal
    return bias


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) divided by its
    sum (not multiplied by the sum's reciprocal)."""
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          impl: str = "xla") -> torch.Tensor:
    """The reference's einsum attention. q, k, v (N, S, H, D); ``bias``
    additive fp32, broadcastable to (N, H, Sq, Sk). fp32 logits (products
    of the compute-type values, summed in fp32) scaled by D^-0.5 plus the
    bias, softmax, the weights cast to q's type, then the value product in
    that type. ``impl="xla_bhsd"`` computes the same in the (N, H, S, D)
    layout. Returns (N, Sq, H, D) in q's type."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    if impl == "xla_bhsd":
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2))
        logits = logits * scale
        if bias is not None:
            logits = logits + bias
        weights = _softmax(logits).to(dtype)
        return torch.matmul(weights, vt).transpose(1, 2).to(dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    weights = _softmax(logits).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v).to(dtype)


def fused_dot_product_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      lens: Optional[torch.Tensor] = None,
                                      causal: bool = False) -> torch.Tensor:
    """The plain version of ``kernels/dot_product_attention.py``'s kernel,
    which computes the formula itself: :func:`dot_product_attention` under
    the :func:`additive_bias` of (``lens``, ``causal``)."""
    N, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    bias = additive_bias(AttnMask(lens, causal), N, Sq, Sk, q.device)
    return dot_product_attention(q, k, v, bias)


def fits_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The kernel's conditions but the device: bf16 tensors, 1 <= Sq <= Sk
    <= 128 keys, D <= 128 a multiple of 8, and no input that requires grad
    under grad mode (the kernel has no backward)."""
    Sq, D, Sk = q.shape[1], q.shape[-1], k.shape[1]
    return (all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and 1 <= Sq <= Sk <= MAX_KEYS
            and D <= MAX_HEAD_DIM and D % 8 == 0
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (q, k, v))))


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether :func:`xla_attention` runs the hand-written kernel: a call on
    a CUDA device that :func:`fits_kernel`."""
    return q.device.type == "cuda" and fits_kernel(q, k, v)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: AttnMask, impl: str = "xla") -> torch.Tensor:
    """The einsum attention of the ``"xla"`` routes, q, k, v (N, S, H, D)
    under ``mask``: one kernel launch where :func:`kernel_takes` the call,
    else :func:`additive_bias` and :func:`dot_product_attention` in
    ``impl``'s layout. Counts each call under
    ``profiling.ATTENTION_KERNEL_CALLS`` or ``ATTENTION_LIBRARY_CALLS``."""
    if kernel_takes(q, k, v):
        profiling.count(profiling.ATTENTION_KERNEL_CALLS)
        return fused_dot_product_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), mask.lens,
            mask.causal)
    profiling.count(profiling.ATTENTION_LIBRARY_CALLS)
    bias = additive_bias(mask, q.shape[0], q.shape[1], k.shape[1], q.device)
    return dot_product_attention(q, k, v, bias, impl=impl)


def two_block_prefix_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, pk: torch.Tensor,
                               pv: torch.Tensor,
                               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The reference's shared-prefix attention without the broadcast and
    concatenated K/V: the prefix logits at image width, the suffix logits
    per row, one softmax over both, the value product split the same way
    and its two fp32 halves added. q, k, v (N = B*G, S, H, D); pk, pv (B,
    P, H, D); ``bias`` additive at full key width (prefix keys first)."""
    N, S, H, D = q.shape
    B, P = pk.shape[0], pk.shape[1]
    G = N // B
    scale = D ** -0.5
    l_s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    qg = q.reshape(B, G * S, H, D)
    l_p = torch.einsum("bqhd,bphd->bhqp", qg.float(),
                       pk.to(q.dtype).float())
    l_p = l_p.reshape(B, H, G, S, P).permute(0, 2, 1, 3, 4).reshape(
        N, H, S, P)
    logits = torch.cat([l_p, l_s], dim=-1) * scale
    if bias is not None:
        logits = logits + bias
    w = _softmax(logits)
    w_s = w[..., P:].to(q.dtype)
    w_p = w[..., :P].to(q.dtype)
    out_s = torch.einsum("bhqk,bkhd->bqhd", w_s.float(), v.float())
    w_pg = w_p.reshape(B, G, H, S, P).permute(0, 2, 1, 3, 4).reshape(
        B, H, G * S, P)
    out_p = torch.einsum("bhqp,bphd->bqhd", w_pg.float(),
                         pv.to(q.dtype).float())
    return (out_s + out_p.reshape(N, S, H, D)).to(q.dtype)
