"""Shared transformer building blocks.

Counterpart of ``conzic_tpu/models/layers.py``: BERT (post-LayerNorm, erf
gelu) and both CLIP towers (pre-LayerNorm, quick gelu) share one residual
block. Parameters keep the type they were stored in and are cast to the
module's compute ``dtype`` on use, as the flax modules do; every LayerNorm
goes through the LayerNorm kernel, every quick gelu through the quick_gelu
kernel and every attention through one of the
three attention kernels, chosen by ``attn_impl``, or through the
reference's own XLA formulations (``"xla"``, ``"xla_bhsd"``,
``"twoblock"``: plain PyTorch products, the library route; the einsum form
goes through ``ops/attention.py`` ``xla_attention``, which runs it as one
kernel where a row's keys fit on chip). Under
``quant="int8"`` the projections and MLPs of a block multiply in int8
(``ops/quant.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from conzic_torch.kernels.attention_block import attention_block
from conzic_torch.kernels.attention_with_out import attention_with_out
from conzic_torch.kernels.layer_norm import layer_norm
from conzic_torch.kernels.masked_attention import (
    masked_attention,
    with_prefix,
)
from conzic_torch.kernels.quick_gelu import quick_gelu
from conzic_torch.ops.attention import (
    XLA_IMPLS,
    AttnMask,
    additive_bias,
    two_block_prefix_attention,
    xla_attention,
)
from conzic_torch.ops.quant import (
    QuantizedWeight,
    int8_linear,
    quantize_weight,
)
from conzic_torch.runtime import profiling


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A parameter (or a slice of one) in the compute type: ``p.to(dtype)``,
    counted as ``towers.weight_casts`` when the type changes."""
    if p.dtype == dtype:
        return p
    profiling.count(profiling.WEIGHT_CASTS)
    return p.to(dtype)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": F.gelu,  # erf form, as HF BERT
    # CLIP's, through the quick_gelu kernel; read from this module at call
    # time, as LayerNorm.forward reads layer_norm
    "quick_gelu": lambda x: quick_gelu(x),
    # SigLIP's: the tanh approximation
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


class Linear(nn.Module):
    """``y = x W^T + b`` with the weight cast to the compute type on use.

    ``quant="int8"``: the int8 product of ``ops/quant.py``, its fp32 result
    plus the fp32 bias, then cast to the compute type, as the reference's
    ``(int8_matmul(x, w) + b).astype(dtype)``. The stored parameter is
    quantized once and kept until it changes (another storage or an
    in-place write)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, quant: str = "none"):
        super().__init__()
        self.dtype, self.quant = dtype, quant
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self._quantized: Optional[Tuple[tuple, QuantizedWeight]] = None

    def quantized_weight(self) -> QuantizedWeight:
        w = self.weight
        key = (w.data_ptr(), w._version, w.device, w.dtype)
        if self._quantized is None or self._quantized[0] != key:
            self._quantized = (key, quantize_weight(w))
        return self._quantized[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "int8":
            y = int8_linear(x, self.quantized_weight())
            if self.bias is not None:
                y = y + self.bias.float()
            return y.to(self.dtype)
        b = (cast_param(self.bias, self.dtype) if self.bias is not None
             else None)
        return F.linear(x.to(self.dtype), cast_param(self.weight, self.dtype),
                        b)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis through the LayerNorm kernel (fp32
    statistics, output in the input's type)."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.contiguous(), self.scale, self.bias, self.eps)


class MultiHeadAttention(nn.Module):
    """MHA with bias on all projections. ``prefix_kv``: per-image prefix
    K/V (B, P, H, D) shared by the N = B*G rows of ``x``, put before each
    row's own keys: the masked-attention and attention-with-output kernels
    read it at image width (their prefix form); it is broadcast and
    concatenated only for the XLA routes and ``return_kv``.
    ``x_kv``: keys/values come from it while queries come from ``x`` (the
    pooled final layer).

    ``attn_impl`` picks the route, by the reference's conditions:
    ``"pallas_block"`` runs a pass that has a residual and neither prefix
    K/V, returned K/V nor ``x_kv`` as one attention-block kernel (on the
    unquantized weights, under int8 too, as the reference's block kernel);
    ``"pallas_out"`` runs a suffix-over-prefix pass with key lengths as one
    attention-with-output-projection kernel, unless the tower is quantized;
    every other pass under the three ``pallas*`` routes projects with
    ``Linear`` and goes through the masked-attention kernel. ``"xla"`` and
    ``"xla_bhsd"`` run the reference's einsum attention with its additive
    bias; ``"twoblock"`` its two-block prefix form where a pass has prefix
    K/V, no ``x_kv``, no returned K/V and no quantization, and the einsum
    form elsewhere. All read the same four ``Linear``s."""

    def __init__(self, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "pallas", quant: str = "none"):
        super().__init__()
        E = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.dtype, self.attn_impl, self.quant = dtype, attn_impl, quant
        self.query = Linear(E, E, dtype=dtype, quant=quant)
        self.key = Linear(E, E, dtype=dtype, quant=quant)
        self.value = Linear(E, E, dtype=dtype, quant=quant)
        self.out = Linear(E, E, dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor, mask: AttnMask,
                residual: Optional[torch.Tensor] = None,
                prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_kv: bool = False,
                x_kv: Optional[torch.Tensor] = None):
        H, D = self.num_heads, self.head_dim
        dt, impl = self.dtype, self.attn_impl
        quantized = self.quant != "none"
        if (impl == "pallas_block" and residual is not None
                and prefix_kv is None and not return_kv and x_kv is None):
            # the block kernel derives K/V from its single input, so the
            # pooled final layer (x_kv) cannot take it
            lins = (self.query, self.key, self.value, self.out)
            params = [t for lin in lins
                      for t in (cast_param(lin.weight, dt), lin.bias)]
            return attention_block(
                x.to(dt).contiguous(), residual.to(dt).contiguous(), *params,
                mask.lens, heads=H, causal=mask.causal)
        kv_src = x if x_kv is None else x_kv
        N, Sq = x.shape[0], x.shape[1]
        q = self.query(x).view(N, Sq, H, D)
        k = self.key(kv_src).view(N, kv_src.shape[1], H, D)
        v = self.value(kv_src).view(N, kv_src.shape[1], H, D)
        with_out = (impl == "pallas_out" and prefix_kv is not None
                    and mask.lens is not None and x_kv is None
                    and not return_kv and not quantized)
        two_block = (impl == "twoblock" and prefix_kv is not None
                     and x_kv is None and not return_kv and not quantized)
        xla = impl in XLA_IMPLS
        if prefix_kv is not None:
            prefix_kv = tuple(t.to(dt).contiguous() for t in prefix_kv)
            if return_kv or (xla and not two_block):
                k, v = with_prefix(k, v, prefix_kv)
                prefix_kv = None
        if with_out:
            # the kernel's queries are the trailing rows of its keys, which
            # a pooled layer's (x_kv) are not
            y = attention_with_out(
                q.contiguous(), k.contiguous(), v.contiguous(),
                cast_param(self.out.weight, q.dtype), self.out.bias, mask.lens,
                mask.causal, prefix_kv)
            return y if residual is None else y + residual
        if two_block:
            Sk = prefix_kv[0].shape[1] + k.shape[1]
            out = two_block_prefix_attention(
                q, k, v, *prefix_kv,
                additive_bias(mask, N, Sq, Sk, q.device))
        elif xla:
            out = xla_attention(
                q, k, v, mask,
                impl="xla_bhsd" if impl == "xla_bhsd" else "xla")
        else:
            out = masked_attention(q, k.contiguous(), v.contiguous(),
                                   mask.lens, mask.causal, prefix_kv)
        out = self.out(out.reshape(N, Sq, H * D))
        if residual is not None:
            out = out + residual
        if return_kv:
            return out, (k, v)
        return out


class Mlp(nn.Module):
    def __init__(self, hidden: int, intermediate: int, act: str,
                 dtype: torch.dtype = torch.float32, quant: str = "none"):
        super().__init__()
        self.act = ACTIVATIONS[act]
        self.fc1 = Linear(hidden, intermediate, dtype=dtype, quant=quant)
        self.fc2 = Linear(intermediate, hidden, dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def _pooled_mask(mask: AttnMask, query_idx: torch.Tensor, n_rows: int,
                 n_keys: int) -> AttnMask:
    """The mask of the query rows at ``query_idx`` (N, Q) attending all
    ``n_keys`` keys, as non-causal queries. Without a causal rule any Q
    rows keep ``mask.lens``. A single causal query at row i (of ``n_rows``)
    sees keys col <= i + (n_keys - n_rows), which is folded into its key
    length: exact for any row, and equal to ``mask.lens`` at the CLIP text
    tower's first-EOS row (the padding mask ends there). Several causal
    queries would each need a length of their own, which the kernels'
    per-row ``lens`` cannot say; no tower asks for that."""
    if not mask.causal:
        return AttnMask(lens=mask.lens, causal=False)
    if query_idx.shape[1] != 1:
        raise NotImplementedError(
            "a pooled final layer with more than one causal query row")
    reach = (query_idx[:, 0] + (n_keys - n_rows) + 1).to(torch.int32)
    lens = reach if mask.lens is None else torch.minimum(mask.lens, reach)
    return AttnMask(lens=lens.contiguous(), causal=False)


class TransformerBlock(nn.Module):
    """One residual attention block.

    ``pre_ln=False`` -> BERT ordering:  x = LN(x + Attn(x)); x = LN(x + MLP(x))
    ``pre_ln=True``  -> CLIP ordering:  x = x + Attn(LN(x)); x = x + MLP(LN(x))
    """

    def __init__(self, num_heads: int, head_dim: int, intermediate: int,
                 act: str, eps: float, pre_ln: bool,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "pallas", quant: str = "none"):
        super().__init__()
        hidden = num_heads * head_dim
        self.pre_ln = pre_ln
        self.attention = MultiHeadAttention(num_heads, head_dim, dtype=dtype,
                                            attn_impl=attn_impl, quant=quant)
        self.mlp = Mlp(hidden, intermediate, act, dtype=dtype, quant=quant)
        self.ln1 = LayerNorm(hidden, eps)
        self.ln2 = LayerNorm(hidden, eps)

    def forward(self, x: torch.Tensor, mask: AttnMask,
                prefix_kv=None, return_kv: bool = False,
                query_idx: Optional[torch.Tensor] = None):
        """``query_idx`` (N, Q): compute the block's output only at those
        rows (keys/values still span every position) — the final layer
        before a pooled or masked-slot readout. Returns (N, Q, E)."""
        if query_idx is not None:
            n_keys = x.shape[1] + (prefix_kv[0].shape[1]
                                   if prefix_kv is not None else 0)
            qmask = _pooled_mask(mask, query_idx, x.shape[1], n_keys)
            def take(a):
                return torch.gather(
                    a, 1, query_idx[:, :, None].expand(-1, -1, a.shape[-1]))

            if self.pre_ln:
                xn = self.ln1(x)
                xq = self.attention(take(xn), qmask, residual=take(x),
                                    prefix_kv=prefix_kv, x_kv=xn)
                return xq + self.mlp(self.ln2(xq))
            xq = self.attention(take(x), qmask, residual=take(x),
                                prefix_kv=prefix_kv, x_kv=x)
            xq = self.ln1(xq)
            return self.ln2(xq + self.mlp(xq))
        if self.pre_ln:
            a = self.attention(self.ln1(x), mask, residual=x,
                               prefix_kv=prefix_kv, return_kv=return_kv)
            x, kv = a if return_kv else (a, None)
            x = x + self.mlp(self.ln2(x))
        else:
            a = self.attention(x, mask, residual=x, prefix_kv=prefix_kv,
                               return_kv=return_kv)
            x, kv = a if return_kv else (a, None)
            x = self.ln1(x)
            x = self.ln2(x + self.mlp(x))
        return (x, kv) if return_kv else x


class TransformerStack(nn.Module):
    """N blocks, named ``layer_i`` like the flax stack's unrolled layers."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 intermediate: int, act: str, eps: float, pre_ln: bool,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "pallas", quant: str = "none"):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerBlock(num_heads, head_dim, intermediate, act, eps,
                             pre_ln, dtype=dtype, attn_impl=attn_impl,
                             quant=quant)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor, mask: AttnMask,
                prefix_kvs: Optional[List] = None, return_kvs: bool = False,
                pool_idx: Optional[torch.Tensor] = None,
                depth: Optional[int] = None):
        """``pool_idx`` (N, Q): the output is only read at those rows, so
        the final layer computes just them; the output becomes (N, Q, E).
        ``depth``: run the first ``depth`` blocks only, as a stack of that
        many layers would."""
        kvs = []
        layers = self.layers if depth is None else self.layers[:depth]
        last = len(layers) - 1
        for i, block in enumerate(layers):
            pkv = prefix_kvs[i] if prefix_kvs is not None else None
            if return_kvs:
                x, kv = block(x, mask, prefix_kv=pkv, return_kv=True)
                kvs.append(kv)
            elif pool_idx is not None and i == last:
                x = block(x, mask, prefix_kv=pkv, query_idx=pool_idx)
            else:
                x = block(x, mask, prefix_kv=pkv)
        return (x, kvs) if return_kvs else x
