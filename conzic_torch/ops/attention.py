"""Attention masking in the form the port's kernel takes.

Counterpart of ``conzic_tpu/ops/attention.py``. Every attention of the port
goes through the masked-attention kernel, so a mask is only ever the
kernel's (``lens``, ``causal``) pair: key padding by valid key lengths and a
(rectangular) causal rule. :func:`attention_keep_mask` expands it to the
boolean (N, 1, Sq, Sk) mask that the plain version of the kernel and the
library yardstick apply.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e9  # the value masked logits are replaced by


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
