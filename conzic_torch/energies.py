"""Scoring energies of free captioning.

Counterpart of ``conzic_tpu/energies/__init__.py`` for the terms the free
captioning path uses: the masked-LM candidate probabilities, their exact
top-k with the PAD collapse, and the combined score
``alpha * lm + beta * clip``.
"""

from __future__ import annotations

from typing import Tuple

import torch

_TINY = torch.finfo(torch.float32).tiny  # smallest normal fp32


def masked_lm_probs(logits: torch.Tensor, token_mask: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Softmax over the full vocabulary at ``temperature``, then the
    stop-word mask (kept entries are not renormalised, as in the
    reference).

    Subnormal probabilities are flushed to 0, as the TPU (and XLA on the
    CPU) computes them: at T=0.1 the tail of the softmax falls below the
    smallest normal fp32 value, and whether those entries tie at exactly
    0.0 decides which ids fill the rest of the top-k."""
    x = logits.float()
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiplication by its rounded reciprocal, which is not x / T
    x = x / torch.full_like(x, temperature)
    probs = torch.softmax(x, dim=-1)
    probs = torch.where(probs < _TINY, 0.0, probs)
    return probs * token_mask


def topk_candidates(probs: torch.Tensor, token_mask: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (B, V) masked probabilities, ties broken towards the
    lower index (``lax.top_k``'s order: a stable descending sort), and
    candidate ids whose mask is 0 collapsed to 0 ([PAD]) like the
    reference's ``(idxs * mask[idxs]).long()``. ``token_mask`` is (V,) or
    (B, V). Returns ((B, k) probabilities, (B, k) int64 ids)."""
    values, idxs = torch.sort(probs, dim=-1, descending=True, stable=True)
    values, idxs = values[:, :k], idxs[:, :k]
    if token_mask.dim() == 1:
        keep = token_mask[idxs]
    else:
        keep = torch.gather(token_mask, 1, idxs)
    return values, idxs * keep.to(idxs.dtype)


def combine_scores(lm_probs: torch.Tensor, clip_probs: torch.Tensor,
                   alpha: float, beta: float) -> torch.Tensor:
    return alpha * lm_probs + beta * clip_probs
