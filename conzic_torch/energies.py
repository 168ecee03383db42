"""Scoring energies of free and controlled captioning.

Counterpart of ``conzic_tpu/energies/__init__.py``: the masked-LM candidate
probabilities, their exact top-k with the PAD collapse, the control terms
(sentiment and POS scores over the (B, k, S) candidate rows, their softmax
over the candidates, the repeat penalty) and the combined score
``((alpha * lm + beta * clip) + gamma * ctl) + penalty``.

Each term rounds as the reference's compiled program does, on the CPU and
on CUDA alike. A division by a value the reference passes at run time (the
LM temperature) is a true division, written with a tensor divisor because
CUDA turns division by a Python scalar into a product with its rounded
reciprocal. A division by a constant of the reference's program (the mean
over the T template slots, the POS temperature 0.1) is that product: XLA
rewrites ``x / c`` into ``x * (1 / c)``, the reciprocal rounded to float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_TINY = torch.finfo(torch.float32).tiny  # smallest normal fp32


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded once, on the CPU and on CUDA alike."""
    return x / torch.full_like(x, divisor)


def _div_const(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` as XLA compiles a division by a constant: the
    product with the float32 reciprocal of ``divisor``."""
    recip = (torch.tensor(1.0) / torch.tensor(float(divisor))).item()
    return x * torch.full_like(x, recip)


def masked_lm_probs(logits: torch.Tensor, token_mask: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Softmax over the full vocabulary at ``temperature``, then the
    stop-word mask (kept entries are not renormalised, as in the
    reference).

    Subnormal probabilities are flushed to 0, as the TPU (and XLA on the
    CPU) computes them: at T=0.1 the tail of the softmax falls below the
    smallest normal fp32 value, and whether those entries tie at exactly
    0.0 decides which ids fill the rest of the top-k."""
    x = _div(logits.float(), temperature)
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


def repeat_penalty(cand_ids: torch.Tensor,
                   cand_rows: torch.Tensor) -> torch.Tensor:
    """``0.1 * (1 - exp(repeats))``, where ``repeats`` counts how often the
    candidate id already occurs in its candidate-substituted row, itself
    not counted. cand_ids (B, k); cand_rows (B, k, S)."""
    eq = (cand_ids[:, :, None] == cand_rows).float()
    repeats = eq.sum(dim=2) - 1.0
    return 0.1 * (1.0 - torch.exp(repeats))


def sentiment_scores(cand_rows: torch.Tensor, senti_table: torch.Tensor,
                     negative: bool) -> torch.Tensor:
    """Sentence valence: the sum of the per-token valences over the row,
    sign-flipped for negative control. cand_rows (..., S) BERT ids."""
    s = senti_table[cand_rows].sum(dim=-1)
    return -s if negative else s


def sentiment_probs(scores: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """Softmax over the candidates (the engine passes temperature 1)."""
    return torch.softmax(_div_const(scores, temperature), dim=-1)


def pos_accuracy(word_ids: torch.Tensor, pos_table: torch.Tensor,
                 template: torch.Tensor,
                 word_valid: torch.Tensor) -> torch.Tensor:
    """Template-match accuracy over the first T words.

    word_ids (..., W) BERT ids of the caption words in order (prompt words
    and sentence slots); pos_table (V,) universal tag id per token, with
    id ``num_tags`` for "no word"; template (T, num_tags + 1) accept matrix
    (``text.lexicons.template_matrix``); word_valid (..., W) 1 where the
    slot holds a real word. Returns (...,) matched slots / T, rounded as
    the reference's ``jnp.mean`` compiles: the count times float32(1 / T),
    which differs from a true division at some counts (7 of 12)."""
    T, C = template.shape
    num_tags = C - 1
    tags = torch.where(word_valid.bool(), pos_table[word_ids],
                       torch.full_like(word_ids, num_tags))
    W = tags.shape[-1]
    if W < T:
        pad = tags.new_full(tags.shape[:-1] + (T - W,), num_tags)
        tags = torch.cat([tags, pad], dim=-1)
    else:
        tags = tags[..., :T]
    slot = torch.arange(T, device=tags.device)
    match = template[slot, tags]  # (..., T)
    return _div_const(match.sum(dim=-1), float(T))


def pos_probs(acc: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """softmax(acc / 0.1) over the candidates, the division compiled as
    the reference's is (a product with 10.0)."""
    return torch.softmax(_div_const(acc, temperature), dim=-1)


def combine_scores(lm_probs: torch.Tensor, clip_probs: torch.Tensor,
                   alpha: float, beta: float,
                   ctl_probs: Optional[torch.Tensor] = None,
                   gamma: Optional[float] = None,
                   penalty: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``((alpha * lm + beta * clip) + gamma * ctl) + penalty``, added in
    the reference's order."""
    score = alpha * lm_probs + beta * clip_probs
    if ctl_probs is not None:
        score = score + gamma * ctl_probs
    if penalty is not None:
        score = score + penalty
    return score
