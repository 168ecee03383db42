"""Scoring energies of free and controlled captioning.

Counterpart of ``conzic_tpu/energies/__init__.py``: the masked-LM candidate
probabilities, their exact top-k with the PAD collapse, the control terms
(sentiment and POS scores over the (B, k, S) candidate rows, their softmax
over the candidates, the repeat penalty), the combined score
``((alpha * lm + beta * clip) + gamma * ctl) + penalty``, and the pruned
tiers' stage-1 pieces: the bag-of-embeddings proxy, the control-aware rank
and the cut.

Every cut is a stable descending sort, which keeps ``lax.top_k``'s order
among ties (the lower index first); ``torch.topk`` promises no order there,
and ties are common: candidates masked to [PAD] score alike.

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
# topk_candidates takes exact_topk_2stage from this many rows up, else one
# sort; the ids are the same either way. chip_smoke.py's phase_topk_chunk
# times both at V=30,522, k=200 on an NVIDIA H100 80GB HBM3 at 700 W: the
# one sort is faster at B=32 and 64 (0.133 and 0.201 ms against 0.213 and
# 0.214), the two-stage form at B=128, 256 and 512 (0.287, 0.512, 0.961
# against 0.442, 0.653, 1.265; PERF.md, PR 7 run E)
TOPK_2STAGE_MIN_ROWS = 128


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


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values (a stable descending sort). Returns (values,
    int64 indices)."""
    values, idxs = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idxs[..., :k]


def exact_topk_2stage(probs: torch.Tensor, k: int, chunk: int = 4096
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`top_k` of (B, V) through blocks of about ``chunk`` columns:
    each block's top k, then the top k of those. The same values and
    indices in the same order: every overall top-k entry is in its block's
    top k, blocks are laid out in index order and both sorts keep the
    lower index first among equals. Falls back to one sort when
    ``chunk <= 0``, when fewer than two blocks fit, or when k exceeds half
    a block, as the reference does."""
    B, V = probs.shape
    n_chunks = V // chunk if chunk > 0 else 0
    if n_chunks < 2 or k > chunk // 2:
        return top_k(probs, k)
    pad = (-V) % n_chunks
    if pad:
        probs = torch.nn.functional.pad(
            probs, (0, pad), value=torch.finfo(probs.dtype).min)
    Vc = (V + pad) // n_chunks
    v1, i1 = top_k(probs.reshape(B, n_chunks, Vc), k)  # (B, C, k)
    gi = i1 + (torch.arange(n_chunks, device=probs.device) * Vc)[None, :,
                                                                None]
    v2, sel = top_k(v1.reshape(B, n_chunks * k), k)
    return v2, torch.gather(gi.reshape(B, n_chunks * k), 1, sel)


def topk_candidates(probs: torch.Tensor, token_mask: torch.Tensor, k: int,
                    chunk: int = 4096,
                    banned_ids: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (B, V) masked probabilities, ties broken towards the
    lower index (``lax.top_k``'s order: a stable descending sort), and
    candidate ids whose mask is 0 collapsed to 0 ([PAD]) like the
    reference's ``(idxs * mask[idxs]).long()``. ``token_mask`` is (V,) or
    (B, V). Returns ((B, k) probabilities, (B, k) int64 ids). The
    reference's ``mode="approx"`` is exact off the TPU, so there is no
    other mode here. ``banned_ids`` (``mask_impl="compare"``):
    (nb,) or (B, nb) ids whose mask is 0, padded with -1; the collapse to
    [PAD] is then a membership test against them in place of the mask's
    gather: the same ids. ``chunk`` is :func:`exact_topk_2stage`'s block,
    taken from :data:`TOPK_2STAGE_MIN_ROWS` rows up."""
    if probs.shape[0] >= TOPK_2STAGE_MIN_ROWS:
        values, idxs = exact_topk_2stage(probs, k, chunk=chunk)
    else:
        values, idxs = top_k(probs, k)
    if banned_ids is not None:
        if banned_ids.dim() == 1:
            banned_ids = banned_ids[None, :]
        hit = (idxs[:, :, None] == banned_ids[:, None, :]).any(dim=-1)
        return values, torch.where(hit, torch.zeros_like(idxs), idxs)
    if token_mask.dim() == 1:
        keep = token_mask[idxs]
    else:
        keep = torch.gather(token_mask, 1, idxs)
    return values, idxs * keep.to(idxs.dtype)


def unit(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """``x / (||x|| + eps)`` over the last axis."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / (norm + eps) if eps else x / norm


def prune_proxy_scores(word_embeds: torch.Tensor, base_ids: torch.Tensor,
                       col: torch.Tensor, cand_ids: torch.Tensor,
                       image_embeds: torch.Tensor, seq_len: int,
                       exclude_slot: bool = True) -> torch.Tensor:
    """The stage-1 proxy: cos(image, normalise(bag + w[cand])), where the
    bag sums the per-word CLIP embeddings (``word_embeds`` (V, D), specials
    exactly 0) of the base row's caption tokens, less the word at the
    edited column ``col`` (B,) when ``exclude_slot``: the parallel order's
    base row keeps its old word there; every masked order holds [MASK],
    whose embedding is 0. base_ids (B, S), cand_ids (B, K), image_embeds
    (B, D). The text side is divided by its norm + 1e-6, the image side by
    its norm, as the reference does. Returns (B, K) fp32."""
    bag = word_embeds[base_ids[:, 1:seq_len - 1]].sum(dim=1)
    if exclude_slot:
        old = torch.gather(base_ids, 1, col[:, None].to(base_ids.dtype))
        bag = bag - word_embeds[old[:, 0]]
    cand = unit(bag[:, None, :] + word_embeds[cand_ids], 1e-6)
    img = unit(image_embeds).to(cand.dtype)
    return torch.einsum("bkd,bd->bk", cand, img)


def stage1_ctl_rank(surr_cos: torch.Tensor, lm_probs: torch.Tensor,
                    cand_ids: torch.Tensor, cand_rows: torch.Tensor, *,
                    ctl: str, negative: bool, seq_len: int,
                    logit_scale: torch.Tensor, alpha: float, beta: float,
                    gamma: float, senti: Optional[torch.Tensor] = None,
                    pos_table: Optional[torch.Tensor] = None,
                    template: Optional[torch.Tensor] = None,
                    bridge_lens: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The control-aware stage-1 rank: the whole combined score over the
    current candidates, with the stage-1 cosine ``surr_cos`` (B, K) in
    place of the full tower's: ``alpha * lm + beta * softmax(cos *
    exp(logit_scale)) + gamma * ctl`` (and the repeat penalty for
    sentiment), every softmax over the candidate axis, in fp32. The control
    term is the table form whatever ``ctl_mode`` is. cand_rows (B, K, S):
    the BERT rows with each candidate at its slot."""
    clip_probs = torch.softmax(
        surr_cos.float() * torch.exp(logit_scale).float(), dim=-1)
    penalty = None
    if ctl == "sentiment":
        ctl_probs = sentiment_probs(sentiment_scores(cand_rows, senti,
                                                     negative=negative))
        penalty = repeat_penalty(cand_ids, cand_rows)
    elif ctl == "pos":
        inner = cand_rows[:, :, 1:seq_len - 1]
        word_valid = (bridge_lens[inner] > 0).int()
        ctl_probs = pos_probs(pos_accuracy(inner, pos_table, template,
                                           word_valid))
    else:
        raise ValueError(f"stage1_ctl_rank: unknown ctl {ctl!r}")
    return combine_scores(lm_probs, clip_probs, alpha, beta,
                          ctl_probs=ctl_probs, gamma=gamma, penalty=penalty)


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
