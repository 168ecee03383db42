"""The Gibbs polishing engine, free captioning in every order.

Counterpart of ``conzic_tpu/engine/gibbs.py``. For each iteration and each
position of the schedule: mask the position, take BERT's top-k proposals at
that slot only, assemble the k candidate CLIP rows through the bridge table,
encode them with the CLIP text tower (row chunks over the prompt prefix's
cached K/V), score ``alpha * lm + beta * clip``, commit the argmax, and
track the best-by-cosine caption. The span order polishes the slots of a
span from one BERT forward and the parallel order every slot from one
unmasked forward (engine/orders.py). The reference package's ``lax.scan``s
and ``lax.map`` are Python loops here; every step stays on the device and
the host reads nothing back until the generation ends.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from conzic_torch import energies
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel
from conzic_torch.text.bridge import (
    assemble_clip_ids,
    assemble_clip_ids_substitute,
)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    seed_len: int  # 1 + number of prompt tokens ([CLS] + prompt)
    sentence_len: int
    seq_len: int  # full BERT row length = seed_len + sentence_len + 1
    candidate_k: int
    clip_len: int
    mask_token_id: int
    clip_bos_id: int
    clip_eos_id: int
    clip_pad_id: int
    # ((prefix_len, n_steps), ...): the position sweep cut into chunks whose
    # steps share a lower bound on the candidates' common CLIP prefix; its
    # K/V are computed at image-batch width. None disables.
    prefix_chunks: Optional[Tuple[Tuple[int, int], ...]] = None
    clip_row_chunk: int = 0  # candidate rows per text-tower pass; 0 = all
    clip_pad_to: int = 0  # pad candidate rows to this length; 0 = off
    order_kind: str = "single"  # single | span | parallel


class Generation(NamedTuple):
    iter_ids: torch.Tensor  # (I, B, S) rows after each iteration
    iter_cos: torch.Tensor  # (I, B) cosine of the last committed candidate
    best_ids: torch.Tensor  # (B, S)
    best_cos: torch.Tensor  # (B,)


def _encode_candidates(spec: EngineSpec, clip: CLIPModel,
                       clip_ids: torch.Tensor, clip_mask: torch.Tensor,
                       prefix_len: int, prefix_kvs: Optional[List] = None
                       ) -> torch.Tensor:
    """(B, k, L) candidate rows -> (B*k, D) text embeddings: exact
    prefix-K/V reuse when ``prefix_len >= 2`` and row chunks of at most
    ``spec.clip_row_chunk`` rows."""
    if spec.clip_pad_to > clip_ids.shape[-1]:
        extra = spec.clip_pad_to - clip_ids.shape[-1]
        clip_ids = torch.nn.functional.pad(clip_ids, (0, extra),
                                           value=spec.clip_pad_id)
        clip_mask = torch.nn.functional.pad(clip_mask, (0, extra))
    B, k, L = clip_ids.shape
    P = prefix_len if 2 <= prefix_len < spec.clip_len - 1 else 0

    def encode(ids_bk, mask_bk):  # (B, kc, L) -> (B, kc, D)
        kc = ids_bk.shape[1]
        if P and prefix_kvs is not None:
            emb = clip.encode_text_suffix(prefix_kvs, P, ids_bk[:, :, P:],
                                          mask_bk[:, :, P:])
        elif P:
            emb = clip.encode_text_shared_prefix(
                ids_bk[:, 0, :P], ids_bk[:, :, P:], mask_bk[:, :, P:])
        else:
            emb = clip.encode_text(ids_bk.reshape(B * kc, L),
                                   mask_bk.reshape(B * kc, L))
        return emb.reshape(B, kc, -1)

    kc = k
    rc = spec.clip_row_chunk
    if rc and B * k > rc:
        kc = max(1, rc // B)
        while k % kc:
            kc -= 1
    embs = [encode(clip_ids[:, c:c + kc], clip_mask[:, c:c + kc])
            for c in range(0, k, kc)]
    return torch.cat(embs, dim=1).reshape(B * k, -1)


def _position_update(spec: EngineSpec, clip: CLIPModel,
                     tables: Dict[str, torch.Tensor], hyper: Dict[str, float],
                     image_embeds: torch.Tensor, base_ids: torch.Tensor,
                     commit_ids: torch.Tensor, pos: torch.Tensor,
                     logits: torch.Tensor, token_mask: torch.Tensor,
                     prefix_len: int, prefix_kvs: Optional[List]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score k candidates for ``pos`` (B,) and commit the argmax.
    ``base_ids``: the rows the candidates are built from; ``commit_ids``:
    the rows the winner is written into (they differ only in the parallel
    order). Returns (new commit rows, cosine of the committed
    candidate)."""
    B = base_ids.shape[0]
    col = spec.seed_len + pos  # (B,)
    probs = energies.masked_lm_probs(logits, token_mask, hyper["temperature"])
    top_probs, idxs = energies.topk_candidates(probs, token_mask,
                                               spec.candidate_k)
    clip_ids, clip_mask = assemble_clip_ids_substitute(
        base_ids[:, 1:spec.seq_len - 1], idxs, col - 1, tables["bridge_ids"],
        tables["bridge_lens"], bos_id=spec.clip_bos_id,
        eos_id=spec.clip_eos_id, pad_id=spec.clip_pad_id,
        clip_len=spec.clip_len)
    text_embeds = _encode_candidates(spec, clip, clip_ids, clip_mask,
                                     prefix_len, prefix_kvs)
    clip_probs, cosine = clip.similarity(image_embeds, text_embeds)
    final = energies.combine_scores(top_probs, clip_probs, hyper["alpha"],
                                    hyper["beta"])
    sel = torch.argmax(final, dim=1)[:, None]  # (B, 1)
    chosen = torch.gather(idxs, 1, sel)[:, 0]
    rows = torch.arange(B, device=commit_ids.device)
    new_ids = commit_ids.clone()
    new_ids[rows, col] = chosen.to(commit_ids.dtype)
    return new_ids, torch.gather(cosine, 1, sel)[:, 0]


def _fresh_logits(spec: EngineSpec, bert: BertForMaskedLM, ids: torch.Tensor,
                  pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask ``pos`` in every row; vocab logits at that slot only."""
    col = spec.seed_len + pos
    masked = ids.clone()
    masked[torch.arange(ids.shape[0], device=ids.device), col] = (
        spec.mask_token_id)
    hidden = bert.hidden(masked, pool_idx=col[:, None])  # (B, 1, H)
    return masked, bert.lm_head(hidden[:, 0])


def _token_mask_for(spec: EngineSpec, tables: Dict[str, torch.Tensor],
                    pos: torch.Tensor) -> torch.Tensor:
    """(B,) positions -> (B, V) mask: '.' only at the last slot."""
    return torch.where((pos == spec.sentence_len - 1)[:, None],
                       tables["mask_last"][None, :],
                       tables["mask_mid"][None, :])


def _sentence_logits(spec: EngineSpec, bert: BertForMaskedLM,
                     ids: torch.Tensor, first: int, count: int
                     ) -> torch.Tensor:
    """One BERT forward of ``ids`` as they are; vocab logits (B, count, V)
    at the sentence slots ``first`` .. ``first + count - 1``."""
    cols = spec.seed_len + first + torch.arange(count, device=ids.device)
    hidden = bert.hidden(ids, pool_idx=cols[None, :].expand(ids.shape[0], -1))
    return bert.lm_head(hidden)


def _iteration(spec: EngineSpec, bert: BertForMaskedLM, clip: CLIPModel,
               tables: Dict[str, torch.Tensor], hyper: Dict[str, float],
               image_embeds: torch.Tensor, ids: torch.Tensor, row,
               prefix_kvs: Optional[List]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep over a schedule row. single: ``row`` is (steps, B)
    positions on the device. span: ``row`` is (starts, sizes), two lists of
    Python ints. parallel: ``row`` is not read."""
    B = ids.shape[0]
    cos = torch.zeros(B, device=ids.device)

    def update(base_ids, commit_ids, pos, logits, token_mask, P):
        return _position_update(spec, clip, tables, hyper, image_embeds,
                                base_ids, commit_ids, pos, logits,
                                token_mask, P, prefix_kvs)

    def slot(j):
        return torch.full((B,), j, dtype=torch.long, device=ids.device)

    if spec.order_kind == "single":
        chunks = spec.prefix_chunks or ((0, row.shape[0]),)
        step = 0
        for P, n in chunks:
            for pos in row[step:step + n]:
                masked, logits = _fresh_logits(spec, bert, ids, pos)
                ids, cos = update(masked, masked, pos, logits,
                                  _token_mask_for(spec, tables, pos), P)
            step += n
        return ids, cos

    # span and parallel sweep every slot under one bound: the prompt-only
    # prefix, which holds whatever the order
    P0 = spec.prefix_chunks[0][0] if spec.prefix_chunks else 0

    if spec.order_kind == "span":
        for start, size in zip(*row):
            # mask the valid slots of the span, then ONE forward for all of
            # them: the logits of a later slot do not see the earlier
            # slot's commit (stale by design)
            ids = ids.clone()
            first = spec.seed_len + start
            ids[:, first:first + size] = spec.mask_token_id
            logits_span = _sentence_logits(spec, bert, ids, start, size)
            for j in range(size):
                pos = slot(start + j)
                ids, cos = update(ids, ids, pos, logits_span[:, j],
                                  _token_mask_for(spec, tables, pos), P0)
        return ids, cos

    if spec.order_kind == "parallel":
        base = ids  # candidates are built from the iteration-start rows
        # one UNMASKED forward, and the last slot's mask ('.' allowed) at
        # every position: the reference never updates the mask here
        logits_all = _sentence_logits(spec, bert, ids, 0, spec.sentence_len)
        mask_last = tables["mask_last"][None, :].expand(B, -1)
        for kk in range(spec.sentence_len):
            ids, cos = update(base, ids, slot(kk), logits_all[:, kk],
                              mask_last, P0)
        return ids, cos

    raise ValueError(f"unknown order kind {spec.order_kind!r}")


def run_generation(spec: EngineSpec, bert: BertForMaskedLM, clip: CLIPModel,
                   tables: Dict[str, torch.Tensor], hyper: Dict[str, float],
                   image_embeds: torch.Tensor, init_ids: torch.Tensor,
                   positions, span_sizes=None) -> Generation:
    """The whole multi-iteration generation. ``positions``: (I, steps, B)
    on the device for a single-kind schedule; (I, n_spans) span starts on
    the host, with ``span_sizes`` (I, n_spans) beside them, for the span
    order; (I, 1), unread, for the parallel order. Best tracking:
    strictly-greater update on each iteration's cosine, starting at 0."""
    # with one prefix chunk the shared prefix is BOS + prompt, constant for
    # the whole generation: its K/V are computed once here
    prefix_kvs = None
    chunks = spec.prefix_chunks
    if (chunks is not None and len(chunks) == 1
            and 2 <= chunks[0][0] < spec.clip_len - 1):
        P0 = chunks[0][0]
        pref_row, _ = assemble_clip_ids(
            init_ids[:, 1:spec.seq_len - 1], tables["bridge_ids"],
            tables["bridge_lens"], bos_id=spec.clip_bos_id,
            eos_id=spec.clip_eos_id, pad_id=spec.clip_pad_id,
            clip_len=spec.clip_len)
        prefix_kvs = clip.text_prefix_kvs(pref_row[:, :P0])
    B = init_ids.shape[0]
    ids = init_ids
    best_ids = init_ids
    best_cos = torch.zeros(B, device=init_ids.device)
    iter_ids, iter_cos = [], []
    rows = positions
    if spec.order_kind == "span":
        rows = [(starts.tolist(), sizes.tolist())
                for starts, sizes in zip(positions, span_sizes)]
    for row in rows:
        ids, cos = _iteration(spec, bert, clip, tables, hyper, image_embeds,
                              ids, row, prefix_kvs)
        improved = best_cos < cos
        best_cos = torch.where(improved, cos, best_cos)
        best_ids = torch.where(improved[:, None], ids, best_ids)
        iter_ids.append(ids)
        iter_cos.append(cos)
    return Generation(torch.stack(iter_ids), torch.stack(iter_cos), best_ids,
                      best_cos)
