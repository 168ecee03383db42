"""The Gibbs polishing engine, free and controlled captioning in every order.

Counterpart of ``conzic_tpu/engine/gibbs.py``. For each iteration and each
position of the schedule: mask the position, take BERT's top-k proposals at
that slot only, assemble the k candidate CLIP rows through the bridge table,
encode them with the CLIP text tower (row chunks over the prompt prefix's
cached K/V), score ``alpha * lm + beta * clip`` (``+ gamma * ctl`` and the
repeat penalty under control), commit the argmax, and track the
best-by-cosine caption. The span order polishes the slots of a span from
one BERT forward and the parallel order every slot from one unmasked
forward (engine/orders.py). The reference package's ``lax.scan``s and
``lax.map`` are Python loops here, and its ``lax.cond`` on whether a chunk
fits ``clip_window`` a branch on one value read back from the device.

The pruned tiers (``spec.prune_k``) score only the stage-1 survivors with
the full text tower: stage 1 is the bag-of-embeddings proxy or the
factorized scorer (the first layers of the text tower and a calibrated
projection, :class:`~conzic_torch.models.clip.TruncatedTextTower`), after
an optional pre-cut, each cut ranked by the surrogate cosine or by the
whole combined score. ``spec.final_exact`` makes the last iteration a
full-parity sweep over the pruned state.

A bidirectional matcher (SigLIP, ``spec.bidirectional``) attends every
position of a row and pools the last, so no part of a candidate row can be
computed once for all: its rows are assembled at the fixed ``clip_len`` and
encoded whole, chunk by chunk (:func:`_encode_full_rows`), with no prompt
K/V, no prefix form and no window. The candidates' matcher logits go into
the same softmax over k.

The exact host modes run in the same loop. ``bridge_mode="exact"`` builds
the candidate CLIP rows by the reference's decode -> re-tokenize
(:func:`host_bridge_fn`), and ``ctl_mode="exact"`` scores every decoded
candidate with the reference's sentence-level pipeline
(:func:`host_ctl_fn`): each is a plain Python call at its Gibbs step, one
device-to-host copy of the (B, k, S-2) candidate ids and one host-to-device
copy of the result. The reference needs a second engine for them,
``conzic_tpu/engine/host_exact.py``, only because a TPU runtime lacked host
callbacks; that module is folded in here and has no counterpart. Every
other step stays on the device, and the host reads nothing else back until
the generation ends.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from conzic_torch import energies
from conzic_torch.eval.pos_eval import batch_texts_pos_analysis
from conzic_torch.eval.sentiment_eval import batch_texts_sentiment_scores
from conzic_torch.models import siglip
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel, TruncatedTextTower
from conzic_torch.runtime.profiling import span
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
    clip_bos_id: Optional[int]  # None: the matcher's rows have no BOS
    clip_eos_id: int
    clip_pad_id: int
    # ((prefix_len, n_steps), ...): the position sweep cut into chunks whose
    # steps share a lower bound on the candidates' common CLIP prefix; its
    # K/V are computed at image-batch width. None disables.
    prefix_chunks: Optional[Tuple[Tuple[int, int], ...]] = None
    clip_row_chunk: int = 0  # candidate rows per text-tower pass; 0 = all
    clip_pad_to: int = 0  # pad candidate rows to this length; 0 = off
    order_kind: str = "single"  # single | span | parallel
    ctl: Optional[str] = None  # None | "sentiment" | "pos"
    negative: bool = False  # sentiment polarity
    # control energies: "table" (device tables) or "exact" (host_ctl)
    ctl_mode: str = "table"
    # candidate CLIP rows from host_bridge, each encoded in full
    exact_bridge: bool = False
    # the pruned tiers (engine/sampler.py resolves them from the config):
    # stage 1 keeps prune_k of the k candidates for the full tower
    prune_k: Optional[int] = None
    final_exact: bool = False  # the last iteration scores all k
    prune_stage1: str = "proxy"  # proxy | factorized
    stage1_layers: int = 2  # the factorized stage-1's depth
    stage1_precut: int = 0  # factorized: first cut k -> this; 0 = off
    stage1_precut_mode: str = "proxy"  # proxy | tower
    stage1_precut_layers: int = 1  # the tower pre-cut's depth
    stage1_ctl: bool = False  # rank stage-1 cuts by the combined score
    clip_window: int = 0  # encode over this many columns when rows fit
    topk_chunk: int = 2048  # exact_topk_2stage's block width
    mask_impl: str = "gather"  # gather | compare (banned-id lists)
    # the matcher's text tower attends every position (SigLIP): candidate
    # rows run whole, with no prompt K/V, padding or window, whatever
    # prefix_chunks, clip_pad_to and clip_window say
    bidirectional: bool = False


def _decode(decoder, inner: torch.Tensor) -> List[str]:
    """(B, k, S-2) candidate ids on the device -> B*k caption texts (one
    device-to-host copy)."""
    B, k, P = inner.shape
    return decoder.batch_decode(inner.reshape(B * k, P).cpu().numpy(),
                                skip_special_tokens=True)


def host_bridge_fn(decoder, bpe, clip_len: int):
    """``bridge_mode="exact"``: decode every candidate row and re-tokenize
    it, as the reference does (``bpe.batch_encode(texts,
    max_length=clip_len, pad_to_max=True)``). The callable maps (B, k, S-2)
    ids to (B, k, clip_len) CLIP ids and attention mask on their device."""
    def host_bridge(inner: torch.Tensor):
        B, k, _ = inner.shape
        ids, mask = bpe.batch_encode(_decode(decoder, inner),
                                     max_length=clip_len, pad_to_max=True)
        both = torch.from_numpy(np.stack([ids, mask]).astype(np.int32))
        both = both.reshape(2, B, k, clip_len).to(inner.device)
        return both[0], both[1]
    return host_bridge


def host_ctl_fn(decoder, ctl: str, negative: bool,
                template: Optional[Sequence]):
    """``ctl_mode="exact"``: decode every candidate row and score the
    sentence with the reference's pipeline (eval/sentiment_eval.py,
    eval/pos_eval.py). The callable maps (B, k, S-2) ids to (B, k) scores
    on their device, the Python float scores cast to float32 at the
    end."""
    def host_ctl(inner: torch.Tensor) -> torch.Tensor:
        B, k, _ = inner.shape
        texts = _decode(decoder, inner)
        if ctl == "sentiment":
            scores = batch_texts_sentiment_scores(texts, negative=negative)
        else:
            _, scores = batch_texts_pos_analysis(texts, template)
        scores = np.asarray(scores, np.float32).reshape(B, k)
        return torch.from_numpy(scores).to(inner.device)
    return host_ctl


class HostCalls(NamedTuple):
    """The host callables of the exact modes (None when unused)."""
    bridge: Optional[Callable] = None  # host_bridge_fn's
    ctl: Optional[Callable] = None  # host_ctl_fn's


class Generation(NamedTuple):
    iter_ids: torch.Tensor  # (I, B, S) rows after each iteration
    iter_cos: torch.Tensor  # (I, B) cosine of the last committed candidate
    iter_ctl: torch.Tensor  # (I, B) its control score (0 without control)
    best_ids: torch.Tensor  # (B, S)
    best_cos: torch.Tensor  # (B,)


def row_chunk_width(B: int, k: int, row_chunk: int) -> int:
    """The candidates an image of one text-tower row chunk holds: all k
    when the B x k rows fit ``row_chunk`` (0 = all), else the largest
    divisor of k that keeps a chunk within it (at least 1)."""
    if not row_chunk or B * k <= row_chunk:
        return k
    kc = max(1, row_chunk // B)
    while k % kc:
        kc -= 1
    return kc


def _encode_full_rows(spec: EngineSpec, match, ids: torch.Tensor
                      ) -> torch.Tensor:
    """(B, k, L) candidate rows of a bidirectional matcher -> (B*k, D):
    every row whole, in chunks of at most ``spec.clip_row_chunk`` rows."""
    B, k, L = ids.shape
    kc = row_chunk_width(B, k, spec.clip_row_chunk)
    embs = []
    for c in range(0, k, kc):
        with span("towers.match_text"):
            rows = ids[:, c:c + kc].reshape(-1, L)
            embs.append(siglip.encode_full_rows(match, rows).reshape(
                B, kc, -1))
    return torch.cat(embs, dim=1).reshape(B * k, -1)


def _encode_candidates(spec: EngineSpec, clip: CLIPModel,
                       clip_ids: torch.Tensor, clip_mask: torch.Tensor,
                       prefix_len: int, prefix_kvs: Optional[List] = None,
                       s1: Optional[Tuple[TruncatedTextTower,
                                          torch.Tensor]] = None
                       ) -> torch.Tensor:
    """(B, k, L) candidate rows -> (B*k, D) text embeddings: exact
    prefix-K/V reuse when ``prefix_len >= 2``, row chunks of at most
    ``spec.clip_row_chunk`` rows, and under ``spec.clip_window`` a chunk
    whose rows all end inside the window encoded over the window's columns
    only (exact: the tower is causal and pools at the first EOS).

    ``s1`` = (truncated tower, wcal): the factorized stage-1 encode, each
    chunk's pooled rows in fp32 times the calibrated projection ``wcal``
    (H, D). The truncated tower reads the first layers of the full tower's
    prefix K/V. A bidirectional matcher's rows go to
    :func:`_encode_full_rows`."""
    if spec.bidirectional:
        return _encode_full_rows(spec, clip, clip_ids)
    if spec.clip_pad_to > clip_ids.shape[-1]:
        extra = spec.clip_pad_to - clip_ids.shape[-1]
        clip_ids = torch.nn.functional.pad(clip_ids, (0, extra),
                                           value=spec.clip_pad_id)
        clip_mask = torch.nn.functional.pad(clip_mask, (0, extra))
    B, k, L = clip_ids.shape
    P = prefix_len if 2 <= prefix_len < spec.clip_len - 1 else 0

    def encode(ids_bk, mask_bk):  # (B, kc, S) -> (B, kc, D)
        kc, S = ids_bk.shape[1], ids_bk.shape[2]
        if s1 is not None:
            tower, wcal = s1
            if P:
                kvs = prefix_kvs
                if kvs is None:
                    _, kvs = tower(ids_bk[:, 0, :P], return_kvs=True)
                pooled = tower(ids_bk[:, :, P:].reshape(B * kc, S - P),
                               mask_bk[:, :, P:].reshape(B * kc, S - P),
                               pos_offset=P, prefix_kvs=kvs)
            else:
                pooled = tower(ids_bk.reshape(B * kc, S),
                               mask_bk.reshape(B * kc, S))
            return (pooled.float() @ wcal).reshape(B, kc, -1)
        if P and prefix_kvs is not None:
            emb = clip.encode_text_suffix(prefix_kvs, P, ids_bk[:, :, P:],
                                          mask_bk[:, :, P:])
        elif P:
            emb = clip.encode_text_shared_prefix(
                ids_bk[:, 0, :P], ids_bk[:, :, P:], mask_bk[:, :, P:])
        else:
            emb = clip.encode_text(ids_bk.reshape(B * kc, S),
                                   mask_bk.reshape(B * kc, S))
        return emb.reshape(B, kc, -1)

    W = spec.clip_window
    if W and (W >= L or W <= P + 1):
        W = 0  # no narrower than the width, wider than the prefix

    def enc(ids_bk, mask_bk):
        with span("towers.text_chunk"):
            # the reference's lax.cond: one read of the chunk's fit a chunk
            if W and not bool(mask_bk[:, :, W:].any()):
                return encode(ids_bk[:, :, :W], mask_bk[:, :, :W])
            return encode(ids_bk, mask_bk)

    kc = row_chunk_width(B, k, spec.clip_row_chunk)
    embs = [enc(clip_ids[:, c:c + kc], clip_mask[:, c:c + kc])
            for c in range(0, k, kc)]
    return torch.cat(embs, dim=1).reshape(B * k, -1)


def _cand_rows(base_ids: torch.Tensor, col: torch.Tensor,
               idxs: torch.Tensor) -> torch.Tensor:
    """(B, k, S) candidate rows: the base row with each candidate of
    ``idxs`` (B, k) at its column ``col`` (B,)."""
    onehot = (torch.arange(base_ids.shape[1], device=base_ids.device)
              [None, :] == col[:, None])  # (B, S)
    return torch.where(onehot[:, None, :], idxs[:, :, None],
                       base_ids[:, None, :].long())


def _take(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, keep, axis=1)`` for (B, k) or (B, k, L) x."""
    if x.dim() == 3:
        keep = keep[:, :, None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, keep)


def _prune(spec: EngineSpec, clip: CLIPModel, tables: Dict[str, torch.Tensor],
           hyper: Dict[str, float], image_embeds: torch.Tensor,
           base_ids: torch.Tensor, col: torch.Tensor, idxs: torch.Tensor,
           top_probs: torch.Tensor, assemble: Callable,
           prefix_kvs: Optional[List]):
    """The pruned tiers' stage 1, in the reference's order: the optional
    pre-cut (by the proxy or by a shallower tower), then the factorized or
    proxy cut to ``spec.prune_k``, each ranked by the surrogate cosine or,
    under ``spec.stage1_ctl``, by the whole combined score. Returns the
    survivors' (ids, probabilities) and, for the factorized stage-1, their
    already assembled CLIP rows (ids, mask, prefix bound), which stage 2
    reuses."""
    B = base_ids.shape[0]
    k = idxs.shape[1]

    def rank(surr, idxs_k, probs_k):
        if not spec.stage1_ctl or spec.ctl is None:
            return surr
        return energies.stage1_ctl_rank(
            surr, probs_k, idxs_k, _cand_rows(base_ids, col, idxs_k),
            ctl=spec.ctl, negative=spec.negative, seq_len=spec.seq_len,
            logit_scale=clip.logit_scale, alpha=hyper["alpha"],
            beta=hyper["beta"], gamma=hyper["gamma"],
            senti=tables.get("senti"), pos_table=tables.get("pos"),
            template=tables.get("template"),
            bridge_lens=tables["bridge_lens"])

    def cut(scores, idxs_k, probs_k, width):
        return energies.top_k(rank(scores, idxs_k, probs_k), width)[1]

    def proxy(idxs_k):
        return energies.prune_proxy_scores(
            tables["word_embeds"], base_ids, col, idxs_k, image_embeds,
            spec.seq_len, exclude_slot=spec.order_kind == "parallel")

    if spec.prune_stage1 != "factorized":
        keep = cut(proxy(idxs), idxs, top_probs, spec.prune_k)
        return _take(idxs, keep), _take(top_probs, keep), None

    def s1_scores(ids_a, mask_a, pl, layers, wcal):
        """(B, k', L) assembled rows -> (B, k') truncated-tower cosines."""
        tower = TruncatedTextTower(clip.text_model, layers)
        emb = _encode_candidates(spec, clip, ids_a, mask_a, pl, prefix_kvs,
                                 s1=(tower, wcal)).reshape(B, ids_a.shape[1],
                                                           -1)
        # the text side over its norm + 1e-6, the image side over its norm
        return torch.einsum("bkd,bd->bk", energies.unit(emb, 1e-6),
                            energies.unit(image_embeds.float()))

    assembled = None
    if spec.stage1_precut and spec.stage1_precut < k:
        if spec.stage1_precut_mode == "tower":
            ids_all, mask_all, pl = assemble(idxs)
            keep0 = cut(s1_scores(ids_all, mask_all, pl,
                                  spec.stage1_precut_layers,
                                  tables["stage1_wcal_pc"]),
                        idxs, top_probs, spec.stage1_precut)
            assembled = (_take(ids_all, keep0), _take(mask_all, keep0), pl)
        else:
            keep0 = cut(proxy(idxs), idxs, top_probs, spec.stage1_precut)
        idxs, top_probs = _take(idxs, keep0), _take(top_probs, keep0)
    ids_all, mask_all, pl = assembled or assemble(idxs)
    keep = cut(s1_scores(ids_all, mask_all, pl, spec.stage1_layers,
                         tables["stage1_wcal"]),
               idxs, top_probs, spec.prune_k)
    return (_take(idxs, keep), _take(top_probs, keep),
            (_take(ids_all, keep), _take(mask_all, keep), pl))


def _position_update(spec: EngineSpec, clip: CLIPModel,
                     tables: Dict[str, torch.Tensor], hyper: Dict[str, float],
                     image_embeds: torch.Tensor, base_ids: torch.Tensor,
                     commit_ids: torch.Tensor, pos: torch.Tensor,
                     logits: torch.Tensor, token_mask: torch.Tensor,
                     banned: Optional[torch.Tensor], prefix_len: int,
                     prefix_kvs: Optional[List], host: HostCalls
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score k candidates for ``pos`` (B,) and commit the argmax.
    ``base_ids``: the rows the candidates are built from; ``commit_ids``:
    the rows the winner is written into (they differ only in the parallel
    order). ``banned``: the banned-id rows of ``token_mask`` under
    ``mask_impl="compare"``, else None. Under ``spec.prune_k`` only the
    stage-1 survivors reach the full tower. Returns (new commit rows,
    cosine and control score of the committed candidate)."""
    B = base_ids.shape[0]
    k = spec.candidate_k
    col = spec.seed_len + pos  # (B,)

    def assemble(idxs_k):
        """(B, k') candidates -> (CLIP ids, mask, prefix bound)."""
        if spec.exact_bridge:
            inner_k = _cand_rows(base_ids, col, idxs_k)[:, :,
                                                        1:spec.seq_len - 1]
            # the table's prefix bound does not hold here
            return (*host.bridge(inner_k), 0)
        return (*assemble_clip_ids_substitute(
            base_ids[:, 1:spec.seq_len - 1], idxs_k, col - 1,
            tables["bridge_ids"], tables["bridge_lens"],
            bos_id=spec.clip_bos_id, eos_id=spec.clip_eos_id,
            pad_id=spec.clip_pad_id, clip_len=spec.clip_len), prefix_len)

    with span("engine.candidates"):
        probs = energies.masked_lm_probs(logits, token_mask,
                                         hyper["temperature"])
        top_probs, idxs = energies.topk_candidates(
            probs, token_mask, k, chunk=spec.topk_chunk, banned_ids=banned)
        assembled = None
        if spec.prune_k is not None and spec.prune_k < k:
            idxs, top_probs, assembled = _prune(
                spec, clip, tables, hyper, image_embeds, base_ids, col, idxs,
                top_probs, assemble, prefix_kvs)
            k = spec.prune_k
        cand = inner = None
        if spec.ctl is not None:
            # (B, k, S) candidate rows and their caption span (no CLS / SEP)
            cand = _cand_rows(base_ids, col, idxs)
            inner = cand[:, :, 1:spec.seq_len - 1]
        clip_ids, clip_mask, prefix_len = assembled or assemble(idxs)
    text_embeds = _encode_candidates(spec, clip, clip_ids, clip_mask,
                                     prefix_len, prefix_kvs)
    with span("engine.commit"):
        clip_probs, cosine = clip.similarity(image_embeds, text_embeds)

        ctl_probs = penalty = None
        ctl_score = torch.zeros((B, k), device=cosine.device)
        if spec.ctl is not None and spec.ctl_mode == "exact":
            ctl_score = host.ctl(inner)
        elif spec.ctl == "sentiment":
            ctl_score = energies.sentiment_scores(cand, tables["senti"],
                                                  negative=spec.negative)
        elif spec.ctl == "pos":
            word_valid = (tables["bridge_lens"][inner] > 0).int()
            ctl_score = energies.pos_accuracy(inner, tables["pos"],
                                              tables["template"], word_valid)
        if spec.ctl == "sentiment":
            ctl_probs = energies.sentiment_probs(ctl_score)
            penalty = energies.repeat_penalty(idxs, cand)
        elif spec.ctl == "pos":
            ctl_probs = energies.pos_probs(ctl_score)
        final = energies.combine_scores(
            top_probs, clip_probs, hyper["alpha"], hyper["beta"],
            ctl_probs=ctl_probs, gamma=hyper["gamma"], penalty=penalty)
        sel = torch.argmax(final, dim=1)[:, None]  # (B, 1)
        chosen = torch.gather(idxs, 1, sel)[:, 0]
        rows = torch.arange(B, device=commit_ids.device)
        new_ids = commit_ids.clone()
        new_ids[rows, col] = chosen.to(commit_ids.dtype)
        return (new_ids, torch.gather(cosine, 1, sel)[:, 0],
                torch.gather(ctl_score, 1, sel)[:, 0])


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
                    pos: torch.Tensor):
    """(B,) positions -> ((B, V) mask, (B, nb) banned ids or None): '.'
    only at the last slot. Under ``mask_impl="compare"`` the banned-id
    rows are picked by the same rule as the mask, so the two agree."""
    last = (pos == spec.sentence_len - 1)[:, None]
    mask = torch.where(last, tables["mask_last"][None, :],
                       tables["mask_mid"][None, :])
    if spec.mask_impl != "compare":
        return mask, None
    return mask, torch.where(last, tables["banned_last"][None, :],
                             tables["banned_mid"][None, :])


def _mask_last_pair(spec: EngineSpec, tables: Dict[str, torch.Tensor],
                    B: int):
    """The parallel order's (mask, banned) pair: the last slot's, '.'
    allowed, at every position (the reference never updates it there)."""
    mask = tables["mask_last"][None, :].expand(B, -1)
    if spec.mask_impl != "compare":
        return mask, None
    return mask, tables["banned_last"][None, :].expand(B, -1)


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
               prefix_kvs: Optional[List], host: HostCalls
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sweep over a schedule row. single: ``row`` is (steps, B)
    positions on the device. span: ``row`` is (starts, sizes), two lists of
    Python ints. parallel: ``row`` is not read. Returns the rows, and the
    cosine and control score of the last committed candidates."""
    B = ids.shape[0]
    cos = torch.zeros(B, device=ids.device)
    ctl = torch.zeros(B, device=ids.device)

    def update(base_ids, commit_ids, pos, logits, masks, P):
        return _position_update(spec, clip, tables, hyper, image_embeds,
                                base_ids, commit_ids, pos, logits, *masks,
                                P, prefix_kvs, host)

    def slot(j):
        return torch.full((B,), j, dtype=torch.long, device=ids.device)

    if spec.order_kind == "single":
        chunks = spec.prefix_chunks or ((0, row.shape[0]),)
        step = 0
        for P, n in chunks:
            for pos in row[step:step + n]:
                with span("engine.step"):
                    with span("towers.lm"):
                        masked, logits = _fresh_logits(spec, bert, ids, pos)
                    ids, cos, ctl = update(
                        masked, masked, pos, logits,
                        _token_mask_for(spec, tables, pos), P)
            step += n
        return ids, cos, ctl

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
            with span("towers.lm"):
                logits_span = _sentence_logits(spec, bert, ids, start, size)
            for j in range(size):
                pos = slot(start + j)
                with span("engine.step"):
                    ids, cos, ctl = update(
                        ids, ids, pos, logits_span[:, j],
                        _token_mask_for(spec, tables, pos), P0)
        return ids, cos, ctl

    if spec.order_kind == "parallel":
        base = ids  # candidates are built from the iteration-start rows
        # one UNMASKED forward, and the last slot's mask ('.' allowed) at
        # every position: the reference never updates the mask here
        with span("towers.lm"):
            logits_all = _sentence_logits(spec, bert, ids, 0,
                                          spec.sentence_len)
        masks = _mask_last_pair(spec, tables, B)
        for kk in range(spec.sentence_len):
            with span("engine.step"):
                ids, cos, ctl = update(base, ids, slot(kk),
                                       logits_all[:, kk], masks, P0)
        return ids, cos, ctl

    raise ValueError(f"unknown order kind {spec.order_kind!r}")


def run_generation(spec: EngineSpec, bert: BertForMaskedLM, clip: CLIPModel,
                   tables: Dict[str, torch.Tensor], hyper: Dict[str, float],
                   image_embeds: torch.Tensor, init_ids: torch.Tensor,
                   positions, span_sizes=None,
                   host: HostCalls = HostCalls()) -> Generation:
    """The whole multi-iteration generation. ``positions``: (I, steps, B)
    on the device for a single-kind schedule; (I, n_spans) span starts on
    the host, with ``span_sizes`` (I, n_spans) beside them, for the span
    order; (I, 1), unread, for the parallel order. ``host`` carries the
    exact modes' callables. Best tracking: strictly-greater update on each
    iteration's cosine, starting at 0. Under ``spec.final_exact`` (with
    ``prune_k``) the last iteration scores all k candidates with the exact
    top-k, over the pruned iterations' rows and the same prefix K/V: the
    hybrid tier."""
    # with one prefix chunk the shared prefix is BOS + prompt, constant for
    # the whole generation: its K/V are computed once here
    prefix_kvs = None
    chunks = spec.prefix_chunks
    if (chunks is not None and len(chunks) == 1
            and 2 <= chunks[0][0] < spec.clip_len - 1
            and not spec.exact_bridge and not spec.bidirectional):
        P0 = chunks[0][0]
        with span("engine.prefix_kv"):
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
    iter_ids, iter_cos, iter_ctl = [], [], []
    rows = positions
    if spec.order_kind == "span":
        rows = [(starts.tolist(), sizes.tolist())
                for starts, sizes in zip(positions, span_sizes)]
    last_spec = spec
    if spec.final_exact and spec.prune_k is not None:
        last_spec = dataclasses.replace(spec, prune_k=None, final_exact=False)
    for i, row in enumerate(rows):
        with span("engine.iteration"):
            ids, cos, ctl = _iteration(
                last_spec if i == len(rows) - 1 else spec, bert, clip,
                tables, hyper, image_embeds, ids, row, prefix_kvs, host)
        improved = best_cos < cos
        best_cos = torch.where(improved, cos, best_cos)
        best_ids = torch.where(improved[:, None], ids, best_ids)
        iter_ids.append(ids)
        iter_cos.append(cos)
        iter_ctl.append(ctl)
    return Generation(torch.stack(iter_ids), torch.stack(iter_cos),
                      torch.stack(iter_ctl), best_ids, best_cos)
