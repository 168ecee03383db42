"""BERT-id -> matcher-id bridge: candidate sentence assembly on the device.

Counterpart of ``conzic_tpu/text/bridge.py``. The table (built once per
vocabulary pair, in numpy) holds the matcher tokenizer's ids of every BERT
wordpiece taken as a standalone word; candidate rows are then assembled
from it with tensor ops, so no candidate goes through a host decode and
re-tokenize. ``##`` continuation pieces are bridged as if they started a
word, exactly as in the reference package. A row is BOS, the pieces, EOS,
then padding: CLIP's BPE; a tokenizer with no start token (SigLIP's
Unigram, ``bos_token_id`` None) starts the row with the pieces.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from conzic_torch.text.vocab import token_body
from conzic_torch.text.wordpiece import WordPieceTokenizer


@dataclasses.dataclass
class BridgeTable:
    """Per-BERT-token matcher pieces.

    ids:  (V, M) int32 — matcher ids, zero-padded.
    lens: (V,)  int32 — number of valid pieces (0 for specials).
    bos_id: the start token, None where the matcher's rows have none.
    """

    ids: np.ndarray
    lens: np.ndarray
    bos_id: Optional[int]
    eos_id: int
    pad_id: int
    max_pieces: int


def build_bridge_table(wp: WordPieceTokenizer, bpe) -> BridgeTable:
    """``bpe``: the matcher's tokenizer (``CLIPBPETokenizer`` or
    ``SiglipTokenizer``). The table is as wide as the longest piece
    sequence in the vocabulary, so no token is truncated."""
    special = set(wp.special_tokens)
    all_pieces = {}
    for tok, i in wp.vocab.items():
        if tok in special:
            continue
        body = token_body(tok)
        if body:
            all_pieces[i] = bpe.encode_word_ids(body)
    width = max((len(p) for p in all_pieces.values()), default=1)
    ids = np.zeros((wp.vocab_size, width), np.int32)
    lens = np.zeros((wp.vocab_size,), np.int32)
    for i, pieces in all_pieces.items():
        ids[i, : len(pieces)] = pieces
        lens[i] = len(pieces)
    return BridgeTable(ids=ids, lens=lens, bos_id=bpe.bos_token_id,
                       eos_id=bpe.eos_token_id, pad_id=bpe.pad_token_id,
                       max_pieces=width)


def _lead(bos_id: Optional[int]) -> int:
    """Slots before the first piece: 1 for a BOS, else 0."""
    return 0 if bos_id is None else 1


def _frame(val: torch.Tensor, total: torch.Tensor, j: torch.Tensor, *,
           bos_id: Optional[int], eos_id: int, pad_id: int, clip_len: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[BOS] + pieces + EOS, padded: with a BOS (lead 1) slot 0 holds it;
    slot j holds ``val`` (piece j - lead) while j - lead < total, EOS at
    min(lead + total, clip_len - 1), PAD after it. ``total`` broadcasts
    against ``j`` (the last axis)."""
    lead = _lead(bos_id)
    jw = j - lead
    eos_pos = torch.clamp(lead + total, max=clip_len - 1)
    out = torch.where(j == eos_pos, eos_id,
                      torch.where((jw >= 0) & (jw < total) & (j < eos_pos),
                                  val, pad_id))
    if lead:
        out = torch.where(j == 0, bos_id, out)
    return out.to(torch.int32), (j <= eos_pos).to(torch.int32)


def assemble_clip_ids(bert_ids: torch.Tensor, bridge_ids: torch.Tensor,
                      bridge_lens: torch.Tensor, *, bos_id: Optional[int],
                      eos_id: int,
                      pad_id: int, clip_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., P) BERT ids (caption words, no [CLS]/[SEP]) -> (clip_ids,
    attention_mask), each (..., clip_len) int32. Pieces that overflow the
    context are dropped."""
    batch_shape = bert_ids.shape[:-1]
    flat = bert_ids.reshape(-1, bert_ids.shape[-1]).long()
    R, P = flat.shape
    M = bridge_ids.shape[-1]
    pieces = bridge_ids[flat].reshape(R, P * M)  # (R, P*M)
    lens = bridge_lens[flat]  # (R, P)
    ends = torch.cumsum(lens, dim=1)
    offs = ends - lens
    total = ends[:, -1:]  # (R, 1)
    j = torch.arange(clip_len, device=flat.device)
    jw = j - _lead(bos_id)
    # word covering piece jw: the number of words ending at or before it
    p_j = (ends[:, None, :] <= jw[None, :, None]).sum(-1)  # (R, clip_len)
    p_j = torch.clamp(p_j, max=P - 1)
    m_j = torch.clamp(jw[None, :] - torch.gather(offs, 1, p_j), 0, M - 1)
    val = torch.gather(pieces, 1, p_j * M + m_j)
    ids, mask = _frame(val, total, j, bos_id=bos_id, eos_id=eos_id,
                       pad_id=pad_id, clip_len=clip_len)
    return (ids.reshape(*batch_shape, clip_len),
            mask.reshape(*batch_shape, clip_len))


def assemble_clip_ids_substitute(
    base_inner: torch.Tensor, cand_ids: torch.Tensor, pos: torch.Tensor,
    bridge_ids: torch.Tensor, bridge_lens: torch.Tensor, *,
    bos_id: Optional[int], eos_id: int, pad_id: int, clip_len: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k candidate rows of one Gibbs step: the base rows (B, P) with
    ``cand_ids`` (B, k) substituted at column ``pos`` (B,). The base piece
    stream (without the edited word) is assembled once per image row and
    each candidate is composed as prefix pieces | candidate pieces |
    shifted suffix pieces. Returns (clip_ids, attention_mask), each
    (B, k, clip_len) int32, identical to :func:`assemble_clip_ids` on the
    materialised candidate rows."""
    B, P = base_inner.shape
    M = bridge_ids.shape[-1]
    dev = base_inner.device
    base = base_inner.long()
    cand = cand_ids.long()
    col = torch.arange(P, device=dev)[None, :]
    base_lens = torch.where(col == pos[:, None], 0, bridge_lens[base])
    ends = torch.cumsum(base_lens, dim=1)  # (B, P)
    offs = ends - base_lens
    total_base = ends[:, -1]  # (B,)
    off0 = torch.gather(ends, 1, pos[:, None].long())[:, 0]  # (B,)

    # the base stream without the edited word, flattened to clip_len pieces
    t = torch.arange(clip_len, device=dev)
    p_t = (ends[:, None, :] <= t[None, :, None]).sum(-1)  # (B, clip_len)
    p_t = torch.clamp(p_t, max=P - 1)
    m_t = torch.clamp(t[None, :] - torch.gather(offs, 1, p_t), 0, M - 1)
    stream = torch.gather(bridge_ids[base].reshape(B, P * M), 1,
                          p_t * M + m_t)
    stream = torch.where(t[None, :] < total_base[:, None], stream, 0)

    cand_pieces = bridge_ids[cand]  # (B, k, M)
    cand_lens = bridge_lens[cand][:, :, None]  # (B, k, 1)
    jw = (t - _lead(bos_id))[None, None, :]  # (1, 1, clip_len)
    o = off0[:, None, None]
    in_cand = (jw >= o) & (jw < o + cand_lens)
    idx_base = jw - torch.where(jw >= o + cand_lens, cand_lens, 0)
    k = cand.shape[1]
    base_val = torch.gather(
        stream[:, None, :].expand(B, k, clip_len), 2,
        torch.clamp(idx_base, 0, clip_len - 1).expand(B, k, clip_len))
    cand_val = torch.gather(
        cand_pieces, 2, torch.clamp(jw - o, 0, M - 1).expand(B, k, clip_len))
    val = torch.where(in_cand, cand_val, base_val)
    total = total_base[:, None, None] + cand_lens  # (B, k, 1)
    return _frame(val, total, t, bos_id=bos_id, eos_id=eos_id,
                  pad_id=pad_id, clip_len=clip_len)
