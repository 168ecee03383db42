"""One Gibbs step of ConZIC, scored plainly.

At a caption slot: the proposer's masked-LM distribution at temperature
T, the stop-word and period rules, its top k; each candidate's caption
into the matcher's row; the matcher's text tower over every row; the
cosine with the image; ``alpha * lm + beta * softmax(matcher logits of
the cosines)`` over the k candidates, whose argmax is committed. The
proposer ``lm`` and the matcher ``match`` are the references of the
configuration's two tower families (``bench_port/families/``).

:func:`judge_step` scores the step a served caption took, from the
caption's state before it, and says how far the committed token lies below
the best: in the combined score, and in the masked-LM logits below the k-th
candidate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

ROW_BLOCK = 2048  # text-tower rows per pass of the reference


def slot_order(order: str, sentence_len: int, samples: int,
               schedule_seed: int) -> List[np.ndarray]:
    """The slots each sample visits in an iteration, in turn. "shuffle":
    one permutation a sample, drawn by ``RandomState.shuffle`` from the
    request's schedule seed, the samples drawing in turn, kept for every
    iteration; "sequential": left to right."""
    rng = np.random.RandomState(schedule_seed)
    out = []
    for _ in range(samples):
        perm = np.arange(sentence_len, dtype=np.int32)
        if order == "shuffle":
            rng.shuffle(perm)
        elif order != "sequential":
            raise ValueError(f"the reference follows the shuffle and "
                             f"sequential orders, not {order!r}")
        out.append(perm)
    return out


def token_masks(text, device) -> torch.Tensor:
    """(2, V) float: row 0 the caption's middle slots, row 1 its last;
    ``text``: the proposer's text rules."""
    V = len(text.vocab)
    m = np.zeros((2, V), np.float32)
    for i in range(V):
        m[0, i] = text.allowed(i, last_slot=False)
        m[1, i] = text.allowed(i, last_slot=True)
    return torch.from_numpy(m).to(device)


def text_embeds(match, rows: Sequence[Sequence[int]],
                n_valid: Sequence[int], device) -> torch.Tensor:
    out = []
    for a in range(0, len(rows), ROW_BLOCK):
        ids = torch.tensor(rows[a:a + ROW_BLOCK], device=device)
        n = torch.tensor(n_valid[a:a + ROW_BLOCK], device=device)
        out.append(match.text_embeds(ids, n))
    return torch.cat(out)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def cosines(match, text, captions: np.ndarray, image: torch.Tensor
            ) -> torch.Tensor:
    """(N, S) proposer rows and (N, D) reference image embeddings -> (N,)
    cosines of the captions' matcher rows."""
    rows, n = zip(*(match.row(text, r) for r in captions))
    emb = text_embeds(match, rows, n, image.device)
    return (unit(emb) * unit(image)).sum(-1)


@dataclasses.dataclass
class StepJudgement:
    commit_gap: np.ndarray  # (B,) best combined score - the committed one
    lm_gap: np.ndarray  # (B,) nats the committed token lies below the k-th


def _scores(lm, match, masks: torch.Tensor, state: np.ndarray, col: int,
            last_slot: bool, image: torch.Tensor, k: int,
            temperature: float, alpha: float, beta: float,
            extra: Optional[np.ndarray] = None):
    """One step scored by ``lm`` and ``match`` at column ``col`` of
    ``state`` (B, S): per row the candidates (the top k, then
    ``extra[b]`` when it is not among them and the rules allow it), their
    combined scores (the matcher's softmax over the k, a further
    candidate scored with the k's normaliser), and the masked-LM logits
    (B, V)."""
    dev = image.device
    B = state.shape[0]
    text = lm.text
    logits = lm.logits(state, col)  # (B, V)
    probs = torch.softmax(logits / temperature, dim=-1) * masks[
        1 if last_slot else 0]
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_i, probs_np = top_i.cpu().numpy(), probs.cpu().numpy()
    cands = []
    rows, n_valid = [], []
    for b in range(B):
        c = [int(t) for t in top_i[b]]
        if extra is not None:
            t = int(extra[b])
            if t not in c and text.allowed(t, last_slot):
                c.append(t)
        cands.append(c)
        for t in c:
            row = state[b].copy()
            row[col] = t
            r, n = match.row(text, row)
            rows.append(r)
            n_valid.append(n)
    emb = unit(text_embeds(match, rows, n_valid, dev))
    img = unit(image)
    finals, at = [], 0
    for b, c in enumerate(cands):
        z = match.logits((emb[at:at + len(c)] @ img[b]).double())
        at += len(c)
        match_p = torch.exp(z - torch.logsumexp(z[:k], dim=0)).cpu().numpy()
        lm_p = probs_np[b, c].astype(np.float64)
        finals.append(alpha * lm_p + beta * match_p)
    return cands, finals, logits.cpu().numpy(), top_i


def judge_step(lm, match, masks: torch.Tensor, state: np.ndarray,
               col: int, last_slot: bool, committed: np.ndarray,
               image: torch.Tensor, k: int, temperature: float, alpha: float,
               beta: float) -> StepJudgement:
    """``state`` (B, S): the rows before the step; ``col``: the edited
    column; ``committed`` (B,) the token the served caption put there;
    ``image`` (B, D) the reference's image embeddings.

    A committed token outside the reference's top k is scored beside them:
    its masked-LM probability, and its CLIP softmax taken with the k's
    normaliser. A token the rules forbid there reads an infinite gap."""
    cands, finals, logits, top_i = _scores(
        lm, match, masks, state, col, last_slot, image, k, temperature,
        alpha, beta, extra=committed)
    B = state.shape[0]
    commit_gap, lm_gap = np.zeros(B), np.zeros(B)
    for b in range(B):
        t = int(committed[b])
        if t not in cands[b]:  # forbidden at this slot
            commit_gap[b] = lm_gap[b] = np.inf
            continue
        commit_gap[b] = finals[b][:k].max() - finals[b][cands[b].index(t)]
        kth = logits[b, top_i[b, -1]]
        lm_gap[b] = max(0.0, float(kth - logits[b, t]) / temperature)
    return StepJudgement(commit_gap, lm_gap)


def choose_step(lm, match, masks: torch.Tensor, state: np.ndarray,
                col: int, last_slot: bool, image: torch.Tensor, k: int,
                temperature: float, alpha: float, beta: float
                ) -> np.ndarray:
    """(B,) the token ``lm`` and ``match`` commit at the step: the best
    combined score over their own top k."""
    cands, finals, _, _ = _scores(lm, match, masks, state, col, last_slot,
                                  image, k, temperature, alpha, beta)
    return np.array([c[int(np.argmax(f))] for c, f in zip(cands, finals)])
