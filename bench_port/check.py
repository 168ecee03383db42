"""Whether what the timed path served is right: the plain reference
(``bench_port.reference``) judges what the window's requests returned,
once the window has closed and the program is gone.

The readings; those named in the cell's ``limits/<cell>.json`` are
compared, each against its limit there (the cells compare all but
``commit_gap_mean``):

- ``image_embed_err``: the image tower and its projection, the widest
  relative L2 distance of an image embedding from the reference's;
- ``lm_gap_mean``: the proposer's masked-LM distribution and its top k,
  the mean over the sampled commits of how far, in nats at the LM
  temperature, the committed token lies below the reference's k-th
  candidate (0 inside the top k; infinite for a token the rules forbid at
  its slot);
- ``commit_gap_mean``: the bridge of the candidates into the matcher's
  rows, its text tower over them, the image match and the combined score,
  the mean over the sampled commits of how far the committed token's
  ``alpha * lm + beta * clip`` lies below the reference's best;
- ``commit_gap_step_median``: the same gaps, the median over the sampled
  steps of each step's mean. A step commits for every image of a
  request at once, and near-alike images tie alike: where bf16 tips one
  near-tie, it tips it for most of the batch, and that one step moves
  the mean over all commits by a run's whole margin; the median over
  steps reads the steps that did not tip;
- ``frame_errors``: rows whose [CLS], prompt and [SEP] differ from the
  reference's (exact);
- ``text_errors``: texts that differ from the reference's decoding of the
  served rows, every iteration's, the final and the best (exact);
- ``text_cos_err``: the image match as the user gets it, the widest
  distance of a served per-iteration cosine from the reference's cosine
  of that caption with that image (the text tower at the served rows;
  the cosines pick the best caption).

Each is taken over a sample drawn from the seed: the traffic's
``check_requests`` requests, with the last of the window among them, every
row of theirs, and ``check_steps`` of their Gibbs steps. The reference
follows the served captions step by step from their own states: each
sampled step is judged from the rows before it, which the served
iterations and the slot order give. The towers' pieces come from the
configuration's two families (``bench_port/families/``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from bench_port.reference import gibbs
from bench_port.reference.models import fp32_only


def relative_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """(N,) relative L2 distance of each row of ``got`` from ``want``'s."""
    return (torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1))


def best_index(cos: Sequence[float]) -> int:
    """The iteration whose caption is the best: the first that raised the
    cosine above every earlier one, starting from 0; -1 when none did."""
    best, at = 0.0, -1
    for i, c in enumerate(cos):
        if c > best:
            best, at = c, i
    return at


class Tally:
    """The values a check reads, by kind, and the readings made of them."""

    def __init__(self):
        self.values = {k: [] for k in ("image", "cos", "lm", "commit",
                                       "commit_step")}
        self.counts = {"frame": 0, "text": 0}

    def add(self, kind: str, values) -> None:
        self.values[kind].extend(np.asarray(torch.as_tensor(values).cpu(),
                                            np.float64).ravel())

    def count(self, kind: str, n: int) -> None:
        self.counts[kind] += n

    def readings(self) -> Dict[str, float]:
        def widest(k):
            return float(max(self.values[k], default=0.0))

        def mean(k):
            return float(np.mean(self.values[k])) if self.values[k] else 0.0

        return {
            "image_embed_err": widest("image"),
            "text_cos_err": widest("cos"),
            "lm_gap_mean": mean("lm"),
            "commit_gap_mean": mean("commit"),
            "commit_gap_step_median": (
                float(np.median(self.values["commit_step"]))
                if self.values["commit_step"] else 0.0),
            "frame_errors": float(self.counts["frame"]),
            "text_errors": float(self.counts["text"]),
        }


class Judge:
    """``families`` and ``vocab``: the proposer's and the matcher's family
    modules and vocabularies, by role ("lm", "match")."""

    def __init__(self, config: dict, traffic: dict, families: dict,
                 vocab: dict, weights: Dict[str, torch.Tensor], device):
        self.config, self.traffic, self.device = config, traffic, device
        self.families, self.vocab, self.weights = families, vocab, weights
        self.lm, self.match = self.references(None)
        self.text = self.lm.text
        self.init = np.asarray(self.text.init_row(traffic["prompt"],
                                                  traffic["sentence_len"]))
        self.seed_len = len(self.init) - traffic["sentence_len"] - 1

    def references(self, lowp):
        """The proposer's and the matcher's references in ``lowp``."""
        return tuple(self.families[r].reference(self.weights, self.config,
                                                self.vocab[r], lowp)
                     for r in ("lm", "match"))

    def pixels(self, pixel_seed: int) -> torch.Tensor:
        return self.families["match"].pixels(
            self.config, pixel_seed, self.traffic["images_per_request"],
            self.device)

    def sample(self, served: List, rng: np.random.Generator):
        """What is judged, drawn from ``rng``: the traffic's
        ``check_requests`` requests, the last one always among them, and
        ``check_steps`` (request, sample, iteration, step) of theirs."""
        t = self.traffic
        last = len(served) - 1
        others = rng.permutation(last)[:max(0, t["check_requests"] - 1)]
        requests = sorted({last, *(int(r) for r in others)})
        steps = [(r, s, i, j) for r in requests
                 for s in range(t["samples"]) for i in range(t["iterations"])
                 for j in range(t["sentence_len"])]
        picked = sorted(steps[int(x)] for x in
                        rng.permutation(len(steps))[:t["check_steps"]])
        return requests, picked

    def state(self, req, s: int, i: int, j: int):
        """(rows before step j of iteration i of sample s, the edited
        column, whether it is the last slot, the committed tokens)."""
        t = self.traffic
        ids = req.iter_ids[s]
        perm = gibbs.slot_order(t["order"], t["sentence_len"], t["samples"],
                                req.schedule_seed)[s]
        B = ids.shape[1]
        state = (ids[i - 1] if i else np.tile(self.init, (B, 1))).copy()
        done = self.seed_len + perm[:j]
        state[:, done] = ids[i][:, done]
        col = self.seed_len + int(perm[j])
        return (state, col, int(perm[j]) == t["sentence_len"] - 1,
                ids[i][:, col])

    def judge(self, served: List, rng: np.random.Generator
              ) -> Dict[str, float]:
        """The readings of what the program served, over :meth:`sample`."""
        tally = Tally()
        if not served:
            return tally.readings()
        requests, picked = self.sample(served, rng)
        masks = gibbs.token_masks(self.text, self.device)
        with torch.inference_mode(), fp32_only():
            for r in requests:
                req = served[r]
                img = self.match.image_embeds(self.pixels(req.pixel_seed))
                tally.add("image", relative_err(req.image_embeds.float(),
                                                img))
                self._judge_rows(req, img, tally)
                for (_, s, i, j) in (x for x in picked if x[0] == r):
                    state, col, last, committed = self.state(req, s, i, j)
                    self._gaps(tally, state, col, last, committed, img,
                               masks)
        return tally.readings()

    def control(self, served: List, rng: np.random.Generator, lowp: str
                ) -> Dict[str, float]:
        """The same readings, over the same sample, of the reference in
        ``lowp`` put in the program's place: its image embeddings and the
        token it commits at each sampled step from the served state. It
        decodes no text."""
        tally = Tally()
        if not served:
            return tally.readings()
        low_lm, low_match = self.references(lowp)
        requests, picked = self.sample(served, rng)
        masks = gibbs.token_masks(self.text, self.device)
        t = self.traffic
        with torch.inference_mode(), fp32_only():
            for r in requests:
                req = served[r]
                px = self.pixels(req.pixel_seed)
                img = self.match.image_embeds(px)
                img_low = low_match.image_embeds(px)
                tally.add("image", relative_err(img_low, img))
                for ids in req.iter_ids:
                    I, B, _ = ids.shape
                    rows = ids.reshape(I * B, -1)
                    ref_cos = gibbs.cosines(self.match, self.text, rows,
                                            img.repeat(I, 1))
                    low_cos = gibbs.cosines(low_match, self.text, rows,
                                            img_low.repeat(I, 1))
                    tally.add("cos", (low_cos - ref_cos).abs())
                for (_, s, i, j) in (x for x in picked if x[0] == r):
                    state, col, last, _ = self.state(req, s, i, j)
                    chosen = gibbs.choose_step(
                        low_lm, low_match, masks, state, col, last, img_low,
                        t["candidate_k"], t["lm_temperature"], t["alpha"],
                        t["beta"])
                    self._gaps(tally, state, col, last, chosen, img, masks)
        return tally.readings()

    def _gaps(self, tally, state, col, last, committed, img, masks) -> None:
        t = self.traffic
        j = gibbs.judge_step(
            self.lm, self.match, masks, state, col, last, committed, img,
            t["candidate_k"], t["lm_temperature"], t["alpha"], t["beta"])
        tally.add("commit", j.commit_gap)
        tally.add("commit_step", [np.mean(j.commit_gap)])
        tally.add("lm", j.lm_gap)

    def _judge_rows(self, req, img: torch.Tensor, tally) -> None:
        """Every served row: its frame, its cosine, its texts."""
        keep = np.ones(len(self.init), bool)
        keep[self.seed_len:self.seed_len + self.traffic["sentence_len"]] = 0
        for s, ids in enumerate(req.iter_ids):
            I, B, _ = ids.shape
            tally.count("frame", int(
                (ids[:, :, keep] != self.init[keep]).any(-1).sum()))
            ref_cos = gibbs.cosines(
                self.match, self.text, ids.reshape(I * B, -1),
                img.repeat(I, 1)).reshape(I, B).cpu().numpy()
            got = np.asarray(req.cosines[s][:I], np.float64)
            tally.add("cos", np.abs(got - ref_cos))
            texts = req.texts[s]
            want = [[self.text.decode(row) for row in it] for it in ids]
            for b in range(B):
                at = best_index([req.cosines[s][i][b] for i in range(I)])
                want_best = want[at][b] if at >= 0 else "None"
                bad = sum(texts[i][b] != want[i][b] for i in range(I))
                bad += texts[I][b] != want_best
                tally.count("text", int(bad))


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every reading that has a limit within it; one that is not finite
    fails."""
    values = {k: float(readings[k]) for k in limits}
    return all(math.isfinite(values[k]) and values[k] <= limit
               for k, limit in limits.items())
