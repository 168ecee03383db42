"""Generation-order schedules as data.

Counterpart of ``conzic_tpu/engine/orders.py``. An order is a precomputed
schedule of one of three kinds:

- ``single``: every step polishes one position from a fresh BERT forward.
  Sequential (arange), shuffle (one seeded permutation reused every
  iteration) and random (``sentence_len`` uniform draws per iteration).
- ``span``: spans of ``SPAN_LEN`` slots; a whole span is masked and polished
  slot by slot from ONE BERT forward, whose logits are stale for the later
  slots by design.
- ``parallel``: every position is updated from one unmasked forward.

The same seeded ``RandomState`` gives the same schedule as the reference
package; the span and parallel schedules draw nothing from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


SPAN_LEN = 2


@dataclasses.dataclass
class Schedule:
    kind: str  # "single" | "span" | "parallel"
    # single: (iterations, steps) positions; span: (iterations, n_spans)
    # span starts; parallel: (iterations, 1), unused
    positions: np.ndarray
    # span only: (iterations, n_spans) valid slots of each span
    span_sizes: Optional[np.ndarray] = None


def build_schedule(order: str, sentence_len: int, num_iterations: int,
                   rng: np.random.RandomState) -> Schedule:
    L, I = sentence_len, num_iterations
    if order == "sequential":
        return Schedule("single", np.tile(np.arange(L, dtype=np.int32), (I, 1)))
    if order == "shuffle":
        perm = np.arange(L, dtype=np.int32)
        rng.shuffle(perm)  # one permutation, reused every iteration
        return Schedule("single", np.tile(perm, (I, 1)))
    if order == "random":
        pos = rng.randint(0, L, size=(I, L)).astype(np.int32)
        return Schedule("single", pos)
    if order == "span":
        starts = np.arange(0, L, SPAN_LEN, dtype=np.int32)
        sizes = np.minimum(L - starts, SPAN_LEN).astype(np.int32)
        return Schedule("span", np.tile(starts, (I, 1)),
                        np.tile(sizes, (I, 1)))
    if order == "parallel":
        return Schedule("parallel", np.zeros((I, 1), np.int32))
    raise ValueError(f"unknown order {order!r}")
