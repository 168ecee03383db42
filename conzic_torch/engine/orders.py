"""Generation-order schedules as data.

Counterpart of ``conzic_tpu/engine/orders.py`` for the ``single``-kind
orders, where every step polishes one position from a fresh BERT forward:
sequential (arange), shuffle (one seeded permutation reused every
iteration) and random (``sentence_len`` uniform draws per iteration). The
same seeded ``RandomState`` gives the same schedule as the reference
package. The span and parallel orders are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Schedule:
    kind: str  # "single"
    positions: np.ndarray  # (iterations, steps)


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
    if order in ("span", "parallel"):
        raise NotImplementedError(f"order={order!r} is not ported yet")
    raise ValueError(f"unknown order {order!r}")
