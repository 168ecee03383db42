"""Determinism: the counterpart of ``conzic_tpu/runtime/seeding.py``.

The schedules of the Gibbs orders come from one numpy ``RandomState`` per
run, so seeding it reproduces the reference package's orders byte for
byte. ``torch`` is seeded too, as the reference's own ``utils.set_seed``
does, for any sampling a caller adds.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> np.random.RandomState:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # every device's generator, CUDA's included
    return np.random.RandomState(seed)
