"""The JAX trainer's optimizer, optax's chain, on lists of tensors.

Counterpart of ``tools/train_tiny.py``'s

    optax.chain(optax.clip_by_global_norm(1.0),
                optax.adamw(optax.warmup_cosine_decay_schedule(
                    0.0, lr, warmup, max(steps, warmup + 1)),
                    weight_decay=1e-4, mask=ndim >= 2))

with optax's semantics: the schedule is read at the count before the step
(the first update has lr 0), the clip is ``g`` below the norm and ``g /
norm * max_norm`` at or above it, Adam's moments are bias-corrected and
its eps is added outside the square root, and the decay ``wd * p`` is
added to Adam's direction before the learning rate scales it, on the
masked parameters only. Every update runs over the whole parameter list
with ``torch._foreach_*`` ops: a step is some twenty launches, not some
per tensor.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def warmup_cosine_decay(count: int, peak: float, warmup: int,
                        decay_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0.0, peak, warmup,
    decay_steps)`` at ``count``, in float32 as optax evaluates it: a linear
    ramp from 0 over ``warmup`` steps, then a cosine from ``peak`` to 0 over
    the remaining ``decay_steps - warmup``."""
    f32 = np.float32
    if count < warmup:
        frac = f32(1) - f32(count) / f32(warmup)
        return float((f32(0) - f32(peak)) * frac + f32(peak))
    decay = decay_steps - warmup
    c = f32(min(count - warmup, decay))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay),
                                         dtype=f32))
    return float(f32(peak) * cosine)


# the JAX trainer's chain: clip_by_global_norm(1.0), adamw's defaults and
# weight_decay=1e-4
MAX_NORM = 1.0
B1, B2, EPS = 0.9, 0.999, 1e-8
WEIGHT_DECAY = 1e-4


class AdamW:
    """optax's clip-then-AdamW chain over ``params`` (a list of leaf
    tensors, updated in place by :meth:`step`). ``decay[i]`` says whether
    parameter i takes weight decay (the JAX trainer's mask: ndim >= 2 in
    the flax layout). ``decay_steps`` is the schedule's length: the JAX
    trainer's ``max(steps, warmup + 1)``."""

    def __init__(self, params: List[torch.Tensor], decay: Sequence[bool],
                 lr: float, warmup: int, decay_steps: int):
        if len(decay) != len(params):
            raise ValueError(f"{len(decay)} decay flags for {len(params)} "
                             f"parameters")
        self.params = params
        self.lr, self.warmup, self.decay_steps = lr, warmup, decay_steps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self._decayed = [i for i, d in enumerate(decay) if d]

    def lr_at(self, count: int) -> float:
        return warmup_cosine_decay(count, self.lr, self.warmup,
                                   self.decay_steps)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update from ``grads`` (one per parameter); returns the
        global norm of the gradients before the clip (a 0-d tensor on the
        parameters' device, not read here)."""
        g, norm = clip_by_global_norm(grads, MAX_NORM)
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, g, alpha=1 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - B2)
        t = self.count + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(t))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(update, denom)
        if self._decayed:
            torch._foreach_add_([update[i] for i in self._decayed],
                                [self.params[i] for i in self._decayed],
                                alpha=WEIGHT_DECAY)
        torch._foreach_mul_(update, -self.lr_at(self.count))
        torch._foreach_add_(self.params, update)
        self.count = t
        return norm


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of every
    element's square, as a 0-d fp32 tensor."""
    norms = torch._foreach_norm(list(tensors))
    return torch.linalg.vector_norm(torch.stack(norms).float())


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``optax.clip_by_global_norm``: ``g`` where the global norm is below
    ``max_norm``, else ``g / norm * max_norm``, chosen on the device (no
    host sync; ``g / 1 * 1`` is ``g`` exactly). Returns the clipped list
    and the norm."""
    norm = global_norm(grads)
    below = norm < max_norm
    out = torch._foreach_div(list(grads), torch.where(below, 1.0, norm))
    torch._foreach_mul_(out, torch.where(below, 1.0, max_norm))
    return out, norm
