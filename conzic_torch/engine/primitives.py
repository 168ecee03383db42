"""Standalone sampling primitive of the generation toolbox.

Counterpart of ``conzic_tpu/engine/primitives.py``. ``generate_step`` picks
one token per batch row from a logits tensor: top-k sampling, sampling from
the full categorical, or greedy argmax, with the same precedence (``top_k``
overrides ``sample``, which overrides greedy). The Gibbs engine does not
call it (its proposals come from ``energies.masked_lm_probs`` and
``energies.topk_candidates``); it is part of the public surface. An explicit
``torch.Generator`` takes the place of the reference's PRNG key.
"""

from __future__ import annotations

from typing import Optional

import torch


def generate_step(out: torch.Tensor, gen_idx: int,
                  generator: Optional[torch.Generator] = None,
                  temperature: Optional[float] = None, top_k: int = 0,
                  sample: bool = False) -> torch.Tensor:
    """Pick one token id per batch row from ``out[:, gen_idx]``.

    out: (B, S, V) logits. ``generator`` is required when ``top_k > 0`` or
    ``sample``; it must live on ``out``'s device. ``temperature`` divides
    the logits before any mode. ``top_k > 0`` samples from the categorical
    over the top-k logits; ``sample`` (with ``top_k == 0``) from the full
    categorical; otherwise the argmax. Returns (B,) int32 ids."""
    logits = out[:, gen_idx].float()
    if temperature is not None:
        logits = logits / torch.full_like(logits, temperature)
    if top_k > 0:
        if generator is None:
            raise ValueError("top_k sampling requires a generator")
        values, idxs = torch.topk(logits, top_k, dim=-1)
        draw = torch.multinomial(torch.softmax(values, dim=-1), 1,
                                 generator=generator)
        idx = torch.gather(idxs, 1, draw)[:, 0]
    elif sample:
        if generator is None:
            raise ValueError("sample=True requires a generator")
        idx = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                generator=generator)[:, 0]
    else:
        idx = torch.argmax(logits, dim=-1)
    return idx.to(torch.int32)
