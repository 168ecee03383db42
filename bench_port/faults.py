"""Faults planted in the program's timed path, for showing that the
correctness check fails them: the CPU tests plant them at tiny widths,
``bench_port.control --faults`` at a cell's own size on the card.

Each takes ``patch(owner, name, value)``, which replaces an attribute for
the caller's scope (pytest's ``monkeypatch.setattr``, or :func:`planted`).
"""

from __future__ import annotations

import contextlib


def state_unchanged(patch) -> None:
    """A Gibbs step that returns its rows as they were."""
    import torch
    from conzic_torch.engine import gibbs

    def update(spec, clip, tables, hyper, image_embeds, base_ids,
               commit_ids, *rest):
        B = commit_ids.shape[0]
        zero = torch.zeros(B, device=commit_ids.device)
        return commit_ids.clone(), zero, zero

    patch(gibbs, "_position_update", update)


def half_batch(patch) -> None:
    """The generation runs the first half of the rows, and the other half
    takes its results."""
    from conzic_torch.engine import gibbs, sampler

    real = gibbs.run_generation

    def half(spec, bert, clip, tables, hyper, image_embeds, init_ids,
             positions, *rest, **kw):
        h = max(1, image_embeds.shape[0] // 2)
        g = real(spec, bert, clip, tables, hyper, image_embeds[:h],
                 init_ids[:h], positions[..., :h], *rest, **kw)

        def fill(x, axis):
            reps = [1] * x.dim()
            reps[axis] = 2
            return x.repeat(*reps).narrow(axis, 0, image_embeds.shape[0])

        return gibbs.Generation(fill(g.iter_ids, 1), fill(g.iter_cos, 1),
                                fill(g.iter_ctl, 1), fill(g.best_ids, 0),
                                fill(g.best_cos, 0))

    patch(sampler, "run_generation", half)


def token_altered(patch) -> None:
    """Each committed token replaced by the next id where it is made."""
    import torch
    from conzic_torch.engine import gibbs

    real = gibbs._position_update

    def update(spec, clip, tables, hyper, image_embeds, base_ids,
               commit_ids, pos, *rest):
        new_ids, cos, ctl = real(spec, clip, tables, hyper, image_embeds,
                                 base_ids, commit_ids, pos, *rest)
        rows = torch.arange(new_ids.shape[0], device=new_ids.device)
        col = spec.seed_len + pos
        new_ids = new_ids.clone()
        new_ids[rows, col] += 1
        return new_ids, cos, ctl

    patch(gibbs, "_position_update", update)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  token_altered)}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted for the scope of the ``with``."""
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    FAULTS[name](patch)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
