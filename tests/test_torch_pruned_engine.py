"""The port's pruned and hybrid tiers == ``conzic_tpu``'s, caption ids byte
for byte, in free captioning.

One tiny fp32 pair (``init_mode="proper"`` towers) captions two images at
k=16, sentence_len 5, 2 iterations. Each case runs the reference once and
the port twice: on the reference's pruned-tier tables carried across (the
two packages' towers build them equal only to the last bits) and on its own
tables. Both must give the reference's ids (``_torch_port.PrunedPair``).
Cases: the proxy in the sequential, shuffle and parallel orders, with
``mask_impl="compare"`` and with ``clip_window`` at clip_len 77 (equal to
the run without a window); the hybrid, also under ``topk_mode="approx"``.
The factorized stage-1 is in ``tests/test_torch_pruned_factorized.py``,
controlled pruned runs and ``trained_tiny/`` in
``tests/test_torch_pruned_control.py``, the README's tiers through the
demo command line in ``tests/test_torch_pruned_cli.py``: each file builds
one reference captioner and compiles one program a case, so the cases are
spread to keep each file near a minute.
"""

import numpy as np
import pytest

from _torch_port import (  # noqa: F401  (one_torch_thread: a fixture)
    PrunedPair,
    jax_tiny_captioner,
    one_torch_thread,
)

_PAIR = []
RUN = dict(max_len=5, top_k=16, max_iter=2)


def _pair() -> PrunedPair:
    if not _PAIR:
        _PAIR.append(PrunedPair(jax_tiny_captioner()))
    return _PAIR[0]


def _embeds(batch=2):
    dim = _pair().jax.clip_model.config.projection_dim
    return np.random.RandomState(1).randn(batch, dim).astype(np.float32)


@pytest.mark.parametrize("order,cfg_kw", [
    ("sequential", {}),
    ("shuffle", {}),
    ("parallel", {}),
    ("sequential", dict(mask_impl="compare")),
    ("parallel", dict(mask_impl="compare")),
])
def test_proxy_tier_matches_reference(order, cfg_kw):
    _pair().check(dict(prune_k=4, **cfg_kw), _embeds(), order=order, **RUN)


def test_clip_window_at_77_matches_reference_and_the_full_width():
    """Rows of this size fit 24 columns: the windowed encode runs, and
    gives the ids of the full width."""
    pair = _pair()
    kw = dict(prune_k=4, clip_len=77)
    _, windowed, _ = pair.check(dict(kw, clip_window=24), _embeds(),
                                order="sequential", **RUN)
    _, full, _ = pair.check(kw, _embeds(), order="sequential", **RUN)
    np.testing.assert_array_equal(windowed.iter_ids, full.iter_ids)
    np.testing.assert_array_equal(windowed.best_ids, full.best_ids)


@pytest.mark.parametrize("topk_mode", ["exact", "approx"])
def test_hybrid_tier_matches_reference(topk_mode):
    """The last iteration scores all 16 candidates with the exact top-k
    over the pruned state: under approx too, whose tier it resets."""
    want, got, _ = _pair().check(
        dict(prune_k=4, prune_final_exact=True, topk_mode=topk_mode),
        _embeds(), order="shuffle", **RUN)
    assert len(got.gen_texts_list) == RUN["max_iter"] + 1



