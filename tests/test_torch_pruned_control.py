"""The port's controlled pruned tiers == ``conzic_tpu``'s, caption ids byte
for byte.

A tiny fp32 pair (``init_mode="proper"`` towers) runs sentiment and POS
table control (gamma 5.0) in a pruned tier with the control-aware stage-1
rank (``prune_stage1_ctl`` "auto") and without it ("off"): sentiment in the
factorized tier with the proxy pre-cut (the rank at both cuts), POS in the
proxy tier. Each case runs the port on the reference's tables and on its
own (``_torch_port.PrunedPair``). ``trained_tiny/`` in a pruned tier is in
``test_torch_pruned_cli.py``.
"""

import numpy as np
import pytest

from _torch_port import (  # noqa: F401  (one_torch_thread: a fixture)
    PrunedPair,
    jax_tiny_captioner,
    one_torch_thread,
)

_PAIRS = {}
RUN = dict(max_len=5, top_k=16, max_iter=2, gamma=5.0)


def _pair() -> PrunedPair:
    if not _PAIRS:
        _PAIRS["random"] = PrunedPair(jax_tiny_captioner())
    return _PAIRS["random"]


def _embeds(batch=2):
    dim = _pair().jax.clip_model.config.projection_dim
    return np.random.RandomState(1).randn(batch, dim).astype(np.float32)


SENTIMENT_TIER = dict(prune_k=4, prune_stage1="factorized",
                      prune_stage1_layers=1, prune_stage1_precut=8)


@pytest.mark.parametrize("ctl_rank", ["auto", "off"])
@pytest.mark.parametrize("ctl,tier,run_kw", [
    ("sentiment", SENTIMENT_TIER, dict(order="shuffle", negative=True)),
    ("pos", dict(prune_k=4), dict(order="sequential")),
])
def test_controlled_pruned_tier_matches_reference(ctl, tier, run_kw,
                                                  ctl_rank):
    want, got, _ = _pair().check(dict(tier, prune_stage1_ctl=ctl_rank),
                                 _embeds(), ctl=ctl, **RUN, **run_kw)
    np.testing.assert_array_equal(got.iter_ctl, np.asarray(want.iter_ctl))

