"""The README's pruned tiers through the port's demo command line ==
``conzic_tpu``'s.

``conzic_torch.api.demo.main`` with the README's hybrid and flagship flags
on ``trained_tiny/`` (both towers through ``--lm_model`` /
``--match_model``, on the CPU, fp32) writes the reference demo's log lines,
caption lines included, each package building its own pruned-tier tables.
And ``trained_tiny/`` through ``Captioner.from_tiny_dir`` in the factorized
tier (2 of 4 layers) with the proxy pre-cut, caption ids byte for byte, the
port on the reference's tables and on its own (``_torch_port.PrunedPair``).
"""

import os

import numpy as np
import pytest

from _torch_port import (  # noqa: F401  (one_torch_thread: a fixture)
    TRAINED_TINY,
    PrunedPair,
    one_torch_thread,
)
from test_torch_cli import EXAMPLES, TINY, _in_dir, _lines

from conzic_tpu.api import demo as jax_demo
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_torch.api import demo
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.sampler import Captioner


# the README's tiers; the flagship's stage-1 takes 2 of trained_tiny's 4
# text-tower layers where the README's full-width towers take 6 of 12
README_TIERS = {
    "hybrid": ["--prune_k", "5", "--prune_final_exact"],
    "flagship": ["--prune_k", "3", "--prune_stage1", "factorized",
                 "--prune_stage1_layers", "2", "--prune_stage1_precut", "32",
                 "--topk_mode", "approx", "--topk_recall", "0.90"],
}


@pytest.mark.parametrize("tier", list(README_TIERS))
def test_readme_tiers_through_the_demo_match_reference(tier, tmp_path,
                                                       monkeypatch):
    argv = TINY + README_TIERS[tier] + [
        "--candidate_k", "48", "--samples_num", "1", "--order", "sequential",
        "--caption_img_path", os.path.join(EXAMPLES, "girl.jpg")]
    want = _in_dir(tmp_path / "jax", monkeypatch, jax_demo.main, argv)
    got = _in_dir(tmp_path / "port", monkeypatch, demo.main, argv)
    ours = _lines(os.path.join(got, "logger"))
    assert ours == _lines(os.path.join(want, "logger"))
    assert sum(x.startswith("final caption:") for x in ours) == 1


def test_trained_tiny_factorized_precut_matches_reference():
    """On trained weights, each package through its own checkpoint reader,
    with the port's own tables too (the pair checks both), 2 of the 4
    text-tower layers behind a proxy pre-cut to 8."""
    jc = JaxCaptioner.from_tiny_dir(JaxConfig(dtype="float32", verbose=False),
                                    TRAINED_TINY)
    pair = PrunedPair(jc, lambda attn_impl: Captioner.from_tiny_dir(
        ConzicConfig(dtype="float32", verbose=False, attn_impl=attn_impl),
        TRAINED_TINY, device="cpu"))
    dim = jc.clip_model.config.projection_dim
    embeds = np.random.RandomState(1).randn(3, dim).astype(np.float32)
    pair.check(
        dict(prune_k=3, prune_stage1="factorized", prune_stage1_layers=2,
             prune_stage1_precut=8), embeds,
        order="sequential", max_len=6, top_k=16, max_iter=2)
