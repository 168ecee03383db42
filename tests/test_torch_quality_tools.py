"""The port's quality studies (``conzic_torch/tools/``) against the
reference's ``tools/`` on the same inputs: the cell-key grammar,
``run_cell`` on the same tiny fp32 towers (the reference's parameters
carried over as numpy, its pruned-tier tables too), and the metrics of
``trained_quality_cells``, ``control_efficacy`` and
``factorized_fidelity``. The reference's tools are imported by path, as
``tests/test_bench_gate.py`` imports ``bench``.
"""

import itertools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import (  # noqa: F401  (one_torch_thread: a fixture)
    carry_prune_tables,
    jax_tiny_captioner,
    one_torch_thread,
    port_captioner,
)
from conzic_torch.tools import control_efficacy as port_ce
from conzic_torch.tools import factorized_fidelity as port_ff
from conzic_torch.tools import trained_quality_cells as port_tq
from conzic_torch.tools import validate_pruning as port_vp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import control_efficacy as ref_ce  # noqa: E402
import factorized_fidelity as ref_ff  # noqa: E402
import trained_quality_cells as ref_tq  # noqa: E402
import validate_pruning as ref_vp  # noqa: E402


def test_cell_key_equals_the_reference_over_a_grid():
    n = 0
    for (order, ctl, mode, fe, quant, n_img, clip_len, seed, s1, pct, pc,
         pc_pct, cr) in itertools.product(
            ("sequential", "shuffle"), (None, "pos"), ("exact", "approx"),
            (False, True), ("none", "int8", "int8_all"), (4, 32),
            (24, 77), (0, 9100), ("proxy", "factorized"), (17, 50),
            (0, 24), (0, 17), (False, True)):
        kw = dict(order=order, ctl=ctl, prune_k=3, topk_mode=mode,
                  recall=0.9, final_exact=fe, quant=quant, n_images=n_img,
                  clip_len=clip_len, seed=seed, stage1=s1, stage1_pct=pct,
                  precut=pc, precut_tower_pct=pc_pct, ctl_rank=cr)
        assert port_vp.cell_key(**kw) == ref_vp.cell_key(**kw), kw
        n += 1
    assert n == 3 * 2 ** 12


def test_bench_gate_head_is_a_cell_key():
    """``conzic_torch.bench.gate_head`` builds the grammar's order."""
    import conzic_torch.bench as bench

    saved = {k: getattr(bench, k) for k in (
        "PRUNE", "STAGE1", "STAGE1_PRECUT", "STAGE1_PRECUT_MODE", "CTL",
        "PRUNE_FINAL_EXACT", "QUANT")}
    try:
        bench.PRUNE, bench.STAGE1, bench.STAGE1_PRECUT = 3, "factorized", 24
        bench.STAGE1_PRECUT_MODE, bench.CTL = "tower", "pos"
        bench.PRUNE_FINAL_EXACT, bench.QUANT = True, "int8"
        bench.EFFECTIVE.update(stage1_pct=50, precut_tower_pct=17,
                               quant="int8")
        assert bench.gate_head() == port_vp.cell_key(
            ctl="pos", prune_k=3, stage1="factorized", stage1_pct=50,
            precut=24, precut_tower_pct=17, ctl_rank=True,
            final_exact=True, quant="int8")
    finally:
        for k, v in saved.items():
            setattr(bench, k, v)
        bench.EFFECTIVE.clear()


_PAIR = []


def _pair():
    if not _PAIR:
        ref = jax_tiny_captioner()
        _PAIR.append((ref, port_captioner(ref, dtype="float32",
                                          verbose=False)))
    return _PAIR[0]


RUN = dict(sentence_len=5, iters=2, k=16)


@pytest.mark.parametrize("ctl,prune_k,final_exact", [
    (None, 4, False),
    (None, 4, True),
    ("sentiment", 4, False),
])
def test_run_cell_equals_the_reference(ctl, prune_k, final_exact):
    ref, port = _pair()
    embeds = np.random.RandomState(5).randn(
        2, ref.clip_model.config.projection_dim).astype(np.float32)
    want = ref_vp.run_cell(ref, jnp.asarray(embeds), order="sequential",
                           ctl=ctl, prune_k=prune_k, final_exact=final_exact,
                           **RUN)
    carry_prune_tables(ref, port)
    got = port_vp.run_cell(port, embeds, order="sequential", ctl=ctl,
                           prune_k=prune_k, final_exact=final_exact, **RUN)
    assert set(got) == set(want)
    assert got["caption_exact"] == want["caption_exact"]
    assert got["token_agreement"] == want["token_agreement"]
    assert abs(got["best_cosine_delta"] - want["best_cosine_delta"]) <= 1e-5


def test_attr_recall_equals_the_reference():
    from conzic_torch.data.synthetic import build_dataset as port_dataset
    from conzic_tpu.data.synthetic import build_dataset as ref_dataset

    _, caps, ref_scenes = ref_dataset(12, seed=9000)
    _, port_caps, port_scenes = port_dataset(12, seed=9000)
    assert port_caps == caps
    rng = np.random.RandomState(0)
    for trial in range(4):
        # the true captions with some of their words dropped
        texts = [" ".join(w for w in c.split() if rng.rand() > 0.3 * trial)
                 for c in caps]
        assert port_tq.attr_recall(texts, port_scenes) == \
            ref_tq.attr_recall(texts, ref_scenes)


CAPTIONS = [
    "image of a nice red circle on a blue background .",
    "image of a small white square with a green triangle .",
    "a bad ugly star , i hate it",
    "image of a cute big cross and a lovely circle",
    "",
    "image of image of a a a",
]


def test_control_efficacy_metrics_equal_the_reference():
    assert port_ce.WORLD_TEMPLATE == ref_ce.WORLD_TEMPLATE
    assert port_ce.sentiment_metrics(CAPTIONS) == \
        ref_ce.sentiment_metrics(CAPTIONS)
    for template in (port_ce.WORLD_TEMPLATE,
                     [["DET"], ["ADJ", "NOUN"], "NOUN", ""]):
        assert port_ce.pos_metrics(CAPTIONS, template) == \
            ref_ce.pos_metrics(CAPTIONS, template)
    per_image = [CAPTIONS[:2], CAPTIONS[2:4], CAPTIONS[4:]]
    assert port_ce.diversity_metrics(per_image) == \
        ref_ce.diversity_metrics(per_image)


def test_fit_calibration_equals_the_reference():
    rng = np.random.RandomState(3)
    pooled = rng.randn(96, 24)
    target = pooled @ rng.randn(24, 16) + 0.1 * rng.randn(96, 16)
    for l2 in (1e-3, 1.0):
        got = port_ff.fit_calibration(pooled, target, l2)
        np.testing.assert_array_equal(
            got, ref_ff.fit_calibration(pooled, target, l2))
        assert got.dtype == np.float32


def test_trained_jobs_map_approx_to_the_exact_point():
    """The reference's jobs, keyed as the port runs them: no +approx key,
    and jobs that share an exact key run once."""
    jobs = port_tq.exact_jobs(ref_tq.LADDER + ref_tq.FACTORIZED
                              + ref_tq.CASCADE)
    keys = [port_vp.cell_key(ctl=ctl, prune_k=pk, topk_mode=mode,
                             final_exact=fe, n_images=n, clip_len=cl,
                             stage1=s1, stage1_pct=round(100 * layers / 4),
                             precut=pc)
            for (pk, mode, _, fe, ctl, cl, n, s1, layers, pc, _, _) in jobs]
    assert all("+approx" not in k for k in keys)
    assert len(set(keys)) == len(keys) == len(set(jobs))
    assert port_tq.LADDER == ref_tq.LADDER
    assert port_tq.FACTORIZED == ref_tq.FACTORIZED
    assert port_tq.CASCADE == ref_tq.CASCADE
    # prune5 at approx 0.90, approx 0.95 and exact: one job
    ladder = port_tq.exact_jobs(ref_tq.LADDER)
    assert len(ladder) == 10
    assert sum(j[0] == 5 and not j[3] and j[5] == 24 for j in ladder) == 1
