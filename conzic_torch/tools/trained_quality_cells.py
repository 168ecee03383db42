"""Trained-weights quality cells: the counterpart of the reference's
``tools/trained_quality_cells.py``. Re-measures the published pruned-ladder
operating points on the tiny SEMANTIC checkpoints (``trained_tiny/``,
written by ``conzic_torch.train.tiny`` or the JAX trainer) over HELD-OUT
scenes of ``data/synthetic.py``, and writes them into the ``trained``
section of ``records_torch/PRUNING_MATRIX.json``, which
``conzic_torch.bench``'s quality gate prefers.

Beyond the standard metrics each cell records, per side:
  - best_cos_full / best_cos_pruned: the absolute best-of-run cosine,
  - attr_recall_full / attr_recall_pruned: the share of each scene's
    colour and shape words present in its best caption.

The reference's jobs with the approximate stage-1 top-k run the exact
top-k in the port (the reference's ``approx_max_k`` is exact off the
TPU): they are keyed as the exact operating point, and jobs that then
share a key run once.

Usage:
  python -m conzic_torch.tools.trained_quality_cells --ladder
  python -m conzic_torch.tools.trained_quality_cells --prune_k 3 \
      --topk_mode exact --prune_stage1 factorized --stage1_precut 32
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from conzic_torch.tools import (
    device_label,
    divert_cpu_output,
    tool_device,
    write_record,
)
from conzic_torch.tools.validate_pruning import (
    MATRIX_PATH,
    cell_key,
    run_cell,
    session_tag,
)

# the reference's published ladder: (prune_k, topk_mode, recall,
# final_exact, ctl, clip_len, n_images[, stage1, stage1_layers[, precut]]);
# clip_len=24 cells at n32, long-context at n16
LADDER = [
    (3, "approx", 0.90, False, None, 24, 32),
    (5, "approx", 0.90, False, None, 24, 32),
    (5, "approx", 0.95, False, None, 24, 32),
    (5, "exact", 0.95, False, None, 24, 32),
    (2, "approx", 0.90, False, None, 24, 32),
    (3, "approx", 0.90, True, None, 24, 32),
    (5, "approx", 0.95, True, None, 24, 32),
    (3, "approx", 0.90, False, "sentiment", 24, 32),
    (3, "approx", 0.90, False, "pos", 24, 32),
    (10, "approx", 0.95, False, None, 77, 16),
    (20, "exact", 0.95, False, None, 77, 16),
    (10, "approx", 0.95, True, None, 77, 16),
]

# the factorized stage-1 points: layer counts of the 4-layer trained tower
# (cell keys record the depth PERCENT: fact25 / fact50)
FACTORIZED = [
    (3, "approx", 0.90, False, None, 24, 32, "factorized", 2),
    (3, "approx", 0.90, False, None, 24, 32, "factorized", 1),
    (5, "approx", 0.95, False, None, 24, 32, "factorized", 2),
    (3, "approx", 0.90, True, None, 24, 32, "factorized", 2),
    (3, "approx", 0.90, False, "sentiment", 24, 32, "factorized", 2),
    (3, "approx", 0.90, False, "pos", 24, 32, "factorized", 2),
    (10, "approx", 0.95, False, None, 77, 16, "factorized", 2),
]

# the cascade (proxy pre-cut k -> m before the truncated-tower encode)
CASCADE = [
    (3, "approx", 0.90, False, None, 24, 32, "factorized", 2, 24),
    (3, "approx", 0.90, False, None, 24, 32, "factorized", 2, 48),
    (3, "approx", 0.90, False, None, 24, 32, "factorized", 2, 12),
    (5, "approx", 0.95, False, None, 24, 32, "factorized", 2, 24),
    (3, "approx", 0.90, False, "sentiment", 24, 32, "factorized", 2, 24),
    (3, "approx", 0.90, False, "pos", 24, 32, "factorized", 2, 24),
]


def attr_recall(captions, scenes) -> float:
    """Mean fraction of each scene's color/shape words present in its
    caption."""
    from conzic_torch.data.synthetic import scene_attribute_words

    vals = []
    for cap, scene in zip(captions, scenes):
        words = set(cap.split())
        attrs = scene_attribute_words(scene)
        vals.append(sum(w in words for w in attrs) / len(attrs))
    return float(np.mean(vals))


def pad_job(job: tuple) -> tuple:
    """A job as the full 12-tuple: default proxy stage-1 at 2 layers, no
    pre-cut, a proxy pre-cut of 1 layer."""
    job = (*job, "proxy", 2)[:9] if len(job) < 9 else job
    job = job if len(job) >= 10 else (*job, 0)
    return job if len(job) == 12 else (*job, "proxy", 1)


def exact_jobs(jobs):
    """The port's jobs: every approximate top-k as the exact one the port
    runs, then each job once (the first of those that share it)."""
    out = []
    for (pk, mode, recall, *rest) in map(pad_job, jobs):
        job = (pk, "exact", 0.95, *rest)
        if job not in out:
            out.append(job)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default="trained_tiny")
    p.add_argument("--ladder", action="store_true",
                   help="run every published operating point")
    p.add_argument("--factorized", action="store_true",
                   help="run the factorized stage-1 points (FACTORIZED)")
    p.add_argument("--cascade", action="store_true",
                   help="run the cascade (proxy pre-cut) points (CASCADE)")
    p.add_argument("--stage1_precut", type=int, default=0,
                   help="single-cell mode: cascade pre-cut width")
    p.add_argument("--stage1_precut_mode", default="proxy",
                   choices=["proxy", "tower"],
                   help="single-cell mode: pre-cut scorer")
    p.add_argument("--stage1_precut_layers", type=int, default=1,
                   help="single-cell mode: tower pre-cut depth")
    p.add_argument("--prune_stage1", default="proxy",
                   choices=["proxy", "factorized"],
                   help="single-cell mode: stage-1 scorer")
    p.add_argument("--stage1_layers", type=int, default=2)
    p.add_argument("--prune_k", type=int, default=None,
                   help="single-cell mode: one prune_k")
    p.add_argument("--topk_mode", default="approx",
                   choices=["approx", "exact"],
                   help="approx runs (and is keyed as) the exact top-k")
    p.add_argument("--recall", type=float, default=0.90)
    p.add_argument("--final_exact", action="store_true")
    p.add_argument("--ctl", choices=["sentiment", "pos"], default=None)
    p.add_argument("--stage1_ctl", choices=["auto", "on", "off"],
                   default="auto",
                   help="control-aware stage-1 ranking of ctl cells ('off' "
                        "measures the cosine-ranked program: other keys)")
    p.add_argument("--clip_len", type=int, default=24)
    p.add_argument("--n_images", type=int, default=32)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--sentence_len", type=int, default=10)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--scene_seed", type=int, default=9000,
                   help="held-out scene stream (training used seed+1)")
    p.add_argument("--out", default=MATRIX_PATH)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (writes the .cpu-smoke.json twin)")
    args = p.parse_args(argv)
    args.out = divert_cpu_output(args.out, MATRIX_PATH, args.cpu)
    device = tool_device(args.cpu)

    from PIL import Image

    from conzic_torch.config import ConzicConfig
    from conzic_torch.data.synthetic import build_dataset
    from conzic_torch.engine.sampler import Captioner

    with open(os.path.join(args.checkpoint, "conzic_tiny.json")) as f:
        doc = json.load(f)

    jobs = []
    if args.ladder:
        jobs += LADDER
    if args.factorized:
        jobs += FACTORIZED
    if args.cascade:
        jobs += CASCADE
    if not jobs:
        if args.prune_k is None:
            p.error("pass --ladder, --factorized, --cascade, or --prune_k")
        jobs = [(args.prune_k, args.topk_mode, args.recall,
                 args.final_exact, args.ctl, args.clip_len, args.n_images,
                 args.prune_stage1, args.stage1_layers,
                 args.stage1_precut, args.stage1_precut_mode,
                 args.stage1_precut_layers)]
    if any(j[1] == "approx" for j in jobs):
        print("NOTE: conzic_torch runs the exact top-k under "
              "topk_mode=approx; those jobs are measured and keyed as the "
              "exact operating point")
    jobs = exact_jobs(jobs)

    captioners = {}  # one per clip_len
    datasets = {}  # scenes per n

    def get_cap(clip_len):
        if clip_len not in captioners:
            cfg = ConzicConfig()
            cfg.lm_model = args.checkpoint
            cfg.match_model = args.checkpoint
            cfg.clip_len = clip_len
            cfg.verbose = False
            captioners[clip_len] = Captioner.from_pretrained(cfg,
                                                             device=device)
        return captioners[clip_len]

    def get_data(n):
        if n not in datasets:
            datasets[n] = build_dataset(n, seed=args.scene_seed)
        return datasets[n]

    if os.path.exists(args.out):
        with open(args.out) as f:
            matrix = json.load(f)
    else:
        matrix = {"cells": {}}
    trained = matrix.setdefault("trained", {
        "weights": "trained-tiny",
        "cells": {},
    })
    # the header describes the latest run; each cell names its checkpoint
    trained["checkpoint"] = args.checkpoint
    trained["checkpoint_note"] = (
        "header checkpoint/validation/train_meta describe the most "
        "recent merge run; per-cell provenance is each cell's "
        "'checkpoint' field (absent = trained_tiny)")
    trained["validation"] = doc.get("meta", {}).get("validation", {})
    trained["train_meta"] = {
        k: doc.get("meta", {}).get(k)
        for k in ("session", "params_m", "dataset", "wall_s")
    }
    trained["config"] = {"iters": args.iters,
                         "sentence_len": args.sentence_len, "k": args.k,
                         "scene_seed": args.scene_seed}

    for (pk, mode, recall, fe, ctl, clip_len, n, stage1, s1_layers,
         precut, pc_mode, pc_layers) in jobs:
        cap = get_cap(clip_len)
        cap.cfg.topk_recall = recall
        cap.cfg.prune_stage1 = stage1
        cap.cfg.prune_stage1_layers = s1_layers
        cap.cfg.prune_stage1_precut = precut
        cap.cfg.prune_stage1_precut_mode = pc_mode
        cap.cfg.prune_stage1_precut_layers = pc_layers
        cap.cfg.prune_stage1_ctl = args.stage1_ctl
        tower_layers = cap.clip_model.config.text.num_layers
        s1_pct = round(100 * s1_layers / tower_layers)
        pc_tower_pct = (round(100 * pc_layers / tower_layers)
                        if precut and pc_mode == "tower" else 0)
        imgs, _gt, scenes = get_data(n)
        embeds = cap.encode_images([Image.fromarray(imgs[i])
                                    for i in range(n)])
        # non-default scene seeds get an @s<seed> suffix: replication
        # cells never overwrite the primary estimate
        key_seed = 0 if args.scene_seed == 9000 else args.scene_seed
        key = cell_key(ctl=ctl, prune_k=pk, topk_mode=mode, recall=recall,
                       final_exact=fe, n_images=n, clip_len=clip_len,
                       stage1=stage1, stage1_pct=s1_pct, precut=precut,
                       precut_tower_pct=pc_tower_pct, seed=key_seed,
                       ctl_rank=(ctl is not None
                                 and args.stage1_ctl != "off"))
        if args.cpu:
            key += "+CPU-SMOKE"
        print(f"--- trained/{key}", flush=True)
        cell, runs = run_cell(
            cap, embeds, order="sequential", ctl=ctl, prune_k=pk,
            sentence_len=args.sentence_len, iters=args.iters, k=args.k,
            final_exact=fe, topk_mode=mode, return_runs=True)
        cell["checkpoint"] = args.checkpoint
        cell["tower_layers"] = tower_layers
        cell["best_cos_full"] = float(np.mean(runs["full"].best_cos))
        cell["best_cos_pruned"] = float(np.mean(runs["pruned"].best_cos))
        cell["attr_recall_full"] = attr_recall(
            runs["full"].gen_texts_list[-1], scenes)
        cell["attr_recall_pruned"] = attr_recall(
            runs["pruned"].gen_texts_list[-1], scenes)
        print("  " + json.dumps(cell))
        trained["cells"][key] = cell

    trained["session"] = session_tag()
    trained["worst_best_cosine_delta"] = max(
        c["best_cosine_delta"] for c in trained["cells"].values())
    trained["device"] = device_label(device)
    matrix.setdefault("device", trained["device"])
    write_record(args.out, matrix)
    print(f"wrote {args.out} ({len(trained['cells'])} trained cells)")


if __name__ == "__main__":
    main()
