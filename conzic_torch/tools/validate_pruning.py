"""Quality matrix of the pruned tiers: the counterpart of the reference's
``tools/validate_pruning.py``.

Runs the same generations with full scoring (reference semantics) and
with ``prune_k`` pre-selection across a (order x control x prune_k)
matrix and reports, per cell:
  - caption agreement (exact-match rate of final captions),
  - token agreement (fraction of committed sentence tokens equal),
  - CLIPScore delta (mean best-cosine difference, full - pruned).

With ``--random_models`` it bounds numerical drift only (random weights
carry no semantics; the record names the weights that produced it).

Usage:
  python -m conzic_torch.tools.validate_pruning --random_models --prune_k 5
  python -m conzic_torch.tools.validate_pruning --random_models --matrix
  python -m conzic_torch.tools.validate_pruning --random_models tiny \
      --matrix --cpu      # CPU smoke: PRUNING_MATRIX.json.cpu-smoke.json

``--matrix`` writes ``records_torch/PRUNING_MATRIX.json``, the matrix
``conzic_torch.bench``'s quality gate reads, keeping the ``trained``
section that ``conzic_torch.tools.trained_quality_cells`` wrote there.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import sys

import numpy as np

from conzic_torch.tools import (
    device_label,
    divert_cpu_output,
    record_path,
    tool_device,
    write_record,
)

MATRIX_PATH = record_path("PRUNING_MATRIX.json")


def session_tag() -> str:
    """Provenance tag recorded per cell: CONZIC_SESSION, else host + UTC
    date."""
    tag = os.environ.get("CONZIC_SESSION")
    if tag:
        return tag
    return (socket.gethostname() + ":"
            + datetime.datetime.now(datetime.timezone.utc)
            .strftime("%Y-%m-%d"))


def cell_key(*, order="sequential", ctl=None, prune_k, topk_mode="exact",
             recall=0.95, final_exact=False, quant="none",
             n_images=4, clip_len=24, seed=0,
             stage1="proxy", stage1_pct=50, precut=0,
             precut_tower_pct=0, ctl_rank=False) -> str:
    """THE matrix cell-key grammar, the reference's letter for letter:
    ``order/<ctl|free>/prune<k>[+fact<pct>[pc<m>[t<pct>]]][+ctlrank]
    [+approx<recall>][+final_exact][+int8|+int8_all][@n<N>][@len<L>]
    [@s<seed>]``. ``conzic_torch.bench.gate_head`` builds the same order.
    ``<pct>`` is the factorized scorer's depth percent of the text tower;
    ``pc<m>`` the cascade's pre-cut width, ``t<pct>`` a tower pre-cut's
    depth percent; ``+ctlrank`` the control-aware stage-1 ranking. The
    port runs the exact top-k under ``topk_mode="approx"``, so its tools
    never pass "approx" here."""
    key = f"{order}/{ctl or 'free'}/prune{prune_k}"
    if stage1 == "factorized":
        key += f"+fact{stage1_pct:g}"
        if precut:
            key += f"pc{precut}"
            if precut_tower_pct:
                key += f"t{precut_tower_pct:g}"
    if ctl_rank:
        key += "+ctlrank"
    if topk_mode == "approx":
        key += f"+approx{recall:g}"
    if final_exact:
        key += "+final_exact"
    if quant != "none":
        key += f"+{quant}"
    if n_images != 4:
        key += f"@n{n_images}"
    if clip_len != 24:
        key += f"@len{clip_len}"
    if seed != 0:
        key += f"@s{seed}"
    return key


def refuse_approx(parser: argparse.ArgumentParser, topk_mode: str) -> None:
    """The port has no approximate top-k: ``topk_mode="approx"`` runs the
    exact one, as the reference does off the TPU. A cell keyed
    ``+approx`` would claim an approximation that never ran."""
    if topk_mode == "approx":
        parser.error("--topk_mode approx: conzic_torch runs the exact top-k "
                     "under either mode (the reference's approx_max_k is "
                     "exact off the TPU), so it writes no +approx cell; "
                     "pass --topk_mode exact")


def build_quant_captioner(cfg, quant, recall, random_models, device="cuda"):
    """The pruned-side captioner of quantized cells: the same config and
    weights (seeded init or checkpoint load) with the int8 tier built in."""
    from conzic_torch.api.demo import build_captioner

    cap_q = build_captioner(dataclasses.replace(cfg, quant=quant),
                            random_models=random_models, device=device)
    cap_q.cfg.verbose = False
    cap_q.cfg.topk_recall = recall
    return cap_q


def run_cell(cap, embeds, *, order, ctl, prune_k, sentence_len, iters, k,
             final_exact=False, topk_mode="exact", cap_pruned=None,
             return_runs=False):
    """One (order, ctl, prune_k) quality cell. The ``speedup`` column is
    wall-clock including any first-run table build: informational; caps/s
    come from ``conzic_torch.bench``.

    ``cap_pruned``: a separate captioner for the pruned side (quantized
    cells compare a full-precision full-parity run with a quantized pruned
    one); defaults to ``cap``."""
    runs = {}
    for name, pk in (("full", None), ("pruned", prune_k)):
        c = cap if name == "full" else (cap_pruned or cap)
        c.cfg.topk_mode = topk_mode if pk else "exact"
        runs[name] = c.run(
            embeds, prompt="Image of a", max_len=sentence_len,
            top_k=k, temperature=0.1, max_iter=iters,
            alpha=0.02, beta=2.0, gamma=5.0 if ctl else 0.0,
            order=order, ctl=ctl, negative=False,
            rng=np.random.RandomState(42), prune_k=pk,
            prune_final_exact=final_exact and pk is not None,
        )
    cap.cfg.topk_mode = "exact"
    if cap_pruned is not None:
        cap_pruned.cfg.topk_mode = "exact"
    full, pruned = runs["full"], runs["pruned"]
    finals_f = full.gen_texts_list[-2]
    finals_p = pruned.gen_texts_list[-2]
    exact = float(np.mean([a == b for a, b in zip(finals_f, finals_p)]))
    tok_agree = float((full.iter_ids[-1] == pruned.iter_ids[-1]).mean())
    cos_delta = float(np.mean(full.best_cos - pruned.best_cos))
    cell = {
        "caption_exact": exact,
        "token_agreement": tok_agree,
        "best_cosine_delta": cos_delta,
        "speedup": full.elapsed_s / max(pruned.elapsed_s, 1e-9),
        "session": session_tag(),
    }
    if return_runs:
        return cell, runs
    return cell


def seeded_embeds(n_images: int, cap, seed: int = 0):
    """The matrix's image embeddings: ``RandomState(seed)`` normals."""
    rng = np.random.RandomState(seed)
    return rng.randn(n_images, cap.clip_model.config.projection_dim).astype(
        np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lm_model", default="bert-base-uncased")
    p.add_argument("--match_model", default="openai/clip-vit-base-patch32")
    p.add_argument("--random_models", nargs="?", const="full",
                   choices=["full", "tiny"], default=False)
    p.add_argument("--prune_k", type=int, default=40)
    p.add_argument("--matrix", action="store_true",
                   help="sweep orders x controls x prune_k and write "
                        "records_torch/PRUNING_MATRIX.json")
    p.add_argument("--n_images", type=int, default=4)
    p.add_argument("--sentence_len", type=int, default=10)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--clip_len", type=int, default=24)
    p.add_argument("--out", default=MATRIX_PATH)
    p.add_argument("--merge", action="store_true",
                   help="keep existing cells in --out and only run the "
                        "missing ones")
    p.add_argument("--topk_mode", default="exact",
                   choices=["exact", "approx"],
                   help="stage-1 candidate top-k of the pruned run; the "
                        "port refuses approx (it runs the exact top-k)")
    p.add_argument("--topk_recall", type=float, default=0.95)
    p.add_argument("--prune_stage1", default="proxy",
                   choices=["proxy", "factorized"])
    p.add_argument("--stage1_layers", type=int, default=2,
                   help="factorized depth; 0 = auto-select at the "
                        "calibration floor")
    p.add_argument("--stage1_precut", type=int, default=0,
                   help="factorized cascade pre-cut width (0 = off)")
    p.add_argument("--quant", default="none",
                   choices=["none", "int8", "int8_all"],
                   help="quantize the PRUNED side (cells gain a +<tier> "
                        "key suffix)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (writes the .cpu-smoke.json twin)")
    args = p.parse_args(argv)
    refuse_approx(p, args.topk_mode)
    args.out = divert_cpu_output(args.out, MATRIX_PATH, args.cpu)
    device = tool_device(args.cpu)

    from conzic_torch.api.demo import build_captioner
    from conzic_torch.config import ConzicConfig

    cfg = ConzicConfig()
    cfg.lm_model = args.lm_model
    cfg.match_model = args.match_model
    cfg.clip_len = args.clip_len
    cfg.verbose = False
    cap = build_captioner(cfg, random_models=args.random_models,
                          device=device)
    cap.cfg.verbose = False
    cap.cfg.prune_stage1 = args.prune_stage1
    cap.cfg.prune_stage1_layers = args.stage1_layers
    cap.cfg.prune_stage1_precut = args.stage1_precut
    if args.prune_stage1 == "factorized" and args.stage1_layers == 0:
        # resolve the automatic depth now, so that the keys carry it
        cap._ensure_stage1_calibration()
        print(f"factorized auto-depth: "
              f"{cap.cfg.prune_stage1_layers}/"
              f"{cap.clip_model.config.text.num_layers} layers, "
              f"calibration held-out cosine {cap.stage1_calib_cos:.4f}")
    cap_pruned = None
    if args.quant != "none":
        cap_pruned = build_quant_captioner(
            cfg, args.quant, args.topk_recall, args.random_models, device)

    embeds = seeded_embeds(args.n_images, cap)
    cap.cfg.topk_recall = args.topk_recall
    common = dict(sentence_len=args.sentence_len, iters=args.iters, k=args.k,
                  topk_mode=args.topk_mode, cap_pruned=cap_pruned)

    if args.prune_k >= args.k:
        print(f"NOTE: prune_k={args.prune_k} >= k={args.k} disables pruning "
              f"(the sampler turns it off) — cells at this point would be "
              f"vacuously perfect; pass a smaller --prune_k or larger --k.")
    if not args.matrix:
        if args.prune_k >= args.k:
            sys.exit(2)
        cell = run_cell(cap, embeds, order="sequential", ctl=None,
                        prune_k=args.prune_k, **common)
        if args.prune_stage1 == "factorized":
            print(f"stage-1: factorized "
                  f"{cap.cfg.prune_stage1_layers} layers"
                  + (f", pre-cut {args.stage1_precut}"
                     if args.stage1_precut else "")
                  + (f", calibration held-out cosine "
                     f"{cap.stage1_calib_cos:.4f}"
                     if cap.stage1_calib_cos is not None else ""))
        print(f"caption exact-match: {cell['caption_exact']:.2%}")
        print(f"token agreement:     {cell['token_agreement']:.2%}")
        print(f"best-cosine delta (full - pruned): "
              f"{cell['best_cosine_delta']:+.4f}")
        print(f"speedup: {cell['speedup']:.2f}x")
        return

    cells, previous = {}, {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            previous = json.load(f)
        if args.merge:
            cells = previous.get("cells", {})
    # the prune_k sweep on the headline order, every order and both
    # controls at --prune_k, the hybrid (pruned + exact final sweep) cells
    jobs = [("sequential", None, pk, False) for pk in (5, 10, 20, 40, 80)]
    jobs += [(o, None, args.prune_k, False)
             for o in ("shuffle", "span", "random")]
    jobs += [("sequential", c, args.prune_k, False)
             for c in ("sentiment", "pos")]
    jobs += [("sequential", None, pk, True) for pk in (5, 10, 20)]
    jobs += [("sequential", c, 5, True) for c in ("sentiment", "pos")]
    # prune_k >= k would run un-pruned and record vacuous cells
    for o, c, pk, fe in jobs:
        if pk >= args.k:
            print(f"SKIP {o}/{c or 'free'}/prune{pk}: prune_k >= k={args.k} "
                  f"(cell would be vacuous)")
    jobs = [j for j in jobs if j[2] < args.k]

    # matrix mode writes no @n/@len/@s suffix: those are the matrix-wide
    # config recorded in the header
    def job_key(o, c, pk, fe):
        pct = round(100 * cap.cfg.prune_stage1_layers
                    / cap.clip_model.config.text.num_layers)
        return cell_key(order=o, ctl=c, prune_k=pk,
                        topk_mode=args.topk_mode, recall=args.topk_recall,
                        final_exact=fe, quant=args.quant,
                        stage1=args.prune_stage1, stage1_pct=pct,
                        precut=args.stage1_precut,
                        ctl_rank=(c is not None
                                  and cap.cfg.prune_stage1_ctl != "off"))

    if args.merge:
        jobs = [j for j in jobs if job_key(*j) not in cells]
    for order, ctl, pk, fe in jobs:
        key = job_key(order, ctl, pk, fe)
        print(f"--- {key}", flush=True)
        cell = run_cell(cap, embeds, order=order, ctl=ctl, prune_k=pk,
                        final_exact=fe, **common)
        for m, v in cell.items():
            print(f"  {m}: {v:.4f}" if isinstance(v, float) else f"  {m}: {v}")
        cells[key] = cell
    result = {
        "weights": ("random-" + args.random_models) if args.random_models
                   else f"{args.lm_model}+{args.match_model}",
        "config": {"n_images": args.n_images, **common,
                   "clip_len": args.clip_len},
        "cells": cells,
        "worst_best_cosine_delta": max(
            c["best_cosine_delta"] for c in cells.values()),
        "device": device_label(device),
    }
    result["config"].pop("cap_pruned")
    if "trained" in previous:  # trained_quality_cells' section stays
        result["trained"] = previous["trained"]
    write_record(args.out, result)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
