"""Merge single (sequential) quality cells into
``records_torch/PRUNING_MATRIX.json``: the counterpart of the reference's
``tools/approx_quality_cells.py``, its general merge tool for any
(prune_k, final_exact, n_images, ctl, clip_len, seed, quant) cell.

- keys: ``sequential/<ctl|free>/prune<k>[+final_exact][+int8|+int8_all]
  [@n<N>][@len<L>][@s<seed>]`` (``validate_pruning.cell_key``);
- the matrix's standard config otherwise (len=10, iters=10, k=200,
  clip_len=24, seed-0 embeddings), full-width random towers (tiny ones
  under ``--cpu``).

The reference wrote ``+approx<recall>`` cells here from the TPU's
approximate top-k. The port runs the exact top-k under either mode, so
``--topk_mode approx`` is refused: a run that did not approximate never
writes an ``+approx`` key.

Usage:
  python -m conzic_torch.tools.approx_quality_cells --topk_mode exact \
      --prune_k 5 --final_exact --n_images 16
"""

from __future__ import annotations

import argparse
import json
import os

from conzic_torch.tools import (
    device_label,
    divert_cpu_output,
    tool_device,
    write_record,
)
from conzic_torch.tools.validate_pruning import (
    MATRIX_PATH,
    build_quant_captioner,
    cell_key,
    refuse_approx,
    run_cell,
    seeded_embeds,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--prune_k", type=int, nargs="+", default=[5, 10])
    p.add_argument("--topk_mode", default="approx",
                   choices=["approx", "exact"],
                   help="the reference's default, approx, is refused: the "
                        "port runs the exact top-k")
    p.add_argument("--recall", type=float, default=0.95)
    p.add_argument("--final_exact", action="store_true",
                   help="hybrid schedule: pruned sweeps + full-parity "
                        "final sweep (keys gain a +final_exact suffix)")
    p.add_argument("--n_images", type=int, default=4,
                   help="sample size; non-default adds an @n<N> key suffix")
    p.add_argument("--ctl", choices=["sentiment", "pos"], default=None,
                   help="controlled-generation cell (key path segment)")
    p.add_argument("--clip_len", type=int, default=24,
                   help="CLIP context length; non-default adds an "
                        "@len<N> key suffix")
    p.add_argument("--seed", type=int, default=0,
                   help="image-embedding seed; non-default adds an "
                        "@s<seed> key suffix (replication cells)")
    p.add_argument("--quant", default="none",
                   choices=["none", "int8", "int8_all"],
                   help="quantize the PRUNED side (+<tier> key suffix)")
    p.add_argument("--out", default=MATRIX_PATH)
    p.add_argument("--cpu", action="store_true",
                   help="tiny towers on the CPU (writes the .cpu-smoke.json "
                        "twin)")
    args = p.parse_args(argv)
    refuse_approx(p, args.topk_mode)
    args.out = divert_cpu_output(args.out, MATRIX_PATH, args.cpu)
    device = tool_device(args.cpu)
    random_models = "tiny" if args.cpu else "full"

    from conzic_torch.api.demo import build_captioner
    from conzic_torch.config import ConzicConfig

    cfg = ConzicConfig()
    cfg.clip_len = args.clip_len
    cfg.verbose = False
    cfg.topk_recall = args.recall
    cap = build_captioner(cfg, random_models=random_models, device=device)
    cap.cfg.verbose = False
    cap_pruned = None
    if args.quant != "none":
        cap_pruned = build_quant_captioner(cfg, args.quant, args.recall,
                                           random_models, device)
    embeds = seeded_embeds(args.n_images, cap, args.seed)
    if os.path.exists(args.out):
        with open(args.out) as f:
            matrix = json.load(f)
    else:
        matrix = {"cells": {}}
    for pk in args.prune_k:
        cell = run_cell(cap, embeds, order="sequential", ctl=args.ctl,
                        prune_k=pk, sentence_len=10, iters=10, k=200,
                        topk_mode=args.topk_mode,
                        final_exact=args.final_exact, cap_pruned=cap_pruned)
        key = cell_key(ctl=args.ctl, prune_k=pk, topk_mode=args.topk_mode,
                       recall=args.recall, final_exact=args.final_exact,
                       quant=args.quant, n_images=args.n_images,
                       clip_len=args.clip_len, seed=args.seed,
                       ctl_rank=(args.ctl is not None
                                 and cap.cfg.prune_stage1_ctl != "off"))
        if args.cpu:
            key += "+CPU-SMOKE"
        print(key, json.dumps(cell))
        matrix["cells"][key] = cell
    matrix["worst_best_cosine_delta"] = max(
        c["best_cosine_delta"] for c in matrix["cells"].values())
    matrix["device"] = device_label(device)
    write_record(args.out, matrix)
    print(f"merged into {args.out}")


if __name__ == "__main__":
    main()
