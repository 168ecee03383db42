"""The control TABLE mode against ``ctl_mode=exact`` on trained weights: the
counterpart of the reference's ``tools/ctl_table_vs_exact.py``.

The control energies default to per-token lexicon tables on the device;
``ctl_mode="exact"`` scores each candidate sentence on the host with the
reference's pipeline (``eval/sentiment_eval.py``, ``eval/pos_eval.py``).
This runs the SAME generation in both modes per control and reports the
caption agreement, the best-cosine delta and each mode's final control
score. Writes ``records_torch/CTL_TABLE_VS_EXACT.json``.

Usage:
  python -m conzic_torch.tools.ctl_table_vs_exact --checkpoint trained_tiny12
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from conzic_torch.tools import (
    device_label,
    divert_cpu_output,
    record_path,
    tool_device,
    write_record,
)
from conzic_torch.tools.validate_pruning import session_tag

OUT_PATH = record_path("CTL_TABLE_VS_EXACT.json")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default="trained_tiny12")
    p.add_argument("--n_images", type=int, default=16)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--sentence_len", type=int, default=10)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--gamma", type=float, default=5.0)
    p.add_argument("--scene_seed", type=int, default=9000)
    p.add_argument("--out", default=OUT_PATH)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (writes the .cpu-smoke.json twin)")
    args = p.parse_args(argv)
    args.out = divert_cpu_output(args.out, OUT_PATH, args.cpu)
    device = tool_device(args.cpu)

    from PIL import Image

    from conzic_torch.config import ConzicConfig
    from conzic_torch.data.synthetic import build_dataset
    from conzic_torch.engine.sampler import Captioner

    cfg = ConzicConfig()
    cfg.lm_model = args.checkpoint
    cfg.match_model = args.checkpoint
    cfg.verbose = False
    cap = Captioner.from_pretrained(cfg, device=device)

    imgs, _gt, _scenes = build_dataset(args.n_images, seed=args.scene_seed)
    embeds = cap.encode_images([Image.fromarray(imgs[i])
                                for i in range(args.n_images)])

    results = {}
    for ctl in ("sentiment", "pos"):
        runs = {}
        for mode in ("table", "exact"):
            cap.cfg.ctl_mode = mode
            print(f"--- {ctl}/{mode}", flush=True)
            runs[mode] = cap.run(
                embeds, prompt="Image of a", max_len=args.sentence_len,
                top_k=args.k, temperature=0.1, max_iter=args.iters,
                alpha=0.02, beta=2.0, gamma=args.gamma,
                order="sequential", ctl=ctl, negative=False,
                rng=np.random.RandomState(42))
        cap.cfg.ctl_mode = "table"
        t, e = runs["table"], runs["exact"]
        finals_t = t.gen_texts_list[-2]
        finals_e = e.gen_texts_list[-2]
        cell = {
            "caption_exact": float(np.mean(
                [a == b for a, b in zip(finals_t, finals_e)])),
            "token_agreement": float(
                (t.iter_ids[-1] == e.iter_ids[-1]).mean()),
            # positive: exact mode reaches a better cosine
            "best_cosine_delta_exact_minus_table": float(
                np.mean(e.best_cos - t.best_cos)),
            # each engine's own scale (per-token table sums against
            # sentence-level scores): compare within a mode, not across
            "ctl_score_final_table": float(np.mean(t.iter_ctl[-1])),
            "ctl_score_final_exact": float(np.mean(e.iter_ctl[-1])),
            "final_captions_table": finals_t[:4],
            "final_captions_exact": finals_e[:4],
        }
        print("  " + json.dumps(
            {k: v for k, v in cell.items() if not k.startswith("final_")}))
        results[ctl] = cell

    doc = {
        "checkpoint": args.checkpoint,
        "config": {"n_images": args.n_images, "iters": args.iters,
                   "sentence_len": args.sentence_len, "k": args.k,
                   "gamma": args.gamma, "scene_seed": args.scene_seed},
        "session": session_tag(),
        "results": results,
        "device": device_label(device),
    }
    write_record(args.out, doc)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
