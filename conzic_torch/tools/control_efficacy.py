"""Control-efficacy and diversity dossier: the counterpart of the
reference's ``tools/control_efficacy.py``.

On a trained world's HELD-OUT scenes it generates captions in every
control mode (free, sentiment-positive, sentiment-negative, POS-templated)
at full parity and at each shipped control tier (free fact17pc24,
sentiment and POS fact50pc96), then reports per (mode, tier):

  - the mean sentence-level sentiment of the best captions
    (``eval/sentiment_eval.py``) and the share of captions with a
    positive- or negative-valence word,
  - POS template-match accuracy (``eval/pos_eval.py``) against the template
    used for control,
  - Div-1 / Div-2 / vocab size over each image's samples (``eval/ndiv.py``,
    the reference's per-image accumulation),
  - the mean best-of-run CLIP cosine.

Control efficacy is the delta BETWEEN modes; tier fidelity is each tier
staying at its full-parity mode's level. The tiers run the exact top-k
(the reference's ``approx_max_k`` is exact off the TPU). Writes
``records_torch/CONTROL_EFFICACY.json``.

Usage:
  python -m conzic_torch.tools.control_efficacy --checkpoint trained_tiny12
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from conzic_torch.tools import (
    device_label,
    divert_cpu_output,
    record_path,
    tool_device,
    write_record,
)
from conzic_torch.tools.validate_pruning import session_tag

OUT_PATH = record_path("CONTROL_EFFICACY.json")

# matched to the trained shape-world's caption grammar ("image of a small
# white square with a ... on a red background ."); control and evaluation
# use the SAME template, as the reference's own evaluation does
WORLD_TEMPLATE = [
    ["NOUN"], ["ADP"], ["DET"],                      # image of a
    ["ADJ"], ["ADJ", "NOUN"], ["NOUN"],              # small white square
    ["ADP"], ["DET"],                                # with a
    ["ADJ", "NOUN"], ["NOUN"],                       # green triangle
    ["ADP", "NOUN"], ["NOUN", "."], ["."],           # on a background .
]


def sentiment_metrics(captions) -> dict:
    from conzic_torch.eval.ndiv import word_tokenize
    from conzic_torch.eval.sentiment_eval import batch_texts_sentiment_scores
    from conzic_torch.text.lexicons import _NEGATIVE, _POSITIVE

    scores = batch_texts_sentiment_scores(captions, negative=False)
    pos_rate = neg_rate = 0.0
    for cap in captions:
        words = {w.lower() for w in word_tokenize(cap)}
        pos_rate += bool(words & set(_POSITIVE))
        neg_rate += bool(words & set(_NEGATIVE))
    n = max(len(captions), 1)
    return {
        "sentiment_mean": float(np.mean(scores)),
        "positive_word_rate": pos_rate / n,
        "negative_word_rate": neg_rate / n,
    }


def pos_metrics(captions, template) -> dict:
    from conzic_torch.eval.pos_eval import batch_texts_pos_analysis

    _, scores = batch_texts_pos_analysis(captions, template)
    return {"pos_template_accuracy": float(np.mean(scores))}


def diversity_metrics(per_image_captions) -> dict:
    """The reference's per-image accumulation: ``per_image_captions`` is a
    list of caption lists, one per image."""
    from conzic_torch.eval.ndiv import calc_diversity

    div1 = div2 = 0.0
    vocab: list = []
    for caps in per_image_captions:
        dn, vocab = calc_diversity(caps, vocab)
        div1 += dn[0]
        div2 += dn[1]
    n = max(len(per_image_captions), 1)
    return {
        "div_1": div1 / n,
        "div_2": div2 / n,
        "vocab_len": len(set(vocab)),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default="trained_tiny12")
    p.add_argument("--n_images", type=int, default=32)
    p.add_argument("--n_samples", type=int, default=2,
                   help="samples per image (Div-n needs >1 caption/image)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--sentence_len", type=int, default=10)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--scene_seed", type=int, default=9000,
                   help="held-out scene stream (training used seed+1)")
    p.add_argument("--gamma", type=float, default=5.0)
    p.add_argument("--template", type=str, default=None,
                   help="JSON slot-list template overriding the "
                        "world-matched default")
    p.add_argument("--stage1_ctl", choices=["auto", "on", "off"],
                   default="auto",
                   help="control-aware stage-1 ranking of the ctl tiers "
                        "(labels carry +ctlrank when on)")
    p.add_argument("--skip_tiers", action="store_true",
                   help="full-parity modes only (no ctl speed tiers)")
    p.add_argument("--only", default=None,
                   help="comma-separated mode filter (free,sent_pos,"
                        "sent_neg,pos); merges into an existing --out file")
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

    template = json.loads(args.template) if args.template else [
        list(s) for s in WORLD_TEMPLATE
    ]

    cfg = ConzicConfig()
    cfg.lm_model = args.checkpoint
    cfg.match_model = args.checkpoint
    cfg.verbose = False
    cap = Captioner.from_pretrained(cfg, device=device)
    tower_layers = cap.clip_model.config.text.num_layers

    def layers(pct):  # depth-percent -> layer count on THIS tower
        return max(1, round(pct * tower_layers / 100))

    # the shipped ctl operating points; the tier names follow the matrix's
    # cell keys
    tiers = {"free": "fact17pc24",
             "sentiment": "fact50pc96",
             "pos": "fact50pc96"}
    tier_cfg = {
        "fact17pc24": dict(prune_k=3, s1_layers=layers(17), precut=24),
        "fact50pc96": dict(prune_k=3, s1_layers=layers(50), precut=96),
        "fact50pc48": dict(prune_k=3, s1_layers=layers(50), precut=48),
    }

    imgs, _gt, _scenes = build_dataset(args.n_images, seed=args.scene_seed)
    embeds = cap.encode_images([Image.fromarray(imgs[i])
                                for i in range(args.n_images)])

    modes = [
        ("free", None, False),
        ("sent_pos", "sentiment", False),
        ("sent_neg", "sentiment", True),
        ("pos", "pos", False),
    ]

    def one_run(ctl, negative, tier):
        pk = None
        if tier is not None:
            t = tier_cfg[tier]
            cap.cfg.prune_stage1 = "factorized"
            cap.cfg.prune_stage1_layers = t["s1_layers"]
            cap.cfg.prune_stage1_precut = t["precut"]
            cap.cfg.prune_stage1_ctl = args.stage1_ctl
            pk = t["prune_k"]
        return cap.run(
            embeds, prompt="Image of a", max_len=args.sentence_len,
            top_k=args.k, temperature=0.1, max_iter=args.iters,
            alpha=0.02, beta=2.0,
            gamma=args.gamma if ctl else 0.0,
            order="sequential", ctl=ctl, negative=negative,
            rng=np.random.RandomState(42), n_samples=args.n_samples,
            prune_k=pk,
            pos_template=template if ctl == "pos" else None,
        )

    results = {}
    if args.only:
        keep = {m.strip() for m in args.only.split(",")}
        modes = [m for m in modes if m[0] in keep]
        # partial re-measures extend the existing dossier in place
        if os.path.exists(args.out):
            with open(args.out) as f:
                results = json.load(f).get("results", {})
    for mode, ctl, negative in modes:
        tier_names = [None]
        if not args.skip_tiers:
            tier_names.append(tiers[ctl] if ctl else tiers["free"])
        for tier in tier_names:
            label = f"{mode}/{tier or 'full'}"
            if tier and ctl and args.stage1_ctl != "off":
                label += "+ctlrank"
            print(f"--- {label}", flush=True)
            res = one_run(ctl, negative, tier)
            best = res.gen_texts_list[-1]      # best-by-CLIPScore
            # rows are sample-major: [s0_img0..s0_imgN, s1_img0..]
            per_image = [
                [best[s * args.n_images + i]
                 for s in range(args.n_samples)]
                for i in range(args.n_images)
            ]
            entry = {
                "best_cos_mean": float(np.mean(res.best_cos)),
                **sentiment_metrics(best),
                **pos_metrics(best, template),
                **diversity_metrics(per_image),
                "final_captions_sample": res.gen_texts_list[-2][:4],
                "best_captions_sample": best[:4],
            }
            print("  " + json.dumps(
                {k: v for k, v in entry.items()
                 if not k.endswith("_sample")}))
            results[label] = entry

    doc = {
        "checkpoint": args.checkpoint,
        "tower_layers": tower_layers,
        "config": {
            "n_images": args.n_images, "n_samples": args.n_samples,
            "iters": args.iters, "sentence_len": args.sentence_len,
            "k": args.k, "gamma": args.gamma,
            "scene_seed": args.scene_seed,
            "template": template,
            "tiers": tier_cfg,
            "stage1_ctl": args.stage1_ctl,
        },
        "vocab_caveat": (
            "shape-world vocab carries few valence words; sentiment "
            "shifts are real steering evidence but world-limited in "
            "magnitude"),
        "session": session_tag(),
        "results": results,
        "device": device_label(device),
    }
    write_record(args.out, doc)
    print(f"wrote {args.out} ({len(results)} runs)")


if __name__ == "__main__":
    main()
