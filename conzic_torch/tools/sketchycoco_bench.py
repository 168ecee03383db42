"""SketchyCOCOcaption pipeline: the counterpart of the reference's
``tools/sketchycoco_bench.py``, over a local image directory:

  1. batched captioning (``conzic_torch.api.run``, the reference's
     artifact layout, all samples),
  2. Div-1/Div-2/vocab diversity across samples (``eval/ndiv.py``),
  3. optional CLIP text-index retrieval over a caption corpus
     (``api/retrieval.py``).

The dataset is not in the repository and cannot be downloaded; with
``--random_models`` (or a trained directory such as ``trained_tiny/``) the
pipeline runs end to end over any directory, for example scenes of
``data/synthetic.py`` written as PNG. Writes ``<out>/report.json``.

Usage:
  python -m conzic_torch.tools.sketchycoco_bench --images DIR \
      [--corpus captions.json] [--random_models] [--samples 3] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from conzic_torch.tools import device_label, tool_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", required=True)
    p.add_argument("--lm_model", default="bert-base-uncased")
    p.add_argument("--match_model", default="openai/clip-vit-base-patch32")
    p.add_argument("--random_models", action="store_true")
    p.add_argument("--samples", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--sentence_len", type=int, default=10)
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--order", default="shuffle")
    p.add_argument("--corpus", default=None,
                   help="caption corpus JSON for the retrieval baseline")
    p.add_argument("--out", default="sketchycoco_results")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    device = tool_device(args.cpu)

    from conzic_torch.api import run as run_cli
    from conzic_torch.config import ConzicConfig
    from conzic_torch.eval.ndiv import calc_diversity

    # 1) batched captioning through the reference-parity runner
    t0 = time.perf_counter()
    run_cli.main([
        "--run_type", "caption", "--order", args.order,
        "--sentence_len", str(args.sentence_len),
        "--candidate_k", str(args.k),
        "--num_iterations", str(args.iters),
        "--samples_num", str(args.samples),
        "--batch_size", str(args.batch_size),
        "--caption_img_path", args.images,
        "--lm_model", args.lm_model,
        "--match_model", args.match_model,
        "--device", device,
    ] + (["--random_models"] if args.random_models else []))
    caption_time = time.perf_counter() - t0

    # this run's artifact directory only: its name has no timestamp, so a
    # bare results/* glob would sweep in other configurations' runs
    d = ConzicConfig()
    run_dir = (
        f"{d.results_dir}/caption_{args.order}_len{args.sentence_len}"
        f"_topk{args.k}_alpha{d.alpha:.3f}_beta{d.beta:.3f}"
        f"_gamma{d.gamma:.3f}_lmTemp{d.lm_temperature:.3f}"
    )
    sample_bests = []
    for i in range(args.samples):  # this run's sample ids only
        best = f"{run_dir}/sample_{i}/best_clipscore.json"
        if os.path.exists(best):
            with open(best) as f:
                sample_bests.append(json.load(f))
    if not sample_bests:
        sys.exit("no results written — captioning failed")
    n_images = len(sample_bests[0])
    total_caps = sum(len(s) for s in sample_bests)
    print(f"captioned {n_images} images x {len(sample_bests)} samples "
          f"in {caption_time:.1f}s ({total_caps / caption_time:.2f} caps/s "
          "incl. model build)")

    # 2) diversity across samples, per image (compute_n_div.py semantics)
    div1 = div2 = 0.0
    vocab = []
    image_ids = sorted(sample_bests[0])
    for image_id in image_ids:
        caps = [s[image_id] for s in sample_bests if image_id in s]
        dn, vocab = calc_diversity(caps, vocab)
        div1 += dn[0]
        div2 += dn[1]
    report = {
        "images": n_images,
        "samples": len(sample_bests),
        "captions_per_sec_incl_compile": round(total_caps / caption_time, 3),
        "div_1": round(div1 / max(len(image_ids), 1), 4),
        "div_2": round(div2 / max(len(image_ids), 1), 4),
        "vocab_len": len(set(vocab)),
        "device": device_label(device),
    }

    # 3) retrieval baseline when a corpus is given
    if args.corpus:
        from conzic_torch.api.demo import build_captioner
        from conzic_torch.api.retrieval import CLIPIndex, build_index

        cfg = ConzicConfig()
        cfg.lm_model = args.lm_model
        cfg.match_model = args.match_model
        cap = build_captioner(cfg, random_models=args.random_models,
                              device=device)
        os.makedirs(args.out, exist_ok=True)
        build_index(cap, args.corpus, args.out)
        index = CLIPIndex(
            os.path.join(args.out, "index_matrix.txt"),
            os.path.join(args.out, "mapping_dict.json"),
            cap,
        )
        preds = {}
        for image_id in image_ids:
            for ext in (".jpg", ".jpeg", ".png"):
                path = os.path.join(args.images, image_id + ext)
                if os.path.exists(path):
                    preds[image_id] = index.search_text(path)
                    break
        with open(os.path.join(args.out, "retrieval_predictions.json"),
                  "w") as f:
            json.dump(preds, f, indent=2)
        report["retrieval_predictions"] = len(preds)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
