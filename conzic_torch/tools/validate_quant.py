"""Quality check of the int8 tier (``--quant int8`` / ``int8_all``): the
counterpart of the reference's ``tools/validate_quant.py``.

Runs the same generations in full precision (reference semantics) and
through the int8 products (``conzic_torch/ops/quant.py``) and prints
caption agreement, token agreement and the CLIPScore delta, the metrics
``validate_pruning`` reports for the pruned tiers. With
``--random_models`` it checks numerical stability only.

Usage:
  python -m conzic_torch.tools.validate_quant --random_models
  python -m conzic_torch.tools.validate_quant --random_models tiny --cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from conzic_torch.tools import tool_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lm_model", default="bert-base-uncased")
    p.add_argument("--match_model", default="openai/clip-vit-base-patch32")
    p.add_argument("--random_models", nargs="?", const="full",
                   choices=["full", "tiny"], default=False)
    p.add_argument("--n_images", type=int, default=4)
    p.add_argument("--sentence_len", type=int, default=10)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--clip_len", type=int, default=24)
    p.add_argument("--order", default="sequential")
    p.add_argument("--quant", default="int8", choices=["int8", "int8_all"],
                   help="tier to compare against full precision: int8 = "
                        "CLIP candidate scoring only; int8_all = also the "
                        "BERT proposal encoder")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    if not args.random_models and not os.path.isdir(args.lm_model):
        p.error(f"--lm_model {args.lm_model!r} is not a local checkpoint "
                "directory and nothing can be downloaded — pass "
                "--random_models (full-architecture random weights) or "
                "--random_models tiny, or point --lm_model/--match_model at "
                "local checkpoint dirs.")
    device = tool_device(args.cpu)

    from conzic_torch.api.demo import build_captioner
    from conzic_torch.config import ConzicConfig

    runs = {}
    embeds = None
    for quant in ("none", args.quant):
        cfg = ConzicConfig()
        cfg.lm_model = args.lm_model
        cfg.match_model = args.match_model
        cfg.clip_len = args.clip_len
        cfg.verbose = False
        cfg.quant = quant
        cap = build_captioner(cfg, random_models=args.random_models,
                              device=device)
        if embeds is None:
            embeds = np.random.RandomState(0).randn(
                args.n_images, cap.clip_model.config.projection_dim
            ).astype(np.float32)
        runs[quant] = cap.run(
            embeds, prompt="Image of a", max_len=args.sentence_len,
            top_k=args.k, temperature=0.1, max_iter=args.iters,
            alpha=0.02, beta=2.0, order=args.order,
            rng=np.random.RandomState(42))
        del cap
    full, q8 = runs["none"], runs[args.quant]
    finals_f = full.gen_texts_list[-2]
    finals_q = q8.gen_texts_list[-2]
    exact = float(np.mean([a == b for a, b in zip(finals_f, finals_q)]))
    tok = float((full.iter_ids[-1] == q8.iter_ids[-1]).mean())
    cos_delta = float(np.mean(full.best_cos - q8.best_cos))
    print(f"tier: {args.quant}")
    print(f"caption exact-match: {exact:.2%}")
    print(f"token agreement:     {tok:.2%}")
    print(f"best-cosine delta (full - {args.quant}): {cos_delta:+.4f}")
    print(f"speedup: {full.elapsed_s / max(q8.elapsed_s, 1e-9):.2f}x")


if __name__ == "__main__":
    main()
