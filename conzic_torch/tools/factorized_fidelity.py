"""Offline stage-1 fidelity study: the counterpart of the reference's
``tools/factorized_fidelity.py``. How faithfully does a cheap scorer rank
the k candidates of one substitution against the full CLIP text tower?

On a trained semantic checkpoint, at Gibbs-like substitution points of
held-out captions, three stage-1 scorers are compared with the full one:

  proxy      the engine's bag-of-embeddings proxy
             (``energies.prune_proxy_scores``, what ``--prune_k`` uses)
  trunc<N>   the first N text-tower layers + final LN + a ridge
             least-squares map into the projection space
             (:func:`fit_calibration`)
  random     floor baseline

Metrics per (image, slot): recall@m (|stage-1 top-m ∩ full top-m| / m)
and regret@m (the best full cosine minus the best full cosine within the
stage-1 top-m). Writes ``records_torch/FACTORIZED_FIDELITY.json``.

Usage:
  python -m conzic_torch.tools.factorized_fidelity --checkpoint trained_tiny12
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

OUT_PATH = record_path("FACTORIZED_FIDELITY.json")


def fit_calibration(pooled: np.ndarray, target: np.ndarray,
                    l2: float = 1e-3) -> np.ndarray:
    """Ridge least-squares map from truncated pooled states (B, H) to
    full projected embeddings (B, D)."""
    H = pooled.shape[1]
    A = pooled.T @ pooled + l2 * np.eye(H, dtype=np.float64)
    W = np.linalg.solve(A, pooled.T @ target)
    return W.astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default="trained_tiny")
    p.add_argument("--n_images", type=int, default=32)
    p.add_argument("--k", type=int, default=200)
    p.add_argument("--slots", type=int, default=3,
                   help="substitution slots probed per image")
    p.add_argument("--calib_n", type=int, default=2048)
    p.add_argument("--layers", type=int, nargs="+", default=[1, 2])
    p.add_argument("--m", type=int, nargs="+", default=[3, 5, 10])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (writes the .cpu-smoke.json twin)")
    p.add_argument("--out", default=OUT_PATH)
    args = p.parse_args(argv)
    args.out = divert_cpu_output(args.out, OUT_PATH, args.cpu)
    device = tool_device(args.cpu)

    import torch
    from PIL import Image

    from conzic_torch.config import ConzicConfig
    from conzic_torch.data.synthetic import build_dataset, caption_words
    from conzic_torch.energies import prune_proxy_scores
    from conzic_torch.engine.sampler import Captioner
    from conzic_torch.models.clip import TruncatedTextTower

    rng = np.random.RandomState(args.seed)
    cfg = ConzicConfig()
    cfg.lm_model = args.checkpoint
    cfg.match_model = args.checkpoint
    cfg.verbose = False
    cap = Captioner.from_pretrained(cfg, device=device)
    cap._ensure_word_embeds()
    word_embeds = cap.tables["word_embeds"]
    wp, bpe = cap.wp, cap.bpe
    clip_model = cap.clip_model

    # held-out scenes, a stream other than training's and the quality cells'
    imgs, caps_gt, _scenes = build_dataset(args.n_images, seed=7777)
    img_emb = cap.encode_images(
        [Image.fromarray(imgs[i]) for i in range(args.n_images)]
    ).float().cpu().numpy()
    img_n = img_emb / np.linalg.norm(img_emb, axis=-1, keepdims=True)

    def encode(fn, texts):
        ids, mask = bpe.batch_encode(texts, max_length=24, pad_to_max=True)
        return cap._encode_rows(fn, np.asarray(ids, np.int32),
                                np.asarray(mask, np.int32), 4096)

    def full_cosines(texts, img_row):
        emb = encode(clip_model.encode_text, texts)
        emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        return emb @ img_n[img_row]

    # ---- calibration sentences: dataset captions + random-word strings ----
    vocab_words = [w for w in wp.vocab if w.isalpha()]
    calib_texts = list(caps_gt)
    while len(calib_texts) < args.calib_n:
        n_w = rng.randint(4, 12)
        calib_texts.append(" ".join(
            vocab_words[i] for i in rng.randint(0, len(vocab_words), n_w)))
    calib_texts = calib_texts[: args.calib_n]
    target = encode(clip_model.encode_text, calib_texts)

    truncs = {}
    for N in args.layers:
        tower = TruncatedTextTower(clip_model.text_model, N)
        pooled = encode(tower, calib_texts)
        W = fit_calibration(pooled.astype(np.float64),
                            target.astype(np.float64))
        # calibration quality on its own fit set (upper bound indicator)
        pred = pooled @ W
        pred_n = pred / np.linalg.norm(pred, axis=-1, keepdims=True)
        tgt_n = target / np.linalg.norm(target, axis=-1, keepdims=True)
        calib_cos = float((pred_n * tgt_n).sum(-1).mean())
        truncs[N] = (tower, W, calib_cos)
        print(f"trunc{N}: calibration cosine {calib_cos:.4f}")

    # ---- the substitution experiment -------------------------------------
    content_ids = [wp.vocab[w] for w in caption_words() if w in wp.vocab]
    all_word_ids = [wp.vocab[w] for w in vocab_words]
    results = {f"trunc{N}": {m: {"recall": [], "regret": []}
                             for m in args.m} for N in args.layers}
    results["proxy"] = {m: {"recall": [], "regret": []} for m in args.m}
    results["random"] = {m: {"recall": [], "regret": []} for m in args.m}

    def dev(x, dtype=torch.long):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=cap.device)

    for b in range(args.n_images):
        base_ids_row = wp.encode(caps_gt[b])
        S = len(base_ids_row)
        slot_positions = rng.choice(
            # inner word positions (skip [CLS]=0 and trailing ". [SEP]")
            np.arange(1, S - 2), size=min(args.slots, S - 3), replace=False)
        for col in slot_positions:
            cands = list(rng.choice(all_word_ids, args.k - len(content_ids),
                                    replace=False)) + content_ids
            cands = np.asarray(cands[: args.k], np.int32)
            texts = []
            for cid in cands:
                row = list(base_ids_row)
                row[col] = int(cid)
                texts.append(wp.decode(row[1:-1]))
            fc = full_cosines(texts, b)

            with torch.inference_mode():
                proxy = prune_proxy_scores(
                    word_embeds, dev([base_ids_row]), dev([col]),
                    dev(cands[None]), dev(img_emb[b][None], torch.float32),
                    seq_len=S)[0].float().cpu().numpy()

            scores = {"proxy": proxy, "random": rng.rand(args.k)}
            for N in args.layers:
                tower, W, _ = truncs[N]
                emb = encode(tower, texts) @ W
                emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
                scores[f"trunc{N}"] = emb @ img_n[b]

            order_full = np.argsort(-fc)
            for name, sc in scores.items():
                order_s = np.argsort(-sc)
                for m in args.m:
                    top_s = set(order_s[:m].tolist())
                    top_f = set(order_full[:m].tolist())
                    recall = len(top_s & top_f) / m
                    regret = float(fc[order_full[0]]
                                   - fc[list(top_s)].max())
                    results[name][m]["recall"].append(recall)
                    results[name][m]["regret"].append(regret)

    summary = {"checkpoint": args.checkpoint, "n_images": args.n_images,
               "k": args.k, "slots_per_image": args.slots,
               "calibration_cos": {f"trunc{N}": truncs[N][2]
                                   for N in args.layers},
               "scorers": {}}
    for name, per_m in results.items():
        summary["scorers"][name] = {
            str(m): {"recall": float(np.mean(v["recall"])),
                     "mean_regret": float(np.mean(v["regret"])),
                     "p90_regret": float(np.percentile(v["regret"], 90))}
            for m, v in per_m.items()}
    summary["device"] = device_label(device)
    print(json.dumps(summary, indent=1))
    write_record(args.out, summary)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
