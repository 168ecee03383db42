"""CLIPScore of captions against images.

Counterpart of ``conzic_tpu/eval/clipscore.py``: the cosine of the image
and text embeddings of each (image, caption) pair, as the Gibbs loop
scores its candidates, for any caption set offline, and for a results file
of ``api.run``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch


def encode_texts(captioner, texts: List[str],
                 batch_size: int = 64) -> np.ndarray:
    """(N, D) text embeddings at CLIP's full 77-token context, in chunks
    of ``batch_size`` captions."""
    out = []
    for i in range(0, len(texts), batch_size):
        ids, mask = captioner.bpe.batch_encode(
            texts[i:i + batch_size], max_length=77, pad_to_max=True)
        dev = captioner.device
        with torch.inference_mode():
            emb = captioner.clip_model.encode_text(
                torch.from_numpy(ids).long().to(dev),
                torch.from_numpy(mask).long().to(dev))
        out.append(emb.float().cpu().numpy())
    return np.concatenate(out, axis=0)


def clip_scores(captioner, image_paths: Sequence[str],
                captions: Sequence[str], batch_size: int = 64) -> np.ndarray:
    """Cosine per (image, caption) pair (raw cosine, not logit-scaled)."""
    from PIL import Image

    if not image_paths:
        return np.zeros((0,), np.float32)
    imgs = [Image.open(p).convert("RGB") for p in image_paths]
    img_emb = np.concatenate([
        captioner.encode_images(imgs[i:i + batch_size]).float().cpu().numpy()
        for i in range(0, len(imgs), batch_size)])
    txt_emb = encode_texts(captioner, list(captions), batch_size)
    img_emb = img_emb / np.linalg.norm(img_emb, axis=-1, keepdims=True)
    txt_emb = txt_emb / np.linalg.norm(txt_emb, axis=-1, keepdims=True)
    return np.sum(img_emb * txt_emb, axis=-1)


def score_results_file(captioner, results_json: str,
                       image_dir: str) -> Dict[str, float]:
    """Score a results file of ``api.run`` ({image_id: caption}) against
    the images of ``image_dir``."""
    with open(results_json, encoding="utf-8") as f:
        res = json.load(f)
    names, caps = [], []
    for image_id, caption in res.items():
        for ext in (".jpg", ".jpeg", ".png", ""):
            p = os.path.join(image_dir, image_id + ext)
            if os.path.exists(p):
                names.append(p)
                caps.append(caption if isinstance(caption, str)
                            else caption[0])
                break
    scores = clip_scores(captioner, names, caps)
    return {os.path.basename(n): float(s) for n, s in zip(names, scores)}
