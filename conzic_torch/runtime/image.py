"""CLIP's and SigLIP's image preprocessing.

Counterpart of ``conzic_tpu/runtime/image.py``, with the semantics of HF's
``CLIPImageProcessor``: resize the shortest edge to ``image_size``
(bicubic), center-crop ``image_size``, rescale by 1/255 and normalise with
the CLIP mean and std. Output is NHWC float32, the layout the port's vision
tower takes. ``kind="siglip"``: HF's ``SiglipImageProcessor``, a bicubic
resize of the whole image to ``image_size`` square (no crop), rescaled by
1/255 and normalised with mean and std 0.5 (host path only).

Two paths:
  - ``preprocess_pil`` / ``preprocess_batch_pil``: on the host with PIL's
    bicubic resize, bit-equal to the reference package's;
  - ``preprocess_torch``: uint8 pixels resized, cropped and normalised on
    the device by ``F.interpolate`` (bicubic, antialiased). It differs from
    PIL, which rounds to uint8 after each resize pass, by a mean absolute
    difference under 0.12, as the reference's ``preprocess_jax`` does.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
SIGLIP_MEAN = SIGLIP_STD = np.array([0.5, 0.5, 0.5], np.float32)


def preprocess_pil(image, image_size: int = 224,
                   kind: str = "clip") -> np.ndarray:
    """PIL image -> (H, W, C) float32, as ``kind`` ("clip" or "siglip")
    preprocesses."""
    from PIL import Image

    if image.mode != "RGB":
        image = image.convert("RGB")
    if kind == "siglip":
        image = image.resize((image_size, image_size), Image.BICUBIC)
        arr = np.asarray(image, np.float32) / 255.0
        return (arr - SIGLIP_MEAN) / SIGLIP_STD
    if kind != "clip":
        raise ValueError(f"unknown preprocessing {kind!r}")
    w, h = image.size
    short, long = (w, h) if w <= h else (h, w)
    # HF truncates the long side, it does not round
    new_long = int(image_size * long / short)
    nw, nh = (image_size, new_long) if w <= h else (new_long, image_size)
    image = image.resize((nw, nh), Image.BICUBIC)
    left = (nw - image_size) // 2
    top = (nh - image_size) // 2
    image = image.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(image, np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def preprocess_batch_pil(images, image_size: int = 224,
                         workers: int = 0, kind: str = "clip") -> np.ndarray:
    """(B, H, W, C) float32 from PIL images. ``workers`` > 1 runs a thread
    pool (PIL's resize releases the GIL); 0 = auto: threads for batches of
    8 or more images on a host with several cores, else serial."""
    if workers == 0:
        ncpu = os.cpu_count() or 1
        workers = min(16, ncpu, len(images)) if (
            len(images) >= 8 and ncpu > 1) else 1
    if workers <= 1 or len(images) <= 1:
        return np.stack([preprocess_pil(im, image_size, kind)
                         for im in images])
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        outs = list(pool.map(
            lambda im: preprocess_pil(im, image_size, kind), images))
    return np.stack(outs)


def preprocess_torch(pixels: Union[np.ndarray, torch.Tensor],
                     image_size: int = 224,
                     device: Union[str, torch.device] = "cuda"
                     ) -> torch.Tensor:
    """(H, W, C) or (B, H, W, C) uint8 or float pixels in [0, 255] ->
    (..., image_size, image_size, C) float32 on ``device``: the
    aspect-preserving resize and center crop of the host path."""
    if not isinstance(pixels, torch.Tensor):
        pixels = torch.from_numpy(np.array(pixels))  # a writable copy
    x = pixels.to(device, torch.float32)
    single = x.dim() == 3
    if single:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    if h <= w:
        nh, nw = image_size, int(image_size * w / h)
    else:
        nh, nw = int(image_size * h / w), image_size
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bicubic",
                      align_corners=False, antialias=True)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, :, top:top + image_size, left:left + image_size]
    x = x.permute(0, 2, 3, 1) / 255.0
    mean = torch.from_numpy(CLIP_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_STD).to(x.device)
    x = (x - mean) / std
    return x[0] if single else x
