"""Host input fan-out ceiling: the counterpart of the reference's
``tools/host_feed_ceiling.py``.

The sustained rate at which ONE host feeds a card through the production
input path of ``conzic_torch.api.run``: JPEG decode
(``api.run.iter_image_batches``) -> bicubic resize + normalize
(``runtime.image.preprocess_batch_pil``) -> one-ahead prefetch thread
(``runtime.prefetch.prefetch_map``) -> the copy of each batch to the
device, as ``Captioner.encode_images`` makes it; no model runs.

From it, the cards one host can feed at each rate of the port's ladder
(``records_torch/LADDER.json``: its headline reads and points, caps/s
measured on the card; each caption consumes one image, the worst case
samples_num=1). Without a port ladder it reports the feed rate alone.
Writes ``records_torch/HOST_FEED.json``.

Usage:
  python -m conzic_torch.tools.host_feed_ceiling
  python -m conzic_torch.tools.host_feed_ceiling --cpu --n_images 16 \
      --batch_size 8 --repeats 2       # CPU smoke
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from conzic_torch.tools import (
    device_label,
    divert_cpu_output,
    record_path,
    tool_device,
    write_record,
)

OUT_PATH = record_path("HOST_FEED.json")
LADDER_PATH = record_path("LADDER.json")


def make_image_dir(n: int, w: int, h: int, quality: int, seed: int) -> str:
    """n synthetic JPEGs with photo-like spectra (smooth gradients +
    noise: compresses like a natural image, not like white noise)."""
    from PIL import Image

    d = tempfile.mkdtemp(prefix="host_feed_")
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        fx, fy = rng.uniform(1, 6, 2)
        base = (
            127 + 80 * np.sin(2 * np.pi * fx * xx / w + rng.uniform(0, 6))
            * np.cos(2 * np.pi * fy * yy / h + rng.uniform(0, 6))
        )
        img = np.stack([base + rng.randn(h, w) * 12 for _ in range(3)], -1)
        img = np.clip(img, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(
            os.path.join(d, f"img_{i:05d}.jpg"), quality=quality)
    return d


def ladder_rates(path: str) -> dict:
    """caps/s of each row of the port's ladder record: the headline reads
    (median) and the points; empty without the record."""
    rates = {}
    try:
        with open(path) as f:
            ladder = json.load(f)
    except (OSError, ValueError) as e:
        print(f"NOTE: {path} unavailable ({e}); per-tier cards per host "
              "omitted", file=sys.stderr)
        return rates
    device = ladder.get("device")
    for name, read in ladder.get("headline", {}).items():
        rates[f"full parity {name} ({read['caps_per_s']} caps/s, "
              f"{device})"] = read["caps_per_s"]
    for pt in ladder.get("points", []):
        rates[f"{pt['name']} ({pt['caps_per_s']} caps/s, {device})"] = (
            pt["caps_per_s"])
    return rates


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_images", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=128,
                   help="the pruned tiers' production batch shape")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--quality", type=int, default=90)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--workers", type=int, default=1,
                   help="prefetch_map decode threads (1 = the production "
                        "default)")
    p.add_argument("--repeats", type=int, default=3,
                   help="passes over the directory (the first warms the "
                        "page cache; the ceiling quotes the later passes)")
    p.add_argument("--out", default=OUT_PATH)
    p.add_argument("--cpu", action="store_true",
                   help="feed the CPU (writes the .cpu-smoke.json twin)")
    args = p.parse_args(argv)
    args.out = divert_cpu_output(args.out, OUT_PATH, args.cpu)
    device = tool_device(args.cpu)

    import torch

    from conzic_torch.api.run import iter_image_batches
    from conzic_torch.engine.sampler import resolve_device
    from conzic_torch.runtime.image import preprocess_batch_pil
    from conzic_torch.runtime.prefetch import prefetch_map

    dev = resolve_device(device)
    logger = logging.getLogger("host_feed")
    logger.addHandler(logging.NullHandler())

    d = make_image_dir(args.n_images, args.width, args.height,
                       args.quality, seed=0)
    try:
        def host_pipeline(batch):  # api/run.py's host stage
            imgs, names = batch
            return preprocess_batch_pil(imgs, args.image_size), names

        per_pass = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            n_done = 0
            for pixels, names in prefetch_map(
                host_pipeline,
                iter_image_batches(d, args.batch_size, logger),
                workers=args.workers,
            ):
                on_dev = torch.from_numpy(np.asarray(pixels, np.float32)
                                          ).to(dev)
                assert on_dev.shape[1:] == (
                    args.image_size, args.image_size, 3)
                n_done += on_dev.shape[0]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            per_pass.append(n_done / (time.perf_counter() - t0))
        warm = per_pass[1:] if len(per_pass) > 1 else per_pass
        ceiling = float(np.median(warm))

        rates = ladder_rates(LADDER_PATH)
        doc = {
            "images_per_sec_host_pipeline": round(ceiling, 2),
            "per_pass": [round(v, 2) for v in per_pass],
            "config": {
                "n_images": args.n_images, "batch_size": args.batch_size,
                "jpeg": f"{args.width}x{args.height}@q{args.quality}",
                "image_size": args.image_size,
                "prefetch_depth": 1,
                "workers": args.workers,
                "host": f"nproc={os.cpu_count()}",
            },
            "max_chips_per_host": {
                name: (round(ceiling / cps, 1) if cps else None)
                for name, cps in rates.items()
            },
            "note": ("worst case samples_num=1 (every caption consumes a "
                     "fresh image); multi-sample runs divide the input "
                     "requirement by samples_num. The pipeline is one "
                     "thread + one prefetch thread, and each batch is "
                     "copied to the device; more decode workers would "
                     "raise the ceiling on multi-core hosts."),
            "device": device_label(device),
        }
        write_record(args.out, doc)
        print(json.dumps(doc, indent=1))
    finally:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
