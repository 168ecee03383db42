"""Batched directory captioning CLI: the counterpart of
``conzic_tpu.api.run``.

    python -m conzic_torch.api.run --caption_img_path DIR --batch_size B \
        --lm_model DIR --match_model DIR [--device cuda|cpu] [flags]

The reference's flow: the image directory in sorted batches of exactly
``batch_size`` (a trailing partial batch is dropped), every caption
gathered as ``all_results[iter_id][image_id]`` and written to
``results/<config>/sample_<i>/iter_<j>.json`` and ``best_clipscore.json``,
the layout that ``eval.ndiv``, ``eval.pos_eval`` and ``eval.clipscore``
read. An image that cannot be decoded is skipped and logged. Decoding and
preprocessing (``host_pipeline``) run one batch ahead on a worker thread
while the card captions the batch before.

``--mesh_data_axis N`` splits every batch over N devices of this process.
``--multihost`` (or ``CONZIC_MULTIHOST=1``) makes this one process of a
multi-process run: ``--coordinator_address`` host:port of process 0,
``--num_processes`` and ``--process_id`` (else ``torch.distributed``'s
environment variables). Every process lists the directory alike and
decodes its contiguous block of each batch (``row_slice``); the results
are gathered and process 0 writes the tree. Each process runs on
``cuda:{local rank % cards}``.

``CONZIC_TRACE_DIR=DIR`` profiles the captioning and writes one Chrome
trace into DIR: the program's ``conzic.`` spans (``runtime/profiling.py``)
on every thread beside the card's kernels, and its counters in the
trace's metadata.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

from conzic_torch.api.demo import (
    add_model_args,
    build_captioner,
    build_mesh,
)
from conzic_torch.config import add_reference_args, config_from_args
from conzic_torch.engine.sampler import (
    control_generate_caption,
    generate_caption,
)
from conzic_torch.parallel import distributed
from conzic_torch.runtime.image import preprocess_batch_pil
from conzic_torch.runtime.logging import (
    create_logger,
    run_log_filename,
    run_type_label,
)
from conzic_torch.runtime.prefetch import prefetch_map
from conzic_torch.runtime import profiling
from conzic_torch.runtime.seeding import set_seed


def iter_image_batches(dir_path: str, batch_size: int, logger,
                       row_slice=None, image_size=None):
    """Yields (pil_images, names) of exactly ``batch_size`` images, in the
    sorted order of the directory; unreadable files are skipped.

    ``row_slice`` (one process of a multi-process run): every process
    forms the same batches from the listing and decodes only its block of
    rows, so ``pil_images`` holds that block and ``names`` the whole
    batch. The batches must be alike in every process, so an unreadable
    file is not skipped there but decoded as a black ``image_size``
    square, and logged."""
    from PIL import Image

    names = sorted(os.listdir(dir_path))
    if row_slice is None:
        batch_imgs, batch_names = [], []
        for name in names:
            try:
                img = Image.open(os.path.join(dir_path, name)).convert("RGB")
            except Exception as e:  # a file of any kind PIL cannot read
                logger.info(f"skipping unreadable image {name}: {e}")
                continue
            batch_imgs.append(img)
            batch_names.append(name)
            if len(batch_imgs) == batch_size:
                yield batch_imgs, batch_names
                batch_imgs, batch_names = [], []
        return
    for start in range(0, len(names) - batch_size + 1, batch_size):
        batch_names = names[start:start + batch_size]
        imgs = []
        for n in batch_names[row_slice]:
            try:
                imgs.append(
                    Image.open(os.path.join(dir_path, n)).convert("RGB"))
            except Exception as e:  # the batches are global: substitute
                logger.info(f"unreadable image {n}: {e} — black "
                            f"placeholder keeps the global batch aligned")
                side = image_size or 224
                imgs.append(Image.new("RGB", (side, side)))
        yield imgs, batch_names


def host_pipeline(batch, image_size: int, kind: str = "clip"):
    """Decoded images -> (NHWC pixels, names), preprocessed as the
    matcher's ``kind`` ("clip" or "siglip") takes them, in a span so that
    a ``CONZIC_TRACE_DIR`` trace shows the host stage beside the card's."""
    imgs, names = batch
    with profiling.span("entry.preprocess"):
        return preprocess_batch_pil(imgs, image_size, kind=kind), names


def accumulate(all_results, img_names, gen_texts):
    for iter_id, gen_text_list in enumerate(gen_texts):
        for jj in range(len(gen_text_list)):
            image_id = img_names[jj].split(".")[0]
            if all_results[iter_id] is None:
                all_results[iter_id] = {image_id: gen_text_list[jj]}
            else:
                all_results[iter_id][image_id] = gen_text_list[jj]
    return all_results


def save_results(cfg, run_type, all_results, sample_id):
    kind = "caption" if cfg.run_type == "caption" else run_type
    save_dir = (
        f"{cfg.results_dir}/{kind}_{cfg.order}_len{cfg.sentence_len}"
        f"_topk{cfg.candidate_k}_alpha{cfg.alpha:.3f}_beta{cfg.beta:.3f}"
        f"_gamma{cfg.gamma:.3f}_lmTemp{cfg.lm_temperature:.3f}"
        f"/sample_{sample_id}")
    os.makedirs(save_dir, exist_ok=True)
    for iter_id in range(len(all_results)):
        name = (f"iter_{iter_id}.json" if iter_id != len(all_results) - 1
                else "best_clipscore.json")
        with open(os.path.join(save_dir, name), "w") as f:
            json.dump(all_results[iter_id], f)
    return save_dir


def caption_batches(cfg, captioner, batches, logger, rng, workers=1,
                    local=False):
    """Every sample over the batches that ``batches()`` yields, each
    mapped by ``host_pipeline`` on ``workers`` threads: one generation a
    batch, then the sample's results tree, written by process 0 only.
    ``local``: the batches hold this process's block of rows (a
    multi-process run). Returns the trees written."""
    run_type = run_type_label(cfg)
    pipeline = functools.partial(
        host_pipeline, image_size=captioner.clip_model.config.vision.image_size,
        kind=captioner.clip_model.preprocessing)
    save_dirs = []
    for sample_id in range(cfg.samples_num):
        all_results = [None] * (cfg.num_iterations + 1)
        logger.info(f"Sample {sample_id + 1}: ")
        for batch_idx, (pixels, names) in enumerate(
                prefetch_map(pipeline, batches(), workers=workers)):
            logger.info(f"The {batch_idx + 1}-th batch:")
            image_embeds = captioner.encode_images(pixels, local=local)
            kw = dict(prompt=cfg.prompt, batch_size=cfg.batch_size,
                      max_len=cfg.sentence_len, top_k=cfg.candidate_k,
                      temperature=cfg.lm_temperature,
                      max_iter=cfg.num_iterations, alpha=cfg.alpha,
                      beta=cfg.beta, generate_order=cfg.order, rng=rng)
            if cfg.run_type == "caption":
                gen_texts, _ = generate_caption(names, captioner,
                                                image_embeds, logger, **kw)
            else:
                gen_texts, _ = control_generate_caption(
                    names, captioner, image_embeds, logger, gamma=cfg.gamma,
                    ctl_type=cfg.control_type,
                    style_type=cfg.sentiment_type, pos_type=cfg.pos_type,
                    **kw)
            all_results = accumulate(all_results, names, gen_texts)
        if distributed.is_primary():
            # every process holds the whole results; one writes them
            save_dir = save_results(cfg, run_type, all_results, sample_id)
            logger.info(f"saved results to {save_dir}")
            save_dirs.append(save_dir)
    return save_dirs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_reference_args(parser)
    add_model_args(parser)
    parser.add_argument("--prefetch_workers", type=int, default=1,
                        help="host decode and preprocess threads feeding "
                             "the card")
    parser.add_argument("--multihost", action="store_true",
                        help="one process of a multi-process run: each "
                             "process decodes its block of every batch, "
                             "process 0 writes the results "
                             "(CONZIC_MULTIHOST=1 also opts in)")
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port of process 0 (else MASTER_ADDR / "
                             "MASTER_PORT)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.set_defaults(batch_size=2, caption_img_path="./examples/")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    multihost = args.multihost or distributed.env_requested()
    device = args.device
    if multihost:
        distributed.initialize(args.coordinator_address, args.num_processes,
                               args.process_id)
        if cfg.batch_size % distributed.process_count():
            sys.exit(f"--batch_size {cfg.batch_size} must be a multiple "
                     f"of the process count "
                     f"({distributed.process_count()}) for per-process "
                     f"feeding")
        device = distributed.local_device(device)
    rng = set_seed(cfg.seed)

    logger = create_logger(cfg.logger_dir, run_log_filename(cfg))
    logger.info(f"Generating order:{cfg.order}")
    logger.info(f"Run type:{run_type_label(cfg)}")
    logger.info(args)

    if not os.path.isdir(cfg.caption_img_path):
        sys.exit(f"image directory not found: {cfg.caption_img_path!r}")
    captioner = build_captioner(cfg, random_models=args.random_models,
                                device=device, mesh=build_mesh(cfg, device))
    row_slice = (distributed.local_slice(cfg.batch_size) if multihost
                 else None)
    image_size = captioner.clip_model.config.vision.image_size
    with profiling.trace():
        caption_batches(
            cfg, captioner,
            lambda: iter_image_batches(cfg.caption_img_path, cfg.batch_size,
                                       logger, row_slice=row_slice,
                                       image_size=image_size),
            logger, rng, workers=args.prefetch_workers,
            local=row_slice is not None)
    if multihost:
        distributed.shutdown()


if __name__ == "__main__":
    main()
