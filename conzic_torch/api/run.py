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

``--multihost`` and its address flags parse and end with a message: the
port has no scale-out yet.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

from conzic_torch.api.demo import add_model_args, build_captioner
from conzic_torch.config import add_reference_args, config_from_args
from conzic_torch.engine.sampler import (
    control_generate_caption,
    generate_caption,
)
from conzic_torch.runtime.image import preprocess_batch_pil
from conzic_torch.runtime.logging import (
    create_logger,
    run_log_filename,
    run_type_label,
)
from conzic_torch.runtime.prefetch import prefetch_map
from conzic_torch.runtime.profiling import annotate
from conzic_torch.runtime.seeding import set_seed


def iter_image_batches(dir_path: str, batch_size: int, logger):
    """Yields (pil_images, names) of exactly ``batch_size`` images, in the
    sorted order of the directory; unreadable files are skipped."""
    from PIL import Image

    batch_imgs, batch_names = [], []
    for name in sorted(os.listdir(dir_path)):
        try:
            img = Image.open(os.path.join(dir_path, name)).convert("RGB")
        except Exception as e:  # a file of any kind that PIL cannot read
            logger.info(f"skipping unreadable image {name}: {e}")
            continue
        batch_imgs.append(img)
        batch_names.append(name)
        if len(batch_imgs) == batch_size:
            yield batch_imgs, batch_names
            batch_imgs, batch_names = [], []


def host_pipeline(batch, image_size: int):
    """Decoded images -> (NHWC pixels, names), annotated so that a
    ``CONZIC_TRACE_DIR`` trace shows the host stage beside the card's."""
    imgs, names = batch
    with annotate("host:preprocess"):
        return preprocess_batch_pil(imgs, image_size), names


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


def caption_batches(cfg, captioner, batches, logger, rng, workers=1):
    """Every sample over the batches that ``batches()`` yields, each
    mapped by ``host_pipeline`` on ``workers`` threads: one generation a
    batch, then the sample's results tree. Returns the trees written."""
    run_type = run_type_label(cfg)
    pipeline = functools.partial(
        host_pipeline, image_size=captioner.clip_model.config.vision.image_size)
    save_dirs = []
    for sample_id in range(cfg.samples_num):
        all_results = [None] * (cfg.num_iterations + 1)
        logger.info(f"Sample {sample_id + 1}: ")
        for batch_idx, (pixels, names) in enumerate(
                prefetch_map(pipeline, batches(), workers=workers)):
            logger.info(f"The {batch_idx + 1}-th batch:")
            image_embeds = captioner.encode_images(pixels)
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
    # the reference's scale-out flags: parsed, refused below
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--coordinator_address", default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.set_defaults(batch_size=2, caption_img_path="./examples/")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if (args.multihost or os.environ.get("CONZIC_MULTIHOST") == "1"
            or args.coordinator_address or args.num_processes is not None
            or args.process_id is not None):
        sys.exit("conzic_torch: multi-host scale-out is not ported yet; "
                 "run one process without --multihost")
    rng = set_seed(cfg.seed)

    logger = create_logger(cfg.logger_dir, run_log_filename(cfg))
    logger.info(f"Generating order:{cfg.order}")
    logger.info(f"Run type:{run_type_label(cfg)}")
    logger.info(args)

    if not os.path.isdir(cfg.caption_img_path):
        sys.exit(f"image directory not found: {cfg.caption_img_path!r}")
    captioner = build_captioner(cfg, random_models=args.random_models,
                                device=args.device)
    caption_batches(
        cfg, captioner,
        lambda: iter_image_batches(cfg.caption_img_path, cfg.batch_size,
                                   logger),
        logger, rng, workers=args.prefetch_workers)


if __name__ == "__main__":
    main()
