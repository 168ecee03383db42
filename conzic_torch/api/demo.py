"""Single-image captioning CLI: the counterpart of ``conzic_tpu.api.demo``.

    python -m conzic_torch.api.demo --caption_img_path examples/girl.jpg \
        --lm_model DIR --match_model DIR [--device cuda|cpu] [flags]

The reference's flags and defaults and its flow: seed, a logger whose file
name encodes the run's settings, the model load, then ``samples_num``
generations over one image (fused into one batch by default: the same
captions as a loop of single samples).

``--lm_model`` / ``--match_model`` take local checkpoint directories: HF
layout (config.json, safetensors or ``.bin`` weights, tokenizer files), or
a trained directory of the repo (``trained_tiny/``, both towers in one).
``--random_models`` runs seeded random towers instead: full width by
default, ``tiny`` for small ones. The run is on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from conzic_torch.config import add_reference_args, config_from_args
from conzic_torch.engine.sampler import (
    Captioner,
    control_generate_caption,
    generate_caption,
)
from conzic_torch.runtime.logging import create_logger, run_log_filename
from conzic_torch.runtime.seeding import set_seed


def build_mesh(cfg, device="cuda"):
    """The data mesh of ``--mesh_data_axis``: None for 1 (one device);
    else that many of the visible devices of ``device``'s kind (0 or
    less: all of them); the program ends with a message when fewer are
    visible."""
    if cfg.mesh_data_axis == 1:
        return None
    from conzic_torch.parallel import mesh as mesh_lib

    n = cfg.mesh_data_axis if cfg.mesh_data_axis > 0 else None
    try:
        return mesh_lib.make_mesh(
            n, devices=mesh_lib.visible_devices(torch.device(device).type))
    except ValueError as e:
        raise SystemExit(f"conzic_torch: --mesh_data_axis: {e}") from None


def build_captioner(cfg, random_models=False, device="cuda",
                    mesh=None) -> Captioner:
    if random_models:
        from conzic_torch.models.configs import BertConfig, CLIPConfig
        from conzic_torch.text.vocab import make_fullsize_wordpiece_vocab

        if random_models == "tiny":  # fast smoke runs
            return Captioner.from_random(cfg, seed=cfg.seed, device=device,
                                         mesh=mesh)
        return Captioner.from_random(
            cfg, bert_config=BertConfig(), clip_config=CLIPConfig(),
            wp_vocab=make_fullsize_wordpiece_vocab(),
            clip_text_vocab_size=49408, seed=cfg.seed, device=device,
            mesh=mesh)
    for path in (cfg.lm_model, cfg.match_model):
        if not os.path.isdir(path):
            sys.exit(
                f"checkpoint directory not found: {path!r}\n"
                "Pass local HF checkpoint dirs via --lm_model/--match_model "
                "or use --random_models for a no-checkpoint smoke run.")
    return Captioner.from_pretrained(cfg, device=device, mesh=mesh)


def _open_image(cfg, image_path, captioner, logger):
    from PIL import Image

    logger.info(f"Processing: {image_path}")
    image = Image.open(image_path).convert("RGB")
    img_name = [image_path.split("/")[-1]] * cfg.batch_size
    return img_name, captioner.encode_images([image] * cfg.batch_size)


def run_caption(cfg, image_path, captioner, logger, rng, fuse_samples=True):
    img_name, image_embeds = _open_image(cfg, image_path, captioner, logger)
    if fuse_samples and cfg.samples_num > 1:
        # every sample as batch rows of one generation: the captions of
        # the loop below, byte for byte
        result = captioner.run(
            image_embeds, prompt=cfg.prompt, max_len=cfg.sentence_len,
            top_k=cfg.candidate_k, temperature=cfg.lm_temperature,
            max_iter=cfg.num_iterations, alpha=cfg.alpha, beta=cfg.beta,
            order=cfg.order, rng=rng, n_samples=cfg.samples_num)
        for sample_id, res in enumerate(
                captioner.split_samples(result, cfg.samples_num)):
            logger.info(f"Sample {sample_id}: ")
            if captioner.cfg.verbose:
                captioner.log_iterations(logger, img_name, res)
            logger.info("Finished in %.3fs (fused over %d samples)"
                        % (result.elapsed_s, cfg.samples_num))
            for i in range(cfg.batch_size):
                logger.info(f"The {i + 1}-th image: {img_name[i]}")
                logger.info(f"final caption: {res.gen_texts_list[-2][i]}")
                logger.info(f"best caption: {res.gen_texts_list[-1][i]}")
        return
    for sample_id in range(cfg.samples_num):
        logger.info(f"Sample {sample_id}: ")
        generate_caption(
            img_name, captioner, image_embeds, logger,
            prompt=cfg.prompt, batch_size=cfg.batch_size,
            max_len=cfg.sentence_len, top_k=cfg.candidate_k,
            temperature=cfg.lm_temperature, max_iter=cfg.num_iterations,
            alpha=cfg.alpha, beta=cfg.beta, generate_order=cfg.order,
            rng=rng)


def run_control(cfg, image_path, captioner, logger, rng):
    img_name, image_embeds = _open_image(cfg, image_path, captioner, logger)
    for sample_id in range(cfg.samples_num):
        logger.info(f"Sample {sample_id}: ")
        control_generate_caption(
            img_name, captioner, image_embeds, logger,
            prompt=cfg.prompt, batch_size=cfg.batch_size,
            max_len=cfg.sentence_len, top_k=cfg.candidate_k,
            temperature=cfg.lm_temperature, max_iter=cfg.num_iterations,
            alpha=cfg.alpha, beta=cfg.beta, gamma=cfg.gamma,
            ctl_type=cfg.control_type, style_type=cfg.sentiment_type,
            pos_type=cfg.pos_type, generate_order=cfg.order, rng=rng)


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """``--random_models``, shared with ``api.run``."""
    parser.add_argument("--random_models", nargs="?", const="full",
                        choices=["full", "tiny"], default=False,
                        help="seeded random towers instead of checkpoints: "
                             "full width, or 'tiny' test towers")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_reference_args(parser)
    add_model_args(parser)
    parser.add_argument("--no_fuse_samples", action="store_true",
                        help="run samples as a sequential loop instead of "
                             "batch rows of one generation (same results)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    rng = set_seed(cfg.seed)

    logger = create_logger(cfg.logger_dir, "demo_" + run_log_filename(cfg))
    logger.info(f"Generating order:{cfg.order}")
    logger.info(f"Run type:{cfg.run_type}")
    logger.info(args)

    # before the (expensive) model build
    if not os.path.exists(cfg.caption_img_path):
        sys.exit(f"image not found: {cfg.caption_img_path!r}")

    captioner = build_captioner(cfg, random_models=args.random_models,
                                device=args.device,
                                mesh=build_mesh(cfg, args.device))
    if cfg.run_type == "caption":
        run_caption(cfg, cfg.caption_img_path, captioner, logger, rng,
                    fuse_samples=not args.no_fuse_samples)
    else:
        run_control(cfg, cfg.caption_img_path, captioner, logger, rng)


if __name__ == "__main__":
    main()
