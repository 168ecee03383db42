"""The system under test, driven as its users drive it.

Builds ``conzic_torch``'s ``Captioner`` through the port's public
constructors from the benchmark's inputs, and runs one request the way
``conzic_torch.api.run`` runs a batch and the web app's Submit callback
(``conzic_torch.api.app.make_demo_fn``) runs an image: the image tower
once, then ``generate_caption`` once per sample, which decodes the texts
on the host. This is the only module of the benchmark that imports the
program.
"""

from __future__ import annotations

import dataclasses
import tempfile
from typing import Dict, List

import numpy as np
import torch

from bench_port import inputs


def program_config(config: dict, traffic: dict):
    """``ConzicConfig`` at its defaults, with the configuration's run
    settings and the traffic's generation settings."""
    from conzic_torch.config import ConzicConfig

    cfg = ConzicConfig()
    for key, value in config["run"].items():
        setattr(cfg, key, value)
    cfg.batch_size = traffic["images_per_request"]
    cfg.samples_num = traffic["samples"]
    cfg.candidate_k = traffic["candidate_k"]
    cfg.sentence_len = traffic["sentence_len"]
    cfg.num_iterations = traffic["iterations"]
    cfg.order = traffic["order"]
    cfg.prompt = traffic["prompt"]
    cfg.lm_temperature = traffic["lm_temperature"]
    cfg.alpha, cfg.beta = traffic["alpha"], traffic["beta"]
    cfg.validate()
    return cfg


def build(config: dict, traffic: dict, weights: Dict[str, torch.Tensor],
          wp_vocab: Dict[str, int], device):
    """The ``Captioner`` over the benchmark's vocabularies and weights."""
    from conzic_torch.engine.sampler import Captioner, build_towers
    from conzic_torch.models.configs import BertConfig, CLIPConfig
    from conzic_torch.models.convert import from_hf_state_dict
    from conzic_torch.text.bpe import CLIPBPETokenizer
    from conzic_torch.text.wordpiece import WordPieceTokenizer

    cfg = program_config(config, traffic)
    wp = WordPieceTokenizer(wp_vocab)
    with tempfile.TemporaryDirectory(prefix="bench_port_bpe_") as d:
        bpe = CLIPBPETokenizer.from_files(*inputs.write_bpe_files(
            d, config["match"]["text_config"]["vocab_size"]))
    bert_config = BertConfig.from_hf_dict(config["lm"])
    clip_config = CLIPConfig.from_hf_dict(config["match"])
    with torch.device(device):
        bert, clip = build_towers(bert_config, clip_config, cfg)
    from_hf_state_dict(bert, weights)
    from_hf_state_dict(clip, weights)
    return Captioner(bert, clip, wp, bpe, cfg, device)


@dataclasses.dataclass
class Served:
    """What one request returned: the image embeddings the image tower
    gave, and per sample the generation's rows, its per-iteration cosines
    and the texts ``generate_caption`` decoded."""
    pixel_seed: int
    schedule_seed: int
    image_embeds: torch.Tensor  # (B, D) as encode_images returned them
    iter_ids: List[np.ndarray] = dataclasses.field(default_factory=list)
    cosines: List[List[List[float]]] = dataclasses.field(default_factory=list)
    texts: List[List[List[str]]] = dataclasses.field(default_factory=list)


class Driver:
    """Runs requests through a captioner, keeping what each returned."""

    def __init__(self, captioner, traffic: dict):
        from conzic_torch.runtime.logging import null_logger

        self.cap, self.traffic = captioner, traffic
        self.logger = null_logger()
        self._results: list = []
        run = captioner.run

        def recording_run(*args, **kwargs):
            result = run(*args, **kwargs)
            self._results.append(result)
            return result

        # generate_caption calls captioner.run: keep its result's rows
        captioner.run = recording_run

    def request(self, pixels: torch.Tensor, pixel_seed: int,
                schedule_seed: int, iterations: int = 0) -> Served:
        """One request: the image tower, then every sample; the schedule
        of the samples is drawn from one ``RandomState`` in turn, as the
        app and the command line share one. ``iterations`` overrides the
        traffic's (the warm-up's one iteration)."""
        from conzic_torch.engine.sampler import generate_caption

        t = self.traffic
        B = t["images_per_request"]
        rng = np.random.RandomState(schedule_seed)
        embeds = self.cap.encode_images(pixels)
        served = Served(pixel_seed, schedule_seed, embeds)
        names = [f"img{b}" for b in range(B)]
        for _ in range(t["samples"]):
            texts, cosines = generate_caption(
                names, self.cap, embeds, self.logger, prompt=t["prompt"],
                batch_size=B, max_len=t["sentence_len"],
                top_k=t["candidate_k"], temperature=t["lm_temperature"],
                max_iter=iterations or t["iterations"], alpha=t["alpha"],
                beta=t["beta"], generate_order=t["order"], rng=rng)
            served.iter_ids.append(self._results.pop().iter_ids)
            served.cosines.append(cosines)
            served.texts.append(texts)
        return served
