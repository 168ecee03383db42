"""The system under test, driven as its users drive it.

Builds ``conzic_torch``'s ``Captioner`` through the port's public
constructors from the benchmark's inputs, and runs one request the way
``conzic_torch.api.run`` runs a batch and the web app's Submit callback
(``conzic_torch.api.app.make_demo_fn``) runs an image: the image tower
once, then ``generate_caption`` once per sample, which decodes the texts
on the host. This module and the tower families' ``program`` builders
(``bench_port/families/``) are the only code of the benchmark that
builds the program.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List

import numpy as np
import torch


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


def build(config: dict, traffic: dict, families: dict, vocab: dict,
          weights: Dict[str, torch.Tensor], device):
    """The ``Captioner`` over the benchmark's vocabularies and weights;
    ``families`` and ``vocab``: the proposer's and the matcher's family
    modules and vocabularies, by role ("lm", "match")."""
    from conzic_torch.engine.sampler import Captioner, build_towers
    from conzic_torch.models.convert import from_hf_state_dict

    cfg = program_config(config, traffic)
    (lm_tok, lm_cfg), (match_tok, match_cfg) = (
        families[r].program(config, vocab[r]) for r in ("lm", "match"))
    with torch.device(device):
        lm, match = build_towers(lm_cfg, match_cfg, cfg)
    from_hf_state_dict(lm, weights)
    from_hf_state_dict(match, weights)
    return Captioner(lm, match, lm_tok, match_tok, cfg, device)


def weights_bytes(captioner) -> int:
    """Bytes of the parameters and buffers of the captioner's towers as
    the program holds them, each storage once (tied weights are one)."""
    seen, total = set(), 0
    for module in vars(captioner).values():
        if not isinstance(module, torch.nn.Module):
            continue
        for t in itertools.chain(module.parameters(), module.buffers()):
            storage = t.untyped_storage()
            if storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                total += storage.nbytes()
    return total


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
