"""OpenAI's CLIP as the matcher (``CLIPModel``): the synthetic byte-level
BPE, the weights' names, the program's ``CLIPConfig`` and
``CLIPBPETokenizer``, CLIP's pixel statistics, the reference's causal
text tower pooled at the end token, its class-token ViT and its scaled
cosines, and CLIP's share of a request's operations."""

from __future__ import annotations

import tempfile
from typing import Dict, Optional

import torch

from bench_port import inputs
from bench_port.flops import layer
from bench_port.reference.models import Reference
from bench_port.reference.text import ClipBpe, clip_row

# CLIP's preprocessing statistics: pixels are uniform in [0, 1), then
# normalised as a preprocessed photograph is
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def vocab(config: dict):
    """(vocab, merges) of the BPE at the text tower's vocabulary size."""
    return inputs.clip_bpe(config["match"]["text_config"]["vocab_size"])


def spec(config: dict):
    return inputs.clip_spec(config["match"])


def program(config: dict, vocab):
    from conzic_torch.models.configs import CLIPConfig
    from conzic_torch.text.bpe import CLIPBPETokenizer

    with tempfile.TemporaryDirectory(prefix="bench_port_bpe_") as d:
        bpe = CLIPBPETokenizer.from_files(*inputs.write_bpe_files(d, vocab))
    return bpe, CLIPConfig.from_hf_dict(config["match"])


def pixels(config: dict, seed: int, batch: int, device) -> torch.Tensor:
    v = config["match"]["vision_config"]
    return inputs.pixels(seed, batch, v["image_size"], v["num_channels"],
                         device, MEAN, STD)


class Matcher:
    def __init__(self, weights, config: dict, vocab,
                 lowp: Optional[str] = None):
        self.bpe = ClipBpe(*vocab)
        self.ref = Reference(weights, None, config["match"], self.bpe.eos,
                             lowp)
        self.clip_len = config["run"]["clip_len"]
        self.scale = self.ref.logit_scale()

    def row(self, text, ids):
        """A proposer row ([CLS] caption [SEP]) as CLIP's row of
        ``clip_len`` ids, and its number of valid positions."""
        return clip_row(text, self.bpe, ids[1:-1], self.clip_len)

    def text_embeds(self, ids: torch.Tensor, n_valid: torch.Tensor):
        return self.ref.text_embeds(ids, n_valid)

    def image_embeds(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.ref.image_embeds(pixels)

    def logits(self, cos: torch.Tensor) -> torch.Tensor:
        return self.scale * cos


reference = Matcher


def flops(config: dict, traffic: dict) -> Dict[str, float]:
    """Per Gibbs step: the text tower over the B * k candidate rows'
    suffix positions (the clip_len context less the prompt prefix,
    padding included: the context is fixed), each attending the prefix
    and its causal reach, then the pooled row's final projection. Per
    sample: the prompt prefix through the text tower once per image. Per
    request: the vision tower over the B images."""
    match = config["match"]
    t, v = match["text_config"], match["vision_config"]
    B, k = traffic["images_per_request"], traffic["candidate_k"]
    clip_len = config["run"]["clip_len"]
    D = match["projection_dim"]

    Et, Ft = t["hidden_size"], t["intermediate_size"]
    bpe = ClipBpe(*vocab(config))
    P = 1 + sum(len(bpe.word(w)) for w in traffic["prompt"].split())
    Ss = clip_len - P
    keys = P + (Ss + 1) / 2  # mean keys a suffix position attends
    text = t["num_hidden_layers"] * B * k * Ss * (layer(Et, Ft)
                                                  + 4 * keys * Et)
    text += B * k * 2 * Et * D
    prefix = t["num_hidden_layers"] * B * P * (layer(Et, Ft)
                                               + 4 * (P + 1) / 2 * Et)

    Ev, Fv = v["hidden_size"], v["intermediate_size"]
    p = v["patch_size"]
    T = (v["image_size"] // p) ** 2 + 1
    vision = v["num_hidden_layers"] * B * T * (layer(Ev, Fv) + 4 * T * Ev)
    vision += B * (T - 1) * 2 * v["num_channels"] * p * p * Ev
    vision += B * 2 * Ev * D
    return {"step": text, "sample": prefix, "request": vision}
