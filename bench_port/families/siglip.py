"""SigLIP as the matcher (``SiglipModel``): a synthetic SentencePiece
Unigram vocabulary, the weights' names, the program's ``SiglipConfig`` and
``SiglipTokenizer``, SigLIP's pixel statistics, the reference's
bidirectional text tower over whole rows pooled at the last position, its
patch ViT with the attention-pooling head and its biased scores, and
SigLIP's share of a request's operations."""

from __future__ import annotations

import itertools
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

from bench_port import inputs
from bench_port.flops import layer
from bench_port.reference.siglip import SPECIALS, WORD_START, Siglip, Unigram
from bench_port.reference.text import body

# SigLIP's preprocessing statistics: pixels are uniform in [0, 1), then
# normalised as a preprocessed photograph is
MEAN = STD = (0.5, 0.5, 0.5)
# the first pieces of SigLIP's spiece.model, and its unknown piece
SPECIAL_PIECES = ("<pad>", "</s>", "<unk>")
UNK_ID = 2


def _words(lm_vocab_size: int) -> List[str]:
    """The canonical words of every non-special token of the synthetic
    WordPiece vocabulary (``##`` bodies alike), in its order, once each."""
    rules = Unigram([(p, 0.0) for p in SPECIAL_PIECES], UNK_ID)
    seen: Dict[str, None] = {}
    for token in inputs.wordpiece_vocab(lm_vocab_size):
        if token not in SPECIALS:
            seen.update(dict.fromkeys(rules.canonical(body(token))))
    return list(seen)


def unigram_vocab(size: int, lm_vocab_size: int) -> List[Tuple[str, float]]:
    """[(piece, score)] of ``size`` pieces, as a ``tokenizer.json`` lists
    them: the three specials; "▁" + every word of the proposer's
    vocabulary, scored in [-9, -8), so that each is one piece; "▁", the
    letters and the digits at -10; then word-inner syllables below -11 to
    the size. Any cut of a word into two or more pieces scores under -18,
    so no word is ever cut."""
    words = _words(lm_vocab_size)
    pieces = [(p, 0.0) for p in SPECIAL_PIECES]
    pieces += [(WORD_START + w, -8.0 - i / len(words))
               for i, w in enumerate(words)]
    chars = WORD_START + "abcdefghijklmnopqrstuvwxyz0123456789"
    pieces += [(c, -10.0) for c in chars]
    c, v = inputs.CONSONANTS, inputs.VOWELS
    syllables = itertools.chain(
        (a + b for a in c for b in v),
        (a + b + d for a in c for b in v for d in c),
        (a + b + d + e for a in c for b in v for d in c for e in v),
        (a + b + d + e + f for a in c for b in v for d in c for e in v
         for f in c))
    fill = size - len(pieces)
    if fill < 0:
        raise ValueError(f"{len(pieces)} pieces do not fit a vocabulary "
                         f"of {size}")
    pieces += [(s, -11.0 - i / max(fill, 1))
               for i, s in enumerate(itertools.islice(syllables, fill))]
    if len(pieces) != size:
        raise ValueError(f"made {len(pieces)} pieces of {size}")
    return pieces


def vocab(config: dict) -> List[Tuple[str, float]]:
    return unigram_vocab(config["match"]["text_config"]["vocab_size"],
                         config["lm"]["vocab_size"])


def _ln(name: str, E: int):
    return [(name + ".weight", (E,), "scale"), (name + ".bias", (E,), "bias")]


def _linear(name: str, n_out: int, n_in: int):
    return [(name + ".weight", (n_out, n_in), "normal"),
            (name + ".bias", (n_out,), "bias")]


def _encoder(prefix: str, cfg: dict):
    E, F = cfg["hidden_size"], cfg["intermediate_size"]
    out = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"{prefix}.encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += _linear(p + "self_attn." + proj, E, E)
        out += _ln(p + "layer_norm1", E)
        out += _linear(p + "mlp.fc1", F, E) + _linear(p + "mlp.fc2", E, F)
        out += _ln(p + "layer_norm2", E)
    return out


def spec(config: dict):
    """(HF name, shape, kind) of every tensor of ``SiglipModel``; the two
    scalars are the configuration's ``weights``."""
    t, v = config["match"]["text_config"], config["match"]["vision_config"]
    Et, Ev, Fv = t["hidden_size"], v["hidden_size"], v["intermediate_size"]
    p = v["patch_size"]
    out = [("text_model.embeddings.token_embedding.weight",
            (t["vocab_size"], Et), "normal"),
           ("text_model.embeddings.position_embedding.weight",
            (t["max_position_embeddings"], Et), "normal")]
    out += _encoder("text_model", t)
    out += _ln("text_model.final_layer_norm", Et)
    out += _linear("text_model.head", t.get("projection_size") or Et, Et)
    out += [("vision_model.embeddings.patch_embedding.weight",
             (Ev, v["num_channels"], p, p), "normal"),
            ("vision_model.embeddings.patch_embedding.bias", (Ev,), "bias"),
            ("vision_model.embeddings.position_embedding.weight",
             ((v["image_size"] // p) ** 2, Ev), "normal")]
    out += _encoder("vision_model", v)
    out += _ln("vision_model.post_layernorm", Ev)
    head = "vision_model.head."
    out += [(head + "probe", (1, 1, Ev), "normal"),
            (head + "attention.in_proj_weight", (3 * Ev, Ev), "normal"),
            (head + "attention.in_proj_bias", (3 * Ev,), "bias")]
    out += _linear(head + "attention.out_proj", Ev, Ev)
    out += _ln(head + "layernorm", Ev)
    out += _linear(head + "mlp.fc1", Fv, Ev) + _linear(head + "mlp.fc2",
                                                       Ev, Fv)
    out += [("logit_scale", (1,), "fixed"), ("logit_bias", (1,), "fixed")]
    return out


def program(config: dict, vocab):
    from conzic_torch.models.configs import SiglipConfig
    from conzic_torch.text.unigram import SiglipTokenizer

    with tempfile.TemporaryDirectory(prefix="bench_port_unigram_") as d:
        with open(os.path.join(d, "tokenizer.json"), "w",
                  encoding="utf-8") as f:
            json.dump({"model": {"type": "Unigram", "unk_id": UNK_ID,
                                 "vocab": [list(p) for p in vocab]}}, f)
        tokenizer = SiglipTokenizer.from_pretrained(d)
    return tokenizer, SiglipConfig.from_hf_dict(config["match"])


def pixels(config: dict, seed: int, batch: int, device) -> torch.Tensor:
    v = config["match"]["vision_config"]
    return inputs.pixels(seed, batch, v["image_size"], v["num_channels"],
                         device, MEAN, STD)


class Matcher:
    def __init__(self, weights, config: dict, vocab,
                 lowp: Optional[str] = None):
        self.rules = Unigram(vocab, UNK_ID)
        self.ref = Siglip(weights, config["match"], lowp)
        self.length = config["match"]["text_config"][
            "max_position_embeddings"]

    def row(self, text, ids):
        """A proposer row ([CLS] caption [SEP]) as SigLIP's row: each
        token's body tokenised as a word of its own, the end token,
        padding to the tower's positions."""
        words = [body(text.tokens[int(i)]) for i in ids[1:-1]
                 if text.tokens[int(i)] not in SPECIALS]
        return self.rules.row(words, self.length)

    def text_embeds(self, ids: torch.Tensor, n_valid: torch.Tensor):
        return self.ref.text_embeds(ids)  # rows run whole: n_valid unread

    def image_embeds(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.ref.image_embeds(pixels)

    def logits(self, cos: torch.Tensor) -> torch.Tensor:
        return self.ref.logits(cos)


reference = Matcher


def flops(config: dict, traffic: dict) -> Dict[str, float]:
    """Per Gibbs step: the text tower over every position of the B * k
    candidate rows (the row is whole: each position attends all), then
    the head of the pooled position. Nothing per sample: no prompt state
    is shared. Per request: the vision tower over the B images' patches,
    the patch convolution, and the pooling head (the probe's query, the
    patches' keys and values, its attention, ``out_proj`` and MLP)."""
    match = config["match"]
    t, v = match["text_config"], match["vision_config"]
    B, k = traffic["images_per_request"], traffic["candidate_k"]
    L = t["max_position_embeddings"]
    Et, Ft = t["hidden_size"], t["intermediate_size"]
    D = t.get("projection_size") or Et
    text = t["num_hidden_layers"] * B * k * L * (layer(Et, Ft) + 4 * L * Et)
    text += B * k * 2 * Et * D

    Ev, Fv = v["hidden_size"], v["intermediate_size"]
    p = v["patch_size"]
    T = (v["image_size"] // p) ** 2
    vision = v["num_hidden_layers"] * B * T * (layer(Ev, Fv) + 4 * T * Ev)
    vision += B * T * 2 * v["num_channels"] * p * p * Ev
    vision += B * (2 * Ev * Ev + T * 4 * Ev * Ev + 4 * T * Ev
                   + 2 * Ev * Ev + 4 * Ev * Fv)
    return {"step": text, "request": vision}
