"""SDAR's mixture-of-experts block-diffusion LM as the proposer
(``sdar_moe``, ``conzic_torch/models/sdar.py``): a synthetic Qwen2
byte-level BPE at the configuration's vocabulary size, the weights' names
(the held experts' only), the program's ``SdarMoeConfig`` and
``QwenBPETokenizer``, the reference's logits at the slot and its text
rules, and SDAR's share of a request's operations."""

from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port import inputs
from bench_port.reference.sdar import (
    END_OF_TEXT,
    MASK,
    SPACE,
    QwenText,
    Sdar,
    byte_chars,
)

# the added tokens above the pieces: Qwen3's first three, then reserved
# slots, SDAR's mask at the 27th (id 151,669 at the published 151,936)
N_ADDED = 293
MASK_AT = 26
FIRST_ADDED = ("<|im_start|>", "<|im_end|>")
# words the vocabulary makes whole first: the prompt's first word, then
# the synthetic WordPiece vocabulary's real words
WORDS = ("Image",) + tuple(dict.fromkeys(inputs._WORDS))


def _bpe(parts: List[str], rank: Dict[Tuple[str, str], int]) -> List[str]:
    """Byte characters merged pair by pair, the lowest-ranked pair first."""
    parts = list(parts)
    while len(parts) > 1:
        pairs = [(rank[p], i) for i, p in enumerate(zip(parts, parts[1:]))
                 if p in rank]
        if not pairs:
            break
        i = min(pairs)[1]
        parts[i:i + 2] = [parts[i] + parts[i + 1]]
    return parts


@functools.lru_cache(maxsize=None)
def qwen_bpe(vocab_size: int) -> Tuple[Dict[str, int],
                                       Tuple[Tuple[str, str], ...],
                                       Dict[int, str]]:
    """(pieces, merges, added) of a Qwen2-style byte-level BPE with
    ``vocab_size`` ids: the 256 byte characters, one piece a merge, then
    ``N_ADDED`` special tokens (``<|endoftext|>`` first, ``<|MASK|>`` at
    ``MASK_AT``). The merges, in rank order: consonant-vowel pairs, each
    after a space; ``WORDS`` whole, after a space and bare, each by a
    chain of merges ranked after all earlier ones (so no earlier word's
    pieces change); four-letter words of two pairs, bare and after a
    space; then five-letter ones after a space to the size. So "Image of
    a" is three pieces and every caption word one."""
    n_merges = vocab_size - N_ADDED - 256
    merges: List[Tuple[str, str]] = []
    alphabet = list(byte_chars().values())
    made = set(alphabet)
    rank: Dict[Tuple[str, str], int] = {}

    def merge(a: str, b: str) -> bool:
        if a + b in made or len(merges) >= n_merges:
            return False
        rank[(a, b)] = len(merges)
        merges.append((a, b))
        made.add(a + b)
        return True

    c, v = inputs.CONSONANTS, inputs.VOWELS
    pairs = [a + b for a in c for b in v]
    for p in pairs:
        merge(p[0], p[1])
    for p in pairs:
        merge(SPACE, p)
    for word in WORDS:
        for form in (SPACE + word, word):
            parts = _bpe(list(form), rank)
            while len(parts) > 1:
                if not merge(parts[0], parts[1]):
                    raise ValueError(f"{form!r} cannot be made whole in a "
                                     f"vocabulary of {vocab_size}")
                parts[:2] = [parts[0] + parts[1]]
    for a in pairs:
        for b in pairs:
            merge(a, b)
            merge(SPACE + a, b)
    for a in pairs:
        for b in pairs:
            for x in c:
                merge(SPACE + a + b, x)
    if len(merges) != n_merges:
        raise ValueError(f"a vocabulary of {vocab_size} holds {n_merges} "
                         f"merges; this one makes {len(merges)}")
    tokens = alphabet + ["".join(m) for m in merges]
    pieces = {t: i for i, t in enumerate(tokens)}
    names = [END_OF_TEXT, *FIRST_ADDED]
    names += [f"<|reserved_{j}|>" for j in range(N_ADDED - len(names))]
    names.insert(MASK_AT, MASK)
    names.pop()
    added = {len(tokens) + j: t for j, t in enumerate(names)}
    return pieces, tuple(merges), added


def vocab(config: dict):
    return qwen_bpe(config["lm"]["vocab_size"])


def write_tokenizer_files(directory: str, vocab) -> None:
    """vocab.json, merges.txt and tokenizer_config.json of ``vocab``, a
    :func:`qwen_bpe`, as a Qwen2 checkpoint directory holds them."""
    pieces, merges, added = vocab
    with open(os.path.join(directory, "vocab.json"), "w",
              encoding="utf-8") as f:
        json.dump(pieces, f)
    with open(os.path.join(directory, "merges.txt"), "w",
              encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(os.path.join(directory, "tokenizer_config.json"), "w",
              encoding="utf-8") as f:
        json.dump({"added_tokens_decoder": {
            str(i): {"content": t, "special": True}
            for i, t in added.items()}}, f)


def held(lm: dict) -> range:
    first = lm.get("expert_offset", 0)
    return range(first, first + lm.get("experts_held", lm["num_experts"]))


def spec(config: dict):
    """(HF name, shape, kind) of every tensor this device holds of
    ``SDARMoeForCausalLM``: the held experts' only."""
    lm = config["lm"]
    E, V, D = lm["hidden_size"], lm["vocab_size"], lm["head_dim"]
    HD, GD = lm["num_attention_heads"] * D, lm["num_key_value_heads"] * D
    width = lm["moe_intermediate_size"]
    out = [("model.embed_tokens.weight", (V, E), "normal")]
    for i in range(lm["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (E,), "scale"),
                (p + "self_attn.q_proj.weight", (HD, E), "normal"),
                (p + "self_attn.k_proj.weight", (GD, E), "normal"),
                (p + "self_attn.v_proj.weight", (GD, E), "normal"),
                (p + "self_attn.o_proj.weight", (E, HD), "normal"),
                (p + "self_attn.q_norm.weight", (D,), "scale"),
                (p + "self_attn.k_norm.weight", (D,), "scale"),
                (p + "post_attention_layernorm.weight", (E,), "scale"),
                (p + "mlp.gate.weight", (lm["num_experts"], E), "normal")]
        # each held expert's gate and up, then their downs: the order in
        # which the program stacks them, so that it loads views of the draw
        for e in held(lm):
            x = f"{p}mlp.experts.{e}."
            out += [(x + "gate_proj.weight", (width, E), "normal"),
                    (x + "up_proj.weight", (width, E), "normal")]
        out += [(f"{p}mlp.experts.{e}.down_proj.weight", (E, width),
                 "normal") for e in held(lm)]
    out += [("model.norm.weight", (E,), "scale"),
            ("lm_head.weight", (V, E), "normal")]
    return out


def program(config: dict, vocab):
    from conzic_torch.models.configs import SdarMoeConfig
    from conzic_torch.text.qwen_bpe import QwenBPETokenizer

    with tempfile.TemporaryDirectory(prefix="bench_port_qwen_") as d:
        write_tokenizer_files(d, vocab)
        tokenizer = QwenBPETokenizer.from_pretrained(d)
    return tokenizer, SdarMoeConfig.from_hf_dict(config["lm"])


class Proposer:
    def __init__(self, weights, config: dict, vocab,
                 lowp: Optional[str] = None):
        self.text = QwenText(*vocab)
        self.ref = Sdar(weights, config["lm"], lowp)
        self.device = weights["lm_head.weight"].device

    def logits(self, state: np.ndarray, col: int) -> torch.Tensor:
        masked = torch.tensor(state, device=self.device, dtype=torch.long)
        masked[:, col] = self.text.mask
        cols = torch.full((state.shape[0],), col, device=self.device,
                          dtype=torch.long)
        return self.ref.logits(masked, cols)


reference = Proposer


def visible_keys(S: int, block: int) -> int:
    """The keys the queries of an S-position row see under the block rule,
    summed over the queries."""
    return sum(min(S, (i // block + 1) * block) for i in range(S))


def flops(config: dict, traffic: dict) -> Dict[str, float]:
    """Per Gibbs step: every layer at every position of the B rows
    (<|endoftext|> prompt slots <|endoftext|>): the projections and the
    router at each, attention over the keys the block rule shows, and the
    held experts at the rows routed to them, as many as uniform routing
    gives, tokens x top k x held / experts, never all the experts; then
    the head at the one masked slot."""
    lm = config["lm"]
    B, L = traffic["images_per_request"], traffic["sentence_len"]
    E, D = lm["hidden_size"], lm["head_dim"]
    HD, GD = lm["num_attention_heads"] * D, lm["num_key_value_heads"] * D
    n = lm["num_experts"]
    S = len(traffic["prompt"].split()) + L + 2
    token = 2 * E * (2 * HD + 2 * GD) + 2 * E * n
    token += (lm["num_experts_per_tok"] * len(held(lm)) / n
              * 3 * 2 * E * lm["moe_intermediate_size"])
    attention = 4 * HD * visible_keys(S, lm.get("block_length", 4))
    step = lm["num_hidden_layers"] * B * (S * token + attention)
    step += B * 2 * E * lm["vocab_size"]
    return {"step": step}
