"""The inputs the benchmark makes from ``--seed`` and hands to both sides:
the vocabularies, the weights of both towers, the pixels of every request
and the schedule seeds.

Everything here is the benchmark's own: the program under test and the
plain reference read what these functions make, and neither makes any of
it. The weights are a Hugging Face state dict (here ``BertForMaskedLM``'s
and ``CLIPModel``'s names and layouts), drawn on the device in a few large
calls. The tower families (``bench_port/families/``) choose what of this
each configuration uses.
"""

from __future__ import annotations

import functools
import itertools
import json
import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

# the synthetic WordPiece vocabulary at bert-base-uncased's cardinality:
# specials, punctuation, digits, [unusedN] slots, a few real words and
# generated alphabetic words, every seventh a ## continuation
_WORDS = (
    "image of a the girl boy dog cat red blue small big beautiful happy sad "
    "young old wooden sitting standing running smiling wearing holding looking "
    "hat dress shirt park beach street tree flower sky cloud water grass "
    "playing play ing walk walking man woman child person two three with on in "
    "at by near under over white black green yellow brown little large tiny "
    "huge pretty lovely nice sunny dark bright colorful"
).split()

CONSONANTS, VOWELS = "bcdfghjklmnpqrstvwz", "aeiou"


def wordpiece_vocab(vocab_size: int) -> Dict[str, int]:
    """token -> id, ``vocab_size`` entries."""
    tokens: List[str] = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += list(".,!?;:'\"-()[]{}$%&*+/<=>@\\^_`|~#")
    tokens += [str(d) for d in range(10)]
    tokens += [f"[unused{i}]" for i in range(min(994, vocab_size // 30))]
    seen = set(tokens)
    for w in _WORDS:
        if w not in seen:
            tokens.append(w)
            seen.add(w)
    consonants, vowels = CONSONANTS, VOWELS
    nc, nv = len(consonants), len(vowels)
    i = 0
    while len(tokens) < vocab_size:
        word = (consonants[i % nc] + vowels[(i // nc) % nv]
                + consonants[(i // (nc * nv)) % nc]
                + vowels[(i // (nc * nv * nc)) % nv])
        tail = i // (nc * nv) ** 2
        if tail:
            word += f"x{tail}"
        if i % 7 == 3:
            word = "##" + word
        if word not in seen:
            tokens.append(word)
            seen.add(word)
        i += 1
    return {t: j for j, t in enumerate(tokens[:vocab_size])}


# ---------------------------------------------------------------------------
# CLIP's byte-level BPE at the published size, made synthetically
# ---------------------------------------------------------------------------

def bytes_to_unicode() -> List[str]:
    """The 256 characters of the byte-level alphabet, in CLIP's order:
    printable latin-1 bytes as themselves, the others shifted past 255."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    chars = list(keep)
    n = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + n)
            n += 1
    return [chr(c) for c in chars]


def _encode(word: str, rank: Dict[Tuple[str, str], int]) -> List[str]:
    """BPE of one lower-case word: its characters, the last marked
    ``</w>``, merged pair by pair, the lowest-ranked pair first."""
    parts = list(word[:-1]) + [word[-1] + "</w>"]
    while len(parts) > 1:
        pairs = [(rank[p], i) for i, p in enumerate(zip(parts, parts[1:]))
                 if p in rank]
        if not pairs:
            break
        i = min(pairs)[1]
        parts[i:i + 2] = [parts[i] + parts[i + 1]]
    return parts


@functools.lru_cache(maxsize=None)
def clip_bpe(vocab_size: int) -> Tuple[Dict[str, int],
                                       Tuple[Tuple[str, str], ...]]:
    """(vocab, merges) of a CLIP BPE with ``vocab_size`` entries, built as
    CLIP's is: the 256 byte characters, their ``</w>`` forms, one entry a
    merge, and the two specials last. The merges make every alphabetic
    body of :func:`wordpiece_vocab` one piece with ``</w>``, as CLIP's
    49,408 entries do for common words: consonant-vowel pairs, then each
    generated word from two pairs, then each real word by a chain of
    merges ranked after all earlier ones (so no earlier word's encoding
    changes). The rest are the generated stems and stems plus a consonant,
    words that BERT's vocabulary lacks, as CLIP's has many."""
    merges: List[Tuple[str, str]] = []
    made = set()

    def merge(a: str, b: str) -> None:
        if a + b not in made:
            merges.append((a, b))
            made.add(a + b)

    pairs = [c + v for v in VOWELS for c in CONSONANTS]
    for c in CONSONANTS:
        for v in VOWELS:
            merge(c, v)
            merge(c, v + "</w>")
    for a in pairs:
        for b in pairs:
            merge(a, b + "</w>")
    rank = {m: i for i, m in enumerate(merges)}
    for word in _WORDS:
        parts = _encode(word, rank)
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            merge(*pair)
            if merges[-1] != pair:
                raise ValueError(f"{word!r}: another merge makes "
                                 f"{''.join(pair)!r}")
            rank[pair] = len(merges) - 1
            parts[:2] = ["".join(pair)]
    n_merges = vocab_size - 2 * 256 - 2
    stems = (a + b for a in pairs for b in pairs)
    fill = ((a, b) for a in pairs for b in pairs)
    extra = ((s, c + "</w>") for s in stems for c in CONSONANTS)
    for a, b in itertools.chain(fill, extra):
        if len(merges) >= n_merges:
            break
        merge(a, b)
    if len(merges) != n_merges:
        raise ValueError(f"a BPE of {vocab_size} entries holds "
                         f"{n_merges} merges; this one makes {len(merges)}")
    chars = bytes_to_unicode()
    tokens = (chars + [c + "</w>" for c in chars]
              + ["".join(m) for m in merges]
              + ["<|startoftext|>", "<|endoftext|>"])
    vocab = {t: i for i, t in enumerate(tokens)}
    assert len(vocab) == vocab_size
    return vocab, tuple(merges)


def write_bpe_files(directory: str, bpe) -> Tuple[str, str]:
    """vocab.json and merges.txt of ``bpe``, a :func:`clip_bpe`, in
    ``directory``."""
    vocab, merges = bpe
    vocab_path = os.path.join(directory, "vocab.json")
    merges_path = os.path.join(directory, "merges.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return vocab_path, merges_path


# ---------------------------------------------------------------------------
# weights: a Hugging Face state dict, made on the device from the seed
# ---------------------------------------------------------------------------

WEIGHT_STD = 0.02  # N(0, 0.02) matrices and embeddings, as BERT and CLIP init


def _encoder(prefix: str, names: Dict[str, str], n_layers: int, E: int,
             F: int) -> List[Tuple[str, tuple, str]]:
    out = []
    for i in range(n_layers):
        p = f"{prefix}{i}."
        for key in ("q", "k", "v", "o"):
            out += [(p + names[key] + ".weight", (E, E), "normal"),
                    (p + names[key] + ".bias", (E,), "bias")]
        for key in ("ln1", "ln2"):
            out += [(p + names[key] + ".weight", (E,), "scale"),
                    (p + names[key] + ".bias", (E,), "bias")]
        out += [(p + names["fc1"] + ".weight", (F, E), "normal"),
                (p + names["fc1"] + ".bias", (F,), "bias"),
                (p + names["fc2"] + ".weight", (E, F), "normal"),
                (p + names["fc2"] + ".bias", (E,), "bias")]
    return out


_BERT_LAYER = {"q": "attention.self.query", "k": "attention.self.key",
               "v": "attention.self.value", "o": "attention.output.dense",
               "ln1": "attention.output.LayerNorm",
               "fc1": "intermediate.dense", "fc2": "output.dense",
               "ln2": "output.LayerNorm"}
_CLIP_LAYER = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
               "v": "self_attn.v_proj", "o": "self_attn.out_proj",
               "ln1": "layer_norm1", "fc1": "mlp.fc1", "fc2": "mlp.fc2",
               "ln2": "layer_norm2"}


def _ln(name: str, E: int) -> List[Tuple[str, tuple, str]]:
    return [(name + ".weight", (E,), "scale"), (name + ".bias", (E,), "bias")]


def bert_spec(lm: dict) -> List[Tuple[str, tuple, str]]:
    """(HF name, shape, kind) of every tensor of ``BertForMaskedLM`` (the
    decoder is tied to the word embeddings)."""
    E, F = lm["hidden_size"], lm["intermediate_size"]
    V = lm["vocab_size"]
    out = [("bert.embeddings.word_embeddings.weight", (V, E), "normal"),
           ("bert.embeddings.position_embeddings.weight",
            (lm["max_position_embeddings"], E), "normal"),
           ("bert.embeddings.token_type_embeddings.weight",
            (lm["type_vocab_size"], E), "normal")]
    out += _ln("bert.embeddings.LayerNorm", E)
    out += _encoder("bert.encoder.layer.", _BERT_LAYER,
                    lm["num_hidden_layers"], E, F)
    out += [("cls.predictions.transform.dense.weight", (E, E), "normal"),
            ("cls.predictions.transform.dense.bias", (E,), "bias")]
    out += _ln("cls.predictions.transform.LayerNorm", E)
    out += [("cls.predictions.bias", (V,), "bias")]
    return out


def clip_spec(match: dict) -> List[Tuple[str, tuple, str]]:
    """(HF name, shape, kind) of every tensor of ``CLIPModel``."""
    t, v = match["text_config"], match["vision_config"]
    Et, Ev, D = t["hidden_size"], v["hidden_size"], match["projection_dim"]
    n_pos = (v["image_size"] // v["patch_size"]) ** 2 + 1
    out = [("text_model.embeddings.token_embedding.weight",
            (t["vocab_size"], Et), "normal"),
           ("text_model.embeddings.position_embedding.weight",
            (t["max_position_embeddings"], Et), "normal")]
    out += _encoder("text_model.encoder.layers.", _CLIP_LAYER,
                    t["num_hidden_layers"], Et, t["intermediate_size"])
    out += _ln("text_model.final_layer_norm", Et)
    out += [("vision_model.embeddings.class_embedding", (Ev,), "normal"),
            ("vision_model.embeddings.patch_embedding.weight",
             (Ev, v["num_channels"], v["patch_size"], v["patch_size"]),
             "normal"),
            ("vision_model.embeddings.position_embedding.weight",
             (n_pos, Ev), "normal")]
    out += _ln("vision_model.pre_layrnorm", Ev)
    out += _encoder("vision_model.encoder.layers.", _CLIP_LAYER,
                    v["num_hidden_layers"], Ev, v["intermediate_size"])
    out += _ln("vision_model.post_layernorm", Ev)
    out += [("visual_projection.weight", (D, Ev), "normal"),
            ("text_projection.weight", (D, Et), "normal"),
            ("logit_scale", (), "fixed")]
    return out


def make_weights(spec: List[Tuple[str, tuple, str]], seed: int,
                 device, fixed: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """One fp32 state dict for ``spec``: matrices and embeddings
    N(0, WEIGHT_STD), biases N(0, WEIGHT_STD), LayerNorm scales
    1 + N(0, WEIGHT_STD), a "fixed" scalar as ``fixed`` gives it by name
    (the configuration's ``weights``). Two draws of one seeded generator
    on ``device``; every tensor is a view of them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {"normal": 0, "small": 0}
    for _, shape, kind in spec:
        if kind != "fixed":
            sizes["normal" if kind == "normal" else "small"] += math.prod(shape)
    bufs = {k: torch.randn(n, generator=gen, device=device).mul_(WEIGHT_STD)
            for k, n in sizes.items()}
    offs = {"normal": 0, "small": 0}
    out = {}
    for name, shape, kind in spec:
        if kind == "fixed":
            out[name] = torch.tensor(fixed[name], device=device)
            continue
        k = "normal" if kind == "normal" else "small"
        n = math.prod(shape)
        t = bufs[k][offs[k]:offs[k] + n].view(shape)
        offs[k] += n
        if kind == "scale":
            t.add_(1.0)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# per-request inputs
# ---------------------------------------------------------------------------

class Seeds:
    """Every seed of a run, derived from ``--seed`` (any whole number that
    numpy's ``SeedSequence`` takes) so that the same seed gives the same
    inputs."""

    def __init__(self, seed: int):
        self.root = np.random.SeedSequence(int(seed))
        weights, self._requests, self._check = self.root.spawn(3)
        self.weights = int(weights.generate_state(1, np.uint64)[0] >> 1)

    def request(self, r: int) -> Tuple[int, int]:
        """(pixel seed, schedule seed) of request ``r``."""
        s = np.random.SeedSequence(self._requests.entropy,
                                   spawn_key=self._requests.spawn_key + (r,))
        a, b = s.generate_state(2, np.uint32)
        return int(a), int(b)

    def check_rng(self) -> np.random.Generator:
        """The draw of what the correctness check samples."""
        return np.random.default_rng(self._check)


def pixels(seed: int, batch: int, image_size: int, channels: int,
           device, mean: Tuple[float, ...], std: Tuple[float, ...]
           ) -> torch.Tensor:
    """(batch, H, W, C) pixels, NHWC, fp32, on ``device``: uniform in
    [0, 1), then normalised by the matcher's per-channel ``mean`` and
    ``std``, as a preprocessed photograph is."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((batch, image_size, image_size, channels), generator=gen,
                   device=device)
    mean = torch.tensor(mean[:channels], device=device)
    std = torch.tensor(std[:channels], device=device)
    return (x - mean) / std
