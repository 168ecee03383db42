"""Procedurally rendered image-caption world of the trained checkpoints.

Counterpart of ``conzic_tpu/data/synthetic.py`` (numpy and PIL only):
scenes of coloured shapes at positions on coloured backgrounds, template
captions over a closed vocabulary, and the tokenizer files of that world.
The small CLIP and BERT of ``trained_tiny/`` and ``trained_mid/`` were
trained on it, so with those weights CLIP's cosine separates right captions
from wrong ones. Seeded scenes render the same arrays as the reference
package's, so the card can caption them with the trained checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# --- the closed caption language -------------------------------------------
# Words are purely-alphabetic ASCII so the engine's rule-derived stop mask
# (text/vocab.py) keeps all of them proposable.

COLORS: Dict[str, Tuple[int, int, int]] = {
    "red": (220, 40, 40),
    "blue": (45, 65, 220),
    "green": (40, 175, 60),
    "yellow": (235, 220, 50),
    "purple": (150, 60, 205),
    "orange": (240, 140, 30),
    "pink": (245, 130, 185),
    "brown": (140, 90, 40),
    "gray": (128, 128, 128),
    "white": (245, 245, 245),
}

BACKGROUNDS: Dict[str, Tuple[int, int, int]] = {
    "black": (15, 15, 15),
    "white": (235, 235, 235),
    "gray": (105, 105, 105),
    "blue": (25, 40, 120),
    "green": (25, 100, 40),
    "red": (120, 25, 25),
}

SHAPES = ("circle", "square", "triangle", "star", "cross",
          "ring", "diamond", "arrow")
SIZES = ("big", "small")
POSITIONS = ("top", "bottom", "left", "right", "middle")

# structure words used by the caption templates (and the engine prompt
# "Image of a", which WordPiece lowercases)
STRUCTURE_WORDS = (
    "image", "of", "a", "an", "the", "on", "at", "and", "background",
    "there", "is", "picture", "photo", "shows", "with",
)

# The RICH world's subjective modifiers: ungrounded (random per caption,
# CLIP cannot learn them from pixels) valence-bearing adjectives whose
# job is to make SENTIMENT CONTROL measurable on semantic weights: the
# trained LM proposes them at ADJ slots, the in-loop valence table
# scores them, and eval/sentiment_eval.py detects the shift. Every word
# is (a) in text.lexicons' curated valence table and (b) rule-tagged ADJ
# (so POS control/eval see them as adjectives).
VALENCE_ADJ = {
    "positive": ("lovely", "pretty", "beautiful", "gorgeous",
                 "delightful", "cute"),
    "negative": ("dreadful", "awful", "dirty", "dark", "cold"),
}


def caption_words(rich: bool = False) -> List[str]:
    """Every word the caption templates can emit (deduped, stable order)."""
    out: List[str] = []
    groups = [STRUCTURE_WORDS, SIZES, tuple(COLORS), tuple(BACKGROUNDS),
              SHAPES, POSITIONS]
    if rich:
        groups.append(VALENCE_ADJ["positive"] + VALENCE_ADJ["negative"])
    for group in groups:
        for w in group:
            if w not in out:
                out.append(w)
    return out


# --- scenes ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SceneObject:
    shape: str
    color: str
    size: str
    position: str


@dataclasses.dataclass(frozen=True)
class Scene:
    background: str
    objects: Tuple[SceneObject, ...]


def sample_scene(rng: np.random.RandomState, two_object_p: float = 0.35) -> Scene:
    """One or (with prob ``two_object_p``) two objects at distinct
    positions; the background color never names an object's color (keeps
    captions unambiguous)."""
    n = 2 if rng.rand() < two_object_p else 1
    positions = list(POSITIONS)
    rng.shuffle(positions)
    objs = []
    for i in range(n):
        objs.append(SceneObject(
            shape=SHAPES[rng.randint(len(SHAPES))],
            color=list(COLORS)[rng.randint(len(COLORS))],
            size=SIZES[rng.randint(len(SIZES))],
            position=positions[i],
        ))
    bgs = [b for b in BACKGROUNDS if all(b != o.color for o in objs)]
    return Scene(background=bgs[rng.randint(len(bgs))], objects=tuple(objs))


# position-zone centers in a unit square
_POS_CENTER = {
    "top": (0.5, 0.25),
    "bottom": (0.5, 0.75),
    "left": (0.25, 0.5),
    "right": (0.75, 0.5),
    "middle": (0.5, 0.5),
}


def _draw_shape(draw, shape: str, cx: float, cy: float, r: float, rgb):
    """Render one shape with PIL ImageDraw primitives."""
    if shape == "circle":
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=rgb)
    elif shape == "ring":
        w = max(2, int(r * 0.35))
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], outline=rgb, width=w)
    elif shape == "square":
        s = r * 0.9
        draw.rectangle([cx - s, cy - s, cx + s, cy + s], fill=rgb)
    elif shape == "triangle":
        draw.polygon([(cx, cy - r), (cx - r, cy + r * 0.8),
                      (cx + r, cy + r * 0.8)], fill=rgb)
    elif shape == "diamond":
        draw.polygon([(cx, cy - r), (cx + r * 0.7, cy),
                      (cx, cy + r), (cx - r * 0.7, cy)], fill=rgb)
    elif shape == "cross":
        w = r * 0.35
        draw.rectangle([cx - w, cy - r, cx + w, cy + r], fill=rgb)
        draw.rectangle([cx - r, cy - w, cx + r, cy + w], fill=rgb)
    elif shape == "star":
        pts = []
        for i in range(10):
            ang = -np.pi / 2 + i * np.pi / 5
            rad = r if i % 2 == 0 else r * 0.45
            pts.append((cx + rad * np.cos(ang), cy + rad * np.sin(ang)))
        draw.polygon(pts, fill=rgb)
    elif shape == "arrow":
        w = r * 0.3
        draw.rectangle([cx - r, cy - w, cx + r * 0.2, cy + w], fill=rgb)
        draw.polygon([(cx + r * 0.2, cy - r * 0.6), (cx + r, cy),
                      (cx + r * 0.2, cy + r * 0.6)], fill=rgb)
    else:  # pragma: no cover - guarded by SHAPES
        raise ValueError(f"unknown shape {shape!r}")


def render_scene(scene: Scene, image_size: int = 64):
    """Scene -> RGB PIL image (deterministic; no randomness here)."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (image_size, image_size),
                    BACKGROUNDS[scene.background])
    draw = ImageDraw.Draw(img)
    for obj in scene.objects:
        cx, cy = _POS_CENTER[obj.position]
        cx, cy = cx * image_size, cy * image_size
        r = image_size * (0.28 if obj.size == "big" else 0.11)
        _draw_shape(draw, obj.shape, cx, cy, r, COLORS[obj.color])
    return img


# --- captions ----------------------------------------------------------------


def _article(word: str) -> str:
    return "an" if word[0] in "aeiou" else "a"


def caption_scene(scene: Scene, rng: np.random.RandomState) -> str:
    """One of several template captions, lowercase, ending with '.'.

    Templates deliberately include the engine prompt's "image of a ..."
    shape (sampler prompt "Image of a", WordPiece-lowercased) so the
    generation-time text distribution is in-domain for the trained CLIP.
    """
    o = scene.objects[0]
    art = _article(o.size)
    if len(scene.objects) == 1:
        templates = [
            f"image of {art} {o.size} {o.color} {o.shape} at the {o.position} .",
            f"image of a {o.color} {o.shape} on a {scene.background} background .",
            f"{art} {o.size} {o.color} {o.shape} at the {o.position} on a "
            f"{scene.background} background .",
            f"the picture shows {art} {o.size} {o.color} {o.shape} "
            f"at the {o.position} .",
            f"there is a {o.color} {o.shape} at the {o.position} .",
        ]
    else:
        b = scene.objects[1]
        templates = [
            f"image of a {o.color} {o.shape} and a {b.color} {b.shape} .",
            f"a {o.color} {o.shape} at the {o.position} and a {b.color} "
            f"{b.shape} at the {b.position} .",
            f"image of a {o.size} {o.color} {o.shape} with a {b.size} "
            f"{b.color} {b.shape} on a {scene.background} background .",
        ]
    return templates[rng.randint(len(templates))]


def _valence_phrase(rng: np.random.RandomState, p: float = 0.5) -> str:
    """One ungrounded valence adjective (or '') — see VALENCE_ADJ."""
    if rng.rand() >= p:
        return ""
    polarity = "positive" if rng.rand() < 0.5 else "negative"
    words = VALENCE_ADJ[polarity]
    return words[rng.randint(len(words))] + " "


def caption_scene_rich(scene: Scene, rng: np.random.RandomState) -> str:
    """RICH-world caption: 14-21 words, full object descriptions with
    optional ungrounded valence adjectives (the mid-size world's channel
    for measuring sentiment control)."""
    o = scene.objects[0]
    v1 = _valence_phrase(rng)
    art1 = _article(v1.strip() or o.size)
    if len(scene.objects) == 1:
        templates = [
            f"image of {art1} {v1}{o.size} {o.color} {o.shape} at the "
            f"{o.position} on a {scene.background} background .",
            f"the picture shows {art1} {v1}{o.size} {o.color} {o.shape} "
            f"at the {o.position} on a {scene.background} background .",
            f"there is {art1} {v1}{o.size} {o.color} {o.shape} at the "
            f"{o.position} on a {scene.background} background .",
        ]
    else:
        b = scene.objects[1]
        v2 = _valence_phrase(rng)
        art2 = _article(v2.strip() or b.size)
        templates = [
            f"image of {art1} {v1}{o.size} {o.color} {o.shape} at the "
            f"{o.position} and {art2} {v2}{b.size} {b.color} {b.shape} "
            f"at the {b.position} .",
            f"{art1} {v1}{o.size} {o.color} {o.shape} at the {o.position} "
            f"and {art2} {v2}{b.size} {b.color} {b.shape} on a "
            f"{scene.background} background .",
            f"the picture shows {art1} {v1}{o.size} {o.color} {o.shape} "
            f"with {art2} {v2}{b.size} {b.color} {b.shape} on a "
            f"{scene.background} background .",
        ]
    return templates[rng.randint(len(templates))]


def scene_attribute_words(scene: Scene) -> List[str]:
    """The scene's ground-truth content words (for attribute-recall
    metrics: how many does a generated caption mention?)."""
    words: List[str] = []
    for o in scene.objects:
        words += [o.color, o.shape]
    return words


# --- vocabularies -------------------------------------------------------------


def make_tiny_wordpiece_vocab(vocab_size: int = 4096,
                              rich: bool = False) -> Dict[str, int]:
    """WordPiece vocab: specials + punctuation + digits + the caption
    language + deterministic pronounceable filler words (distractor
    candidates for the top-k, mirroring the real vocab's rare-word tail).
    No ## continuations: the trained world is whole-word by construction."""
    tokens: List[str] = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += list(".,!?;:'\"-()")
    tokens += [str(d) for d in range(10)]
    seen = set(tokens)
    for w in caption_words(rich=rich):
        if w not in seen:
            tokens.append(w)
            seen.add(w)
    consonants = "bcdfghjklmnpqrstvwz"
    vowels = "aeiou"
    i = 0
    while len(tokens) < vocab_size:
        c1 = consonants[i % len(consonants)]
        v1 = vowels[(i // len(consonants)) % len(vowels)]
        c2 = consonants[(i // (len(consonants) * len(vowels))) % len(consonants)]
        v2 = vowels[(i // (len(consonants) * len(vowels) * len(consonants)))
                    % len(vowels)]
        tail = i // (len(consonants) * len(vowels)) ** 2
        word = f"{c1}{v1}{c2}{v2}" + ("" if tail == 0 else f"xo{tail % 7}")
        if word not in seen:
            tokens.append(word)
            seen.add(word)
        i += 1
    return {t: j for j, t in enumerate(tokens[:vocab_size])}


def make_word_bpe_files(words: Iterable[str], tmpdir: str,
                        max_rounds: int = 10) -> Tuple[str, str]:
    """CLIP-style vocab.json + merges.txt in which every given word
    encodes to EXACTLY ONE ``word</w>`` token.

    Single-token words keep candidate sentences short on the CLIP side
    (the char-fallback test BPE would blow past clip_len) and make the
    WordPiece<->BPE bridge one-to-one. Greedy BPE applies the
    lowest-ranked applicable pair anywhere in the word, so naive
    per-word merge chains can interfere (a shared interior pair can
    outrank a prefix pair and strand the word in two pieces); we build
    chains longest-word-first and then run a verify+rescue fixpoint with
    the REAL tokenizer until every word round-trips to one token.
    """
    from conzic_torch.text.bpe import CLIPBPETokenizer, byte_to_unicode

    words = sorted({w.lower() for w in words}, key=lambda w: (-len(w), w))
    chars = [chr(c) for c in range(ord("!"), ord("~") + 1)]
    # full byte-alphabet coverage so arbitrary text never KeyErrors
    chars = sorted(set(chars) | set(byte_to_unicode().values()))
    tokens: List[str] = chars + [c + "</w>" for c in chars]
    merges: List[Tuple[str, str]] = []
    seen_m = set()

    def add_chain(parts: Sequence[str]):
        """Left-to-right merge chain over ``parts``; records tokens."""
        prev = parts[0]
        for nxt in parts[1:]:
            pair = (prev, nxt)
            if pair not in seen_m:
                merges.append(pair)
                seen_m.add(pair)
            prev = prev + nxt
            if prev not in token_set:
                tokens.append(prev)
                token_set.add(prev)

    token_set = set(tokens)
    for w in words:
        if len(w) == 1:
            continue  # chars (+</w>) are already single tokens
        add_chain(tuple(w[:-1]) + (w[-1] + "</w>",))

    def build():
        vocab = {t: i for i, t in enumerate(tokens)}
        n = len(vocab)
        vocab["<|startoftext|>"] = n
        vocab["<|endoftext|>"] = n + 1
        return CLIPBPETokenizer(vocab, list(merges))

    for _ in range(max_rounds):
        tok = build()
        broken = []
        for w in words:
            pieces = tok._bpe(w).split(" ")
            if len(pieces) > 1:
                broken.append((w, pieces))
        if not broken:
            break
        for w, pieces in broken:
            add_chain(pieces)
    else:
        raise RuntimeError(
            f"BPE rescue did not converge; still broken: {broken[:5]}")

    vocab = {t: i for i, t in enumerate(tokens)}
    n = len(vocab)
    vocab["<|startoftext|>"] = n
    vocab["<|endoftext|>"] = n + 1
    vocab_path = os.path.join(tmpdir, "vocab.json")
    merges_path = os.path.join(tmpdir, "merges.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return vocab_path, merges_path


# --- dataset -----------------------------------------------------------------


def build_dataset(n: int, seed: int, image_size: int = 64,
                  two_object_p: float = 0.35, rich: bool = False):
    """Render ``n`` scenes deterministically.

    Returns (images uint8 (n, S, S, 3), captions list[str], scenes).
    uint8 keeps 20k 64px scenes ~250 MB; normalize per batch on device.

    ``rich=True``: the mid-size world, mostly
    two-object scenes with 14-21-word captions carrying optional
    valence adjectives (caption_scene_rich).
    """
    rng = np.random.RandomState(seed)
    if rich:
        two_object_p = max(two_object_p, 0.75)
    images = np.zeros((n, image_size, image_size, 3), np.uint8)
    captions: List[str] = []
    scenes: List[Scene] = []
    for i in range(n):
        scene = sample_scene(rng, two_object_p)
        images[i] = np.asarray(render_scene(scene, image_size), np.uint8)
        captions.append(caption_scene_rich(scene, rng) if rich
                        else caption_scene(scene, rng))
        scenes.append(scene)
    return images, captions, scenes
