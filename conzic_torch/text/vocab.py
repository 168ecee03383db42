"""Vocabulary constraint system (stop-word mask + '.' rule).

Vendored from conzic_tpu/text/vocab.py.

The reference builds a ``(1, vocab)`` float mask zeroing ~2,835 stop tokens
read from ``stop_words.txt`` (``reference demo.py:134-143``) and
mutates it per position so ``'.'`` is only allowed at the last sentence slot
(``reference utils.py:53-59``).

The rebuild derives the stop set *by rule* from the vocabulary itself —
the reference list's measured composition (ASCII punctuation, non-Latin
single characters, ``[unusedN]`` slots, pure numbers, ``...``) is exactly
the set of non-word tokens, so the rule "keep only purely alphabetic ASCII
tokens (and their ## continuations)" reproduces it without copying the data
file. A user-supplied stop-words file and extra stop words are still
honored for exact parity (`--stop_words_path`, `--add_extra_stopwords`).

The per-position '.' rule is implemented jit-friendly: two static masks
(period banned / period allowed) selected by position instead of in-place
mutation.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Explicit ASCII ranges, NOT re.IGNORECASE: Unicode case-folding makes
# [a-z]+ with IGNORECASE match 'ı' (U+0131, in the reference's
# stop_words.txt) and 'ſ' (U+017F) — tests/test_tokenizers.py pins the
# rule-derived ban set against reference stop_words.txt.
_ALPHA_RE = re.compile(r"^[a-zA-Z]+$")


def token_body(token: str) -> str:
    """Strip sub-word markers: WordPiece '##' continuations and byte-level
    BPE 'Ġ' (leading-space) markers (RoBERTa/GPT-2 vocabularies)."""
    if token.startswith("##"):
        return token[2:]
    if token.startswith("Ġ"):
        return token[1:]
    return token


def is_word_token(token: str) -> bool:
    """True if the vocab entry is a usable caption word (or sub-word
    piece)."""
    return bool(_ALPHA_RE.match(token_body(token)))


def build_stop_ids(
    vocab: dict,
    extra_stop_words: Iterable[str] = (),
    stop_words: Optional[Sequence[str]] = None,
) -> List[int]:
    """Ids to ban. If ``stop_words`` (e.g. loaded from a reference-format
    stop_words.txt) is given it is used verbatim; otherwise the rule-based
    derivation is applied. ``extra_stop_words`` are always appended
    (reference ``--add_extra_stopwords``, demo.py:71-72)."""
    ids: List[int] = []
    if stop_words is not None:
        unk = vocab.get("[UNK]")
        for w in stop_words:
            i = vocab.get(w, unk)
            if i is not None:
                ids.append(i)
    else:
        for tok, i in vocab.items():
            if not is_word_token(tok):
                ids.append(i)
    unk = vocab.get("[UNK]")
    for w in extra_stop_words:
        i = vocab.get(w, unk)
        if i is not None:
            ids.append(i)
    return ids


def load_stop_words_file(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


def build_token_masks(
    vocab: dict,
    extra_stop_words: Iterable[str] = (),
    stop_words: Optional[Sequence[str]] = None,
    period_token: str = ".",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(mask_mid, mask_last)`` float32 ``(vocab,)`` arrays.

    ``mask_mid`` bans the period everywhere; ``mask_last`` allows it —
    the jit-friendly equivalent of ``update_token_mask``
    (``reference utils.py:53-59``).
    """
    V = len(vocab)
    mask = np.ones((V,), np.float32)
    for i in build_stop_ids(vocab, extra_stop_words, stop_words):
        mask[i] = 0.0
    period_id = vocab.get(period_token)
    mask_mid = mask.copy()
    mask_last = mask.copy()
    if period_id is not None:
        mask_mid[period_id] = 0.0
        mask_last[period_id] = 1.0
    return mask_mid, mask_last


# ---------------------------------------------------------------------------
# Synthetic vocabularies (tests / dry-runs without downloaded checkpoints)
# ---------------------------------------------------------------------------

_TEST_WORDS = (
    "image of a the girl boy dog cat red blue small big beautiful happy sad "
    "young old wooden sitting standing running smiling wearing holding looking "
    "hat dress shirt park beach street tree flower sky cloud water grass "
    "playing play ing walk walking man woman child person two three with on in "
    "at by near under over white black green yellow brown little large tiny "
    "huge pretty lovely nice sunny dark bright colorful"
).split()


def make_test_wordpiece_vocab(extra_words: Iterable[str] = ()) -> dict:
    """Small WordPiece vocab: specials, punctuation, digits, words and a few
    ## continuations — enough to exercise every engine path."""
    tokens: List[str] = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += list(".,!?;:'\"-()")
    tokens += [str(d) for d in range(10)]
    tokens += [f"[unused{i}]" for i in range(5)]
    seen = set(tokens)
    for w in list(_TEST_WORDS) + list(extra_words):
        if w not in seen:
            tokens.append(w)
            seen.add(w)
    for frag in ("##ing", "##s", "##ed", "##er"):
        if frag not in seen:
            tokens.append(frag)
            seen.add(frag)
    return {t: i for i, t in enumerate(tokens)}


def make_fullsize_wordpiece_vocab(vocab_size: int = 30522) -> dict:
    """Synthetic vocab with the real bert-base-uncased cardinality: specials,
    punctuation, digits, [unusedN] slots, and generated alphabetic words.
    Used for benchmarking at true vocab scale without downloaded artifacts
    (top-k over 30,522 masked probs, full-size MLM projection, full-size
    bridge table)."""
    tokens: List[str] = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += list(".,!?;:'\"-()[]{}$%&*+/<=>@\\^_`|~#")
    tokens += [str(d) for d in range(10)]
    tokens += [f"[unused{i}]" for i in range(994)]
    seen = set(tokens)
    for w in _TEST_WORDS:
        if w not in seen:
            tokens.append(w)
            seen.add(w)
    # deterministic pronounceable filler words + ## continuations
    consonants = "bcdfghjklmnpqrstvwz"
    vowels = "aeiou"
    i = 0
    while len(tokens) < vocab_size:
        c1 = consonants[i % len(consonants)]
        v1 = vowels[(i // len(consonants)) % len(vowels)]
        c2 = consonants[(i // (len(consonants) * len(vowels))) % len(consonants)]
        v2 = vowels[(i // (len(consonants) * len(vowels) * len(consonants))) % len(vowels)]
        tail = i // (len(consonants) * len(vowels)) ** 2
        word = f"{c1}{v1}{c2}{v2}" + ("" if tail == 0 else f"x{tail}")
        if i % 7 == 3:
            word = "##" + word
        if word not in seen:
            tokens.append(word)
            seen.add(word)
        i += 1
    return {t: j for j, t in enumerate(tokens[:vocab_size])}


def make_test_roberta_files(tmpdir: str) -> Tuple[str, str]:
    """Miniature GPT-2/RoBERTa-style vocab.json + merges.txt: specials,
    single byte-alphabet chars, and merges building a few common words with
    'Ġ' space markers."""
    import json
    import os

    from conzic_torch.text.bpe import byte_to_unicode

    chars = sorted(set(byte_to_unicode()[b] for b in range(33, 127)))
    chars.append("Ġ")  # byte 0x20 maps to Ġ
    merges = []
    # build "Ġ<word>" and bare "<word>" for a handful of words
    words = ["the", "a", "of", "image", "girl", "dog", "cat", "sun", "sky",
             "red", "big", "run", "sit", "play", "ing", "ed"]
    tokens = list(dict.fromkeys(chars))
    for w in words:
        # bare word merges: successive pair merges left-to-right
        prev = w[0]
        for ch in w[1:]:
            merges.append((prev, ch))
            prev = prev + ch
        tokens.append(w)
        merges.append(("Ġ", w))
        tokens.append("Ġ" + w)
    # dedupe merges preserving order
    seen = set()
    uniq = []
    for m in merges:
        if m not in seen:
            uniq.append(m)
            seen.add(m)
    for m in uniq:
        joined = m[0] + m[1]
        if joined not in tokens:
            tokens.append(joined)
    tokens = list(dict.fromkeys(tokens))
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for t in tokens:
        if t not in vocab:
            vocab[t] = len(vocab)
    vocab["<mask>"] = len(vocab)
    vocab_path = os.path.join(tmpdir, "vocab.json")
    merges_path = os.path.join(tmpdir, "merges.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in uniq:
            f.write(f"{a} {b}\n")
    return vocab_path, merges_path


def make_test_bpe_files(tmpdir: str) -> Tuple[str, str]:
    """Write a miniature CLIP-style vocab.json + merges.txt covering ASCII
    text. Single characters (+ '</w>' variants) ensure no UNKs; a few merges
    exercise the BPE loop."""
    import json
    import os

    chars = [chr(c) for c in range(ord("!"), ord("~") + 1)]
    tokens = chars + [c + "</w>" for c in chars]
    merges = [
        ("t", "h"),
        ("th", "e</w>"),
        ("i", "n"),
        ("in", "g</w>"),
        ("a", "n"),
        ("o", "f</w>"),
        ("r", "e"),
        ("a", "t</w>"),
        ("e", "r</w>"),
        ("l", "l"),
    ]
    tokens += ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    vocab = {t: i for i, t in enumerate(tokens)}
    vocab_path = os.path.join(tmpdir, "vocab.json")
    merges_path = os.path.join(tmpdir, "merges.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return vocab_path, merges_path


def make_test_qwen_files(tmpdir: str) -> str:
    """A miniature Qwen2 byte-level BPE in ``tmpdir`` (vocab.json,
    merges.txt, tokenizer_config.json), as
    :meth:`~conzic_torch.text.qwen_bpe.QwenBPETokenizer.from_pretrained`
    reads it: the printable ASCII byte characters and 'Ġ', merges that
    make each test word and 'Image' one piece, bare and after a space
    (each word's remaining pairs merged left to right, ranked after all
    earlier merges), then ``<|endoftext|>`` and ``<|MASK|>``."""
    import json
    import os

    from conzic_torch.text.bpe import byte_to_unicode

    chars = [byte_to_unicode()[b] for b in range(33, 127)] + ["Ġ"]
    merges: List[Tuple[str, str]] = []
    rank = {}
    for word in ["Image"] + list(_TEST_WORDS):
        for form in ("Ġ" + word, word):
            parts = list(form)
            while len(parts) > 1:  # BPE by the merges so far
                ranked = [(rank[p], i) for i, p in
                          enumerate(zip(parts, parts[1:])) if p in rank]
                if not ranked:
                    break
                i = min(ranked)[1]
                parts[i:i + 2] = [parts[i] + parts[i + 1]]
            while len(parts) > 1:
                rank[(parts[0], parts[1])] = len(merges)
                merges.append((parts[0], parts[1]))
                parts[:2] = [parts[0] + parts[1]]
    tokens = list(dict.fromkeys(chars + ["".join(m) for m in merges]))
    vocab = {t: i for i, t in enumerate(tokens)}
    added = {str(len(tokens) + j): {"content": t, "special": True}
             for j, t in enumerate(("<|endoftext|>", "<|MASK|>"))}
    with open(os.path.join(tmpdir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(tmpdir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    with open(os.path.join(tmpdir, "tokenizer_config.json"), "w",
              encoding="utf-8") as f:
        json.dump({"added_tokens_decoder": added}, f)
    return tmpdir
