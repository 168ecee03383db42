"""Qwen2's byte-level BPE (host side), the tokenizer of SDAR's proposer.

The tokenizer of Qwen2 and its successors (Qwen3, and SDAR, trained on
from Qwen3-MoE): NFC normalisation, the pre-tokenizer regex of Hugging
Face's ``tokenization_qwen2.py`` (``PRETOKENIZE_REGEX``), no lower case,
GPT-2's byte alphabet ("Ġ" marks a leading space), merges by rank, and
the added special tokens of ``tokenizer_config.json`` split out first as
they are. The engine-facing surface is
:class:`~conzic_torch.text.roberta_bpe.RobertaBPETokenizer`'s.

A proposer row is ``<|endoftext|>``, the text's pieces, ``<|endoftext|>``:
Qwen2's tokenizer adds no start or end token of its own, and the end of
text token, the boundary its pretraining puts between documents, frames
the row. The mask token is ``<|MASK|>``.
"""

from __future__ import annotations

import json
import os
import re as _stdre
import unicodedata
from typing import Dict, List, Sequence, Tuple

try:
    import regex as _re
except ImportError:  # pragma: no cover
    _re = None

from conzic_torch.text.bpe import byte_to_unicode

PRETOKENIZE_REGEX = (
    r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"""
    r""" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
)
END_OF_TEXT = "<|endoftext|>"
MASK = "<|MASK|>"


class QwenBPETokenizer:
    def __init__(self, vocab: Dict[str, int],
                 merges: List[Tuple[str, str]], added: Dict[int, str],
                 eos_token: str = END_OF_TEXT, mask_token: str = MASK):
        """``vocab``: the BPE's pieces -> ids; ``merges`` by rank;
        ``added``: id -> the special tokens above the pieces."""
        if _re is None:
            raise ImportError("QwenBPETokenizer requires `regex`")
        self.encoder = dict(vocab)
        self.encoder.update({t: i for i, t in added.items()})
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.eos_token = self.pad_token = eos_token
        self.mask_token = mask_token
        self.special_tokens = [added[i] for i in sorted(added)]
        self._specials = set(self.special_tokens)
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        self._pat = _re.compile(PRETOKENIZE_REGEX)
        self._special_re = _stdre.compile(
            "(" + "|".join(_stdre.escape(t) for t in sorted(
                self.special_tokens, key=len, reverse=True)) + ")")

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_pretrained(checkpoint_dir: str, **kw) -> "QwenBPETokenizer":
        """vocab.json, merges.txt and tokenizer_config.json's
        ``added_tokens_decoder``. Where the directory's config.json gives
        the model more rows than the tokenizer has ids (Qwen2's 151,936
        against some 151,665), each id left over is a reserved special
        token, never proposed."""
        with open(os.path.join(checkpoint_dir, "vocab.json"),
                  encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(checkpoint_dir, "merges.txt"),
                  encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split(" ")) for line in lines
                  if line and not line.startswith("#version")]
        with open(os.path.join(checkpoint_dir, "tokenizer_config.json"),
                  encoding="utf-8") as f:
            decoder = json.load(f)["added_tokens_decoder"]
        added = {int(i): t["content"] for i, t in decoder.items()}
        config = os.path.join(checkpoint_dir, "config.json")
        if os.path.exists(config):
            with open(config, encoding="utf-8") as f:
                rows = json.load(f).get("vocab_size", 0)
            taken = set(vocab.values()) | set(added)
            added.update({i: f"<|unused_{i}|>" for i in range(rows)
                          if i not in taken})
        return QwenBPETokenizer(vocab, merges, added, **kw)

    # --- id surface (RobertaBPETokenizer's) -------------------------------
    @property
    def vocab(self) -> Dict[str, int]:
        return self.encoder

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def mask_token_id(self) -> int:
        return self.encoder[self.mask_token]

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.encoder[self.pad_token]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.decoder[int(i)] for i in ids]

    # --- BPE core ---------------------------------------------------------
    def _bpe(self, piece: str) -> List[str]:
        """One pre-token's byte characters merged pair by pair, the pair
        of lowest rank first."""
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        word = list(piece)
        while len(word) > 1:
            ranked = [(self.bpe_ranks.get(p), i)
                      for i, p in enumerate(zip(word, word[1:]))]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            first, second = word[min(ranked)[1]], word[min(ranked)[1] + 1]
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[piece] = word
        return word

    def _bpe_text(self, text: str) -> List[str]:
        out: List[str] = []
        for chunk in self._pat.findall(unicodedata.normalize("NFC", text)):
            out += self._bpe("".join(self.byte_encoder[b]
                                     for b in chunk.encode("utf-8")))
        return out

    def tokenize(self, text: str) -> List[str]:
        """The special tokens as they are, BPE between them."""
        out: List[str] = []
        for chunk in self._special_re.split(text):
            if chunk in self._specials:
                out.append(chunk)
            elif chunk:
                out += self._bpe_text(chunk)
        return out

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        """The ids of ``text``; with ``add_special_tokens``, the row's
        frame: ``<|endoftext|>`` before and after."""
        ids = [self.encoder[t] for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.eos_token_id] + ids + [self.eos_token_id]
        return ids

    def encode_word_ids(self, word: str) -> List[int]:
        """ids of a standalone word (no leading space)."""
        return [self.encoder[t] for t in self._bpe_text(word)]

    # --- decode -----------------------------------------------------------
    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = False) -> str:
        out, raw = [], bytearray()
        for t in self.convert_ids_to_tokens(ids):
            if t in self._specials:
                if not skip_special_tokens:
                    out.append(raw.decode("utf-8", errors="replace") + t)
                    raw = bytearray()
                continue
            raw += bytes(self.byte_decoder[c] for c in t)
        return "".join(out) + raw.decode("utf-8", errors="replace")

    def batch_decode(self, batch_ids, skip_special_tokens: bool = False):
        return [self.decode(r, skip_special_tokens) for r in batch_ids]
