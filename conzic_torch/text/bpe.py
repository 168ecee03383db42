"""CLIP BPE tokenizer (host side), from scratch.

Replaces the HF ``CLIPTokenizer`` the reference uses to re-tokenize every
candidate sentence in the hot loop (``reference clip/clip.py:16,71-73``,
padded/truncated to a 77-token context). Byte-level BPE with ``</w>``
end-of-word markers over ``vocab.json`` + ``merges.txt``.

Behavior contract matched against the installed HF slow tokenizer (which,
without ftfy, normalizes via the BERT basic tokenizer with
``strip_accents=False, do_split_on_punc=False`` and lowercases inside the
split regex).
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

try:  # the `regex` module supports \p{L}/\p{N} classes
    import regex as _re
except ImportError:  # pragma: no cover
    _re = None

from conzic_torch.text.basic import BasicNormalizer

_SPLIT_PATTERN = (
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
)


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode mapping (standard byte-level BPE
    alphabet: printable latin-1 bytes map to themselves, the rest are shifted
    into the 0x100+ plane)."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


class CLIPBPETokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        unk_token: str = "<|endoftext|>",
        model_max_length: int = 77,
    ):
        if _re is None:
            raise ImportError("CLIPBPETokenizer requires the `regex` package")
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.unk_token = unk_token
        self.model_max_length = model_max_length
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, str] = {bos_token: bos_token, eos_token: eos_token}
        self._pat = _re.compile(_SPLIT_PATTERN, _re.IGNORECASE)
        self._norm = BasicNormalizer(
            do_lower_case=True, strip_accents=False, split_on_punc=False
        )

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_files(vocab_file: str, merges_file: str, **kw) -> "CLIPBPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        # first line is the version header; cap at the CLIP merge count
        merges = [
            tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]
        ]
        return CLIPBPETokenizer(vocab, merges, **kw)

    @staticmethod
    def from_pretrained(checkpoint_dir: str, **kw) -> "CLIPBPETokenizer":
        return CLIPBPETokenizer.from_files(
            os.path.join(checkpoint_dir, "vocab.json"),
            os.path.join(checkpoint_dir, "merges.txt"),
            **kw,
        )

    # --- id helpers -------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def bos_token_id(self) -> int:
        return self.encoder[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        # CLIP pads with the EOS token (HF "hack to enable padding")
        return self.eos_token_id

    # --- BPE core ---------------------------------------------------------
    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>"
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def tokenize(self, text: str) -> List[str]:
        text = " ".join(self._norm.tokenize(text))
        out: List[str] = []
        for chunk in self._pat.findall(text):
            chunk = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            out.extend(self._bpe(chunk).split(" "))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.encoder[self.unk_token]
        return [self.encoder.get(t, unk) for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            return [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def encode_word_ids(self, word: str) -> List[int]:
        """BPE ids of one standalone word — used to build the on-device
        BERT-id -> CLIP-id bridge table."""
        return self.convert_tokens_to_ids(self.tokenize(word))

    # --- batch encode (reference clip/clip.py:71-73 semantics) ------------
    def batch_encode(
        self,
        texts: Sequence[str],
        max_length: Optional[int] = None,
        pad_to_max: bool = False,
    ):
        """Returns (ids, attention_mask) as lists-of-lists, truncated to
        ``max_length`` (default 77) and padded with EOS."""
        import numpy as np

        max_length = max_length or self.model_max_length
        rows = []
        for t in texts:
            body = self.convert_tokens_to_ids(self.tokenize(t))[: max_length - 2]
            rows.append([self.bos_token_id] + body + [self.eos_token_id])
        width = max_length if pad_to_max else max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(rows), width), dtype=np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask

    # --- decode -----------------------------------------------------------
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        specials = {self.bos_token, self.eos_token}
        tokens = [self.decoder.get(int(i), self.unk_token) for i in ids]
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in specials]
        text = "".join(tokens)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
