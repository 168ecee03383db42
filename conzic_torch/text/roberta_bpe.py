"""RoBERTa byte-level BPE tokenizer (host side).

Counterpart of ``conzic_tpu/text/roberta_bpe.py``. The reference's
``--lm_model`` takes any HF masked LM, BERT or RoBERTa; this is the
GPT-2-style byte BPE that RoBERTa uses (vocab.json + merges.txt, "Ġ" marks
a leading space) with the engine-facing surface of
:class:`~conzic_torch.text.wordpiece.WordPieceTokenizer`, so the Gibbs
engine does not depend on the tokenizer: ``encode`` / ``batch_decode`` /
``mask_token_id`` / ``special_tokens`` / ``vocab``.

Sequence format: ``<s> tokens </s>`` with mask token ``<mask>``
(lstrip semantics: a space before ``<mask>`` is absorbed, matching HF).
"""

from __future__ import annotations

import json
import os
import re as _stdre
from typing import Dict, List, Sequence, Tuple

try:
    import regex as _re
except ImportError:  # pragma: no cover
    _re = None

from conzic_torch.text.bpe import byte_to_unicode

_GPT2_SPLIT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

SPECIALS = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")


class RobertaBPETokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        bos_token: str = "<s>",
        eos_token: str = "</s>",
        unk_token: str = "<unk>",
        pad_token: str = "<pad>",
        mask_token: str = "<mask>",
    ):
        if _re is None:
            raise ImportError("RobertaBPETokenizer requires `regex`")
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.unk_token = unk_token
        self.pad_token = pad_token
        self.mask_token = mask_token
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: Dict[str, str] = {}
        self._pat = _re.compile(_GPT2_SPLIT)
        self.special_tokens = [
            t for t in (bos_token, pad_token, eos_token, unk_token, mask_token)
            if t in self.encoder
        ]
        # guard the no-specials case: "()" matches the empty string and
        # re.split would shatter every input into single characters
        self._special_re = _stdre.compile(
            "(" + "|".join(_stdre.escape(t) for t in self.special_tokens) + ")"
        ) if self.special_tokens else None

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_files(vocab_file: str, merges_file: str, **kw) -> "RobertaBPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        merges = [tuple(line.split()) for line in lines[1:] if line.strip()]
        return RobertaBPETokenizer(vocab, merges, **kw)

    @staticmethod
    def from_pretrained(checkpoint_dir: str, **kw) -> "RobertaBPETokenizer":
        return RobertaBPETokenizer.from_files(
            os.path.join(checkpoint_dir, "vocab.json"),
            os.path.join(checkpoint_dir, "merges.txt"),
            **kw,
        )

    # --- id surface (WordPieceTokenizer-compatible) -----------------------
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
    def cls_token_id(self) -> int:
        return self.encoder[self.bos_token]

    @property
    def sep_token_id(self) -> int:
        return self.encoder[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.encoder[self.pad_token]

    def convert_tokens_to_ids(self, tokens):
        unk = self.encoder[self.unk_token]
        if isinstance(tokens, str):
            return self.encoder.get(tokens, unk)
        return [self.encoder.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.decoder.get(int(i), self.unk_token) for i in ids]

    # --- BPE core ---------------------------------------------------------
    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _bpe_text(self, text: str) -> List[str]:
        out: List[str] = []
        for chunk in self._pat.findall(text):
            chunk = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            out.extend(self._bpe(chunk).split(" "))
        return out

    def tokenize(self, text: str) -> List[str]:
        """Split on special tokens (mask lstrip: strip the space before a
        special, as HF's AddedToken(lstrip=True) for <mask>), BPE the rest."""
        out: List[str] = []
        chunks = (
            self._special_re.split(text) if self._special_re else [text]
        )
        for i, chunk in enumerate(chunks):
            if not chunk:
                continue
            if chunk in self.special_tokens:
                out.append(chunk)
                continue
            nxt_special = i + 1 < len(chunks) and chunks[i + 1] in self.special_tokens
            if nxt_special and chunk.endswith(" "):
                chunk = chunk.rstrip(" ")
                if not chunk:
                    continue
            out.extend(self._bpe_text(chunk))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            return [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def encode_word_ids(self, word: str) -> List[int]:
        """ids of a standalone word (no leading space) — for bridge tables."""
        return self.convert_tokens_to_ids(self._bpe_text(word))

    # --- decode -----------------------------------------------------------
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        specials = set(self.special_tokens)
        toks = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            toks = [t for t in toks if t not in specials]
        text = "".join(toks)
        raw = bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        )
        return raw.decode("utf-8", errors="replace")

    def batch_decode(self, batch_ids, skip_special_tokens: bool = False):
        return [self.decode(r, skip_special_tokens) for r in batch_ids]
