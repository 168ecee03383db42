"""BERT WordPiece tokenizer (host side), from scratch.

Replaces the HF ``AutoTokenizer`` usage of the reference
(``reference demo.py:126``; encode at ``utils.py:48-49``; the
hot-path ``batch_decode`` at ``gen_utils.py:75``). Greedy
longest-match-first WordPiece with ``##`` continuations over a ``vocab.txt``.

The decode path matches HF slow-tokenizer semantics:
``" ".join(tokens).replace(" ##", "")`` plus the classic English
tokenization-space cleanup, with ``skip_special_tokens`` support.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional, Sequence

from conzic_torch.text.basic import BasicNormalizer

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def clean_up_tokenization(text: str) -> str:
    """HF's standard decode cleanup (tokenization_utils_base)."""
    return (
        text.replace(" .", ".")
        .replace(" ?", "?")
        .replace(" !", "!")
        .replace(" ,", ",")
        .replace(" ' ", "'")
        .replace(" n't", "n't")
        .replace(" 'm", "'m")
        .replace(" 's", "'s")
        .replace(" 've", "'ve")
        .replace(" 're", "'re")
    )


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        mask_token: str = "[MASK]",
        max_chars_per_word: int = 100,
        clean_up_spaces: bool = True,
    ):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.pad_token = pad_token
        self.mask_token = mask_token
        self.max_chars_per_word = max_chars_per_word
        self.clean_up_spaces = clean_up_spaces
        self.special_tokens = [
            t for t in (pad_token, unk_token, cls_token, sep_token, mask_token)
            if t in self.vocab
        ]
        self.basic = BasicNormalizer(
            do_lower_case=do_lower_case, never_split=self.special_tokens
        )
        # guard the no-specials case: "()" matches the empty string and
        # re.split would shatter every input into single characters
        self._special_re = re.compile(
            "(" + "|".join(re.escape(t) for t in self.special_tokens) + ")"
        ) if self.special_tokens else None

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_vocab_file(path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return WordPieceTokenizer(vocab, **kw)

    @staticmethod
    def from_pretrained(checkpoint_dir: str, **kw) -> "WordPieceTokenizer":
        return WordPieceTokenizer.from_vocab_file(
            os.path.join(checkpoint_dir, "vocab.txt"), **kw
        )

    # --- id helpers -------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    @property
    def cls_token_id(self) -> int:
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self) -> int:
        return self.vocab[self.sep_token]

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    def convert_tokens_to_ids(self, tokens) -> List[int]:
        unk = self.vocab[self.unk_token]
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    # --- core algorithm ---------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        chunks = (
            self._special_re.split(text) if self._special_re else [text]
        )
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self.special_tokens:
                out.append(chunk)
                continue
            for word in self.basic.tokenize(chunk):
                out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            return [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    # --- decode -----------------------------------------------------------
    def convert_tokens_to_string(self, tokens: Iterable[str]) -> str:
        return " ".join(tokens).replace(" ##", "").strip()

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        special = set(self.special_tokens)
        tokens = [
            t
            for t in self.convert_ids_to_tokens(ids)
            if not (skip_special_tokens and t in special)
        ]
        text = self.convert_tokens_to_string(tokens)
        if self.clean_up_spaces:
            text = clean_up_tokenization(text)
        return text

    def batch_decode(
        self, batch_ids, skip_special_tokens: bool = False
    ) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in batch_ids]
