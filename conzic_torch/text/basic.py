"""Host-side basic text normalization (pre-tokenization).

From-scratch implementation of the standard BERT-style basic tokenizer
semantics (lowercase, control-char cleanup, CJK spacing, optional accent
stripping / punctuation splitting) that both the WordPiece and the CLIP-BPE
pipelines build on. The reference gets these behaviors implicitly through
HF `transformers` tokenizers (``reference demo.py:126``,
``reference clip/clip.py:16``).
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, List, Optional


def is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even where unicode disagrees
    # (e.g. '$', '^', '`'), matching BERT's convention.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicNormalizer:
    """Whitespace/control cleanup + lowercase + CJK spacing + optional
    accent-strip and punctuation splitting."""

    def __init__(
        self,
        do_lower_case: bool = True,
        strip_accents: Optional[bool] = None,
        split_on_punc: bool = True,
        never_split: Optional[Iterable[str]] = None,
    ):
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.split_on_punc = split_on_punc
        self.never_split = set(never_split or ())

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or is_control(ch):
                continue
            out.append(" " if is_whitespace(ch) else ch)
        return "".join(out)

    def _space_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, token: str) -> str:
        token = unicodedata.normalize("NFD", token)
        return "".join(ch for ch in token if unicodedata.category(ch) != "Mn")

    def _split_punc(self, token: str) -> List[str]:
        if not self.split_on_punc or token in self.never_split:
            return [token]
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]

    def tokenize(self, text: str, never_split: Optional[Iterable[str]] = None) -> List[str]:
        never = self.never_split | set(never_split or ())
        text = self._clean(text)
        text = self._space_cjk(text)
        # NFC normalization of the whole text (HF does this since v4.31)
        text = unicodedata.normalize("NFC", text)
        tokens = text.split()
        out: List[str] = []
        for tok in tokens:
            if tok not in never:
                if self.do_lower_case:
                    tok = tok.lower()
                    if self.strip_accents is not False:
                        tok = self._strip_accents(tok)
                elif self.strip_accents:
                    tok = self._strip_accents(tok)
            out.extend(self._split_punc(tok) if tok not in never else [tok])
        return " ".join(out).split()
