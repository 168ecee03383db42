"""SigLIP's SentencePiece Unigram tokenizer (host side), from scratch.

The behaviour of Hugging Face's ``SiglipTokenizer``: the text is
canonicalised (lower-cased, every ASCII punctuation mark removed, runs of
white space made one space, the ends stripped), each word is written with
a leading "▁" and cut into the vocabulary's pieces by Viterbi, the cut
whose pieces' scores sum highest; an end token follows, and a row is
padded to its fixed length with the pad token. There is no start token.

The pieces and their scores are read from a ``tokenizer.json``'s
``model.vocab`` list (``[[piece, score], ...]``, its ``model.unk_id``),
which is what a SigLIP checkpoint directory holds beside ``spiece.model``.
Pieces never span a "▁", so cutting word by word is cutting the text.
A run of characters that no piece covers becomes one unknown piece.
"""

from __future__ import annotations

import json
import os
import re
import string
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

WORD_START = "\u2581"  # "▁", the mark of a word's start
_PUNCTUATION = str.maketrans("", "", string.punctuation)
# SentencePiece scores an unknown piece below every piece of the vocabulary
_UNK_PENALTY = 10.0


def canonicalize(text: str) -> str:
    """SigLIP's canonical text: lower case, no ASCII punctuation, single
    spaces, no space at either end."""
    text = text.lower().translate(_PUNCTUATION)
    return re.sub(r"\s+", " ", text).strip()


class SiglipTokenizer:
    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: int,
                 eos_token: str = "</s>", pad_token: str = "</s>",
                 model_max_length: int = 64):
        self.pieces = [p for p, _ in pieces]
        self.scores = {p: float(s) for p, s in pieces}
        self.encoder: Dict[str, int] = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id = unk_id
        self.eos_token, self.pad_token = eos_token, pad_token
        self.model_max_length = model_max_length
        self._max_len = max(len(p) for p in self.pieces)
        self._unk_score = min(self.scores.values()) - _UNK_PENALTY
        self._cache: Dict[str, List[int]] = {}

    # --- constructors -----------------------------------------------------
    @staticmethod
    def from_tokenizer_json(path: str, **kw) -> "SiglipTokenizer":
        with open(path, encoding="utf-8") as f:
            model = json.load(f)["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"{path}: a {model.get('type')!r} model, not a "
                             "SentencePiece Unigram one")
        return SiglipTokenizer([tuple(p) for p in model["vocab"]],
                               model["unk_id"], **kw)

    @staticmethod
    def from_pretrained(checkpoint_dir: str, **kw) -> "SiglipTokenizer":
        return SiglipTokenizer.from_tokenizer_json(
            os.path.join(checkpoint_dir, "tokenizer.json"), **kw)

    # --- id helpers -------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    @property
    def bos_token_id(self) -> Optional[int]:
        return None  # SigLIP's rows have no start token

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.encoder[self.pad_token]

    # --- Unigram core -----------------------------------------------------
    def _viterbi(self, word: str) -> List[int]:
        """The ids of "▁" + ``word`` cut into the pieces whose scores sum
        highest."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        text = WORD_START + word
        n = len(text)
        best = [-np.inf] * (n + 1)
        back: List[Tuple[int, int]] = [(0, -1)] * (n + 1)
        best[0] = 0.0
        for end in range(1, n + 1):
            for start in range(max(0, end - self._max_len), end):
                piece = text[start:end]
                score = self.scores.get(piece)
                if score is None:
                    if end - start != 1:
                        continue
                    score, pid = self._unk_score, self.unk_id
                else:
                    pid = self.encoder[piece]
                if best[start] + score > best[end]:
                    best[end], back[end] = best[start] + score, (start, pid)
        ids: List[int] = []
        end = n
        while end > 0:
            start, pid = back[end]
            if not (pid == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(pid)  # a run of unknown characters is one piece
            end = start
        self._cache[word] = ids[::-1]
        return self._cache[word]

    def encode_word_ids(self, word: str) -> List[int]:
        """Piece ids of one standalone word, canonicalised (none for a
        word of punctuation alone): the bridge table's entries."""
        return [i for w in canonicalize(word).split()
                for i in self._viterbi(w)]

    def batch_encode(self, texts: Sequence[str],
                     max_length: Optional[int] = None,
                     pad_to_max: bool = False):
        """(ids, attention_mask) int32 arrays: each text's pieces cut to
        ``max_length - 1``, the end token, then the pad token."""
        max_length = max_length or self.model_max_length
        rows = [self.encode_word_ids(t)[:max_length - 1] + [self.eos_token_id]
                for t in texts]
        width = max_length if pad_to_max else max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad_token_id, np.int32)
        mask = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask


TEST_UNK_ID = 2  # "<unk>" of make_test_pieces


def make_test_pieces(words: Sequence[str]) -> List[Tuple[str, float]]:
    """Pieces for dry runs without a checkpoint, as a ``tokenizer.json``
    lists them: "<pad>", "</s>", "<unk>" (:data:`TEST_UNK_ID`); "▁" + each
    canonical body of ``words`` (a ``##`` continuation's without its mark),
    once, scored in [-9, -8) so that each is one piece; then "▁", the
    letters and the digits at -10, so that every other word is cut."""
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    bodies = list(dict.fromkeys(
        b for w in words for b in canonicalize(w.removeprefix("##")).split()))
    pieces += [(WORD_START + b, -8.0 - i / max(len(bodies), 1))
               for i, b in enumerate(bodies)]
    chars = WORD_START + string.ascii_lowercase + string.digits
    return pieces + [(c, -10.0) for c in chars]
