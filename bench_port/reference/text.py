"""The text side of captioning, plainly: the WordPiece encoding of the
prompt, which tokens a caption may use, the CLIP BPE of a word, the CLIP
row of a caption, and the decoding of a caption to its text.

Written from the published rules (BERT's WordPiece, CLIP's byte-level BPE
with ``</w>`` word ends, ConZIC's stop-word and period rules). It reads
the vocabularies the benchmark made and nothing of the program under
test.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
_ALPHA = re.compile(r"^[a-zA-Z]+$")
# what CLIP's BPE takes as one word here: letters, or one punctuation mark
_WORD = re.compile(r"^([a-zA-Z]+|[^\sa-zA-Z0-9])$")


def body(token: str) -> str:
    """A WordPiece token without its ``##`` continuation mark."""
    return token[2:] if token.startswith("##") else token


class WordPiece:
    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        self.tokens = {i: t for t, i in vocab.items()}

    def encode_words(self, text: str) -> List[int]:
        """Lower-cased whitespace words, each a whole vocabulary entry
        (the prompt's words are)."""
        ids = []
        for word in text.lower().split():
            if word not in self.vocab:
                raise ValueError(f"{word!r} is not one vocabulary entry")
            ids.append(self.vocab[word])
        return ids

    def init_row(self, prompt: str, sentence_len: int) -> List[int]:
        """[CLS] prompt [MASK] * sentence_len [SEP]."""
        v = self.vocab
        return ([v["[CLS]"]] + self.encode_words(prompt)
                + [v["[MASK]"]] * sentence_len + [v["[SEP]"]])

    def allowed(self, token_id: int, last_slot: bool) -> bool:
        """A caption may use purely alphabetic tokens (and their ``##``
        continuations); the period only at the last slot."""
        t = self.tokens[token_id]
        if t == ".":
            return last_slot
        return bool(_ALPHA.match(body(t)))

    def decode(self, ids: Sequence[int]) -> str:
        """The caption's text: specials dropped, ``##`` pieces joined to
        the word before, a space before punctuation taken out."""
        words = [self.tokens[int(i)] for i in ids
                 if self.tokens[int(i)] not in SPECIALS]
        text = " ".join(words).replace(" ##", "").strip()
        for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                     (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"),
                     (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
            text = text.replace(a, b)
        return text


class ClipBpe:
    """CLIP's BPE over a word of ASCII letters or one punctuation mark:
    characters, the last one marked ``</w>``, merged pair by pair, the
    pair that comes first in the merge list first."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]]):
        self.vocab = vocab
        self.merges = [tuple(m) for m in merges]
        self.rank = {m: i for i, m in enumerate(self.merges)}
        self.bos = vocab["<|startoftext|>"]
        self.eos = vocab["<|endoftext|>"]
        self.pad = self.eos  # CLIP pads with its end token
        self._cache: Dict[str, List[int]] = {}

    def word(self, word: str) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        w = word.lower()
        if not _WORD.match(w):
            raise ValueError(f"{word!r} is not a word of letters or one "
                             "punctuation mark")
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [(self.rank.get((parts[i], parts[i + 1]), None), i)
                      for i in range(len(parts) - 1)]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            pair = self.merges[min(ranked)[0]]
            merged, i = [], 0
            while i < len(parts):
                if (i < len(parts) - 1
                        and (parts[i], parts[i + 1]) == pair):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids = [self.vocab[p] for p in parts]
        self._cache[word] = ids
        return ids


def clip_row(wp: WordPiece, bpe: ClipBpe, inner_ids: Sequence[int],
             clip_len: int) -> Tuple[List[int], int]:
    """The CLIP ids of a caption (its WordPiece ids without [CLS] and
    [SEP]): BOS, each token's BPE as a word of its own, EOS, padded to
    ``clip_len``; pieces past the context are dropped. Returns (ids, the
    number of valid positions)."""
    pieces: List[int] = []
    for i in inner_ids:
        t = wp.tokens[int(i)]
        if t in SPECIALS:
            continue
        pieces += bpe.word(body(t))
    pieces = pieces[:clip_len - 2]
    row = [bpe.bos] + pieces + [bpe.eos]
    n = len(row)
    return row + [bpe.pad] * (clip_len - n), n
