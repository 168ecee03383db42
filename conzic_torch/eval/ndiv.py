"""Diversity metrics: Div-1 and Div-2, and the word tokenizer of the
host evaluators.

Vendored from conzic_tpu/eval/ndiv.py (its corpus reader and command line
wait for the port's CLIs): per image, distinct n-grams / total n-grams for
n = 1, 2. NLTK's ``word_tokenize`` is used when its data pack is
installed; otherwise a regex tokenizer with the same behaviour on
caption-style text.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import List, Sequence, Tuple

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?|[^\w\s]")


def word_tokenize(text: str) -> List[str]:
    try:
        from nltk.tokenize import word_tokenize as nltk_tok

        return nltk_tok(text)
    except (ImportError, LookupError):
        return _WORD_RE.findall(text.lower())


def calc_diversity(predicts: Sequence[str],
                   vocab: List[str]) -> Tuple[List[float], List[str]]:
    """(Div-1, Div-2) for one image's captions; extends the running
    vocabulary."""
    tokens = [0.0, 0.0]
    types = [defaultdict(int), defaultdict(int)]
    for gg in predicts:
        g = word_tokenize(gg.lower())
        for word in g:
            if word not in vocab:
                vocab.append(word)
        for n in range(2):
            for idx in range(len(g) - n):
                ngram = " ".join(g[idx: idx + n + 1])
                types[n][ngram] = 1
                tokens[n] += 1
    div1 = len(types[0]) / tokens[0] if tokens[0] else 0.0
    div2 = len(types[1]) / tokens[1] if tokens[1] else 0.0
    return [div1, div2], vocab
