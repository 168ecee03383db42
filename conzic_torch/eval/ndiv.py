"""Diversity metrics: Div-1, Div-2 and vocabulary size, and the word
tokenizer of the host evaluators.

Counterpart of ``conzic_tpu/eval/ndiv.py``: per image, distinct n-grams /
total n-grams for n = 1, 2, averaged over the corpus, and the vocabulary
size after stop words and ``unused`` slots are left out. NLTK's
``word_tokenize`` is used when its data pack is installed; otherwise a
regex tokenizer with the same behaviour on caption-style text.

    python -m conzic_torch.eval.ndiv CORPUS.json [--stop_words_path F]
"""

from __future__ import annotations

import argparse
import functools
import json
import re
from collections import defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?|[^\w\s]")


@functools.lru_cache(maxsize=None)
def _nltk_tokenizer() -> Optional[Callable[[str], List[str]]]:
    """NLTK's ``word_tokenize`` when NLTK and its data pack are installed,
    else None. Decided once per process: where NLTK is missing, a failed
    import costs about half a millisecond, and the exact sentiment mode
    tokenizes every candidate of every Gibbs step."""
    try:
        from nltk.tokenize import word_tokenize as nltk_tok

        nltk_tok("a")  # the data pack is read on the first call
        return nltk_tok
    except (ImportError, LookupError):
        return None


def word_tokenize(text: str) -> List[str]:
    nltk_tok = _nltk_tokenizer()
    if nltk_tok is None:
        return _WORD_RE.findall(text.lower())
    return nltk_tok(text)


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


def calc_vocab_num(predicts: Sequence[str]) -> List[str]:
    vocab: List[str] = []
    for sentence in predicts:
        for word in word_tokenize(sentence.lower()):
            if word not in vocab:
                vocab.append(word)
    return vocab


def compute(json_path: str, stop_words: Sequence[str] = ()) -> dict:
    """A corpus JSON: a list of {"captions": [...]} items or of caption
    lists."""
    div1 = div2 = 0.0
    vocab: List[str] = []
    with open(json_path, encoding="utf-8") as f:
        corpus = json.load(f)
    for item in corpus:
        caps = item["captions"] if isinstance(item, dict) else item
        dn, vocab = calc_diversity(caps, vocab)
        div1 += dn[0]
        div2 += dn[1]
    n = max(len(corpus), 1)
    div1 /= n
    div2 /= n
    stop = set(stop_words)
    vocab = [w for w in vocab if (w not in stop and "unused" not in w)]
    return {"vocab_len": len(set(vocab)), "div_1": div1, "div_2": div2}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("json_path")
    p.add_argument("--stop_words_path", default=None)
    args = p.parse_args(argv)
    stop: List[str] = []
    if args.stop_words_path:
        with open(args.stop_words_path, encoding="utf-8") as f:
            stop = [line.rstrip() for line in f]
    res = compute(args.json_path, stop)
    print("vocab_len:", res["vocab_len"])
    print("div_1:", res["div_1"])
    print("div_2:", res["div_2"])


if __name__ == "__main__":
    main()
