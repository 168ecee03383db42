"""Sentence-level sentiment scoring (host side).

Vendored from conzic_tpu/eval/sentiment_eval.py: tokenize the sentence,
POS-tag it in context, map Penn tags to WordNet tags (unmapped tags map to
``''``, which yields no synsets, so those words are left out of the score),
and sum each remaining word's mean SentiWordNet ``pos_score - neg_score``
over its tag-restricted synsets. ``negative`` control flips the sign.

The real NLTK pipeline runs when its data packs are installed; otherwise
the built-in evaluator (regex tokenizer and the curated valence lists of
``text.lexicons``). The built-in one is context-free per word but works on
the decoded sentence, so subword pieces are merged into words first.
Scores are Python floats; the engine casts them to float32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from conzic_torch.eval.ndiv import word_tokenize
from conzic_torch.text.lexicons import _NEGATIVE, _POSITIVE

# Penn -> WordNet tag map of the reference's sentiment classifier
TAG_MAP = {
    "NN": "n", "NNP": "n", "NNPS": "n", "NNS": "n", "UH": "n",
    "VB": "v", "VBD": "v", "VBG": "v", "VBN": "v", "VBP": "v", "VBZ": "v",
    "JJ": "a", "JJR": "a", "JJS": "a",
    "RB": "r", "RBR": "r", "RBS": "r", "RP": "r", "WRB": "r",
}


def _nltk_ready() -> bool:
    try:
        import nltk

        nltk.data.find("corpora/sentiwordnet")
        nltk.data.find("corpora/wordnet")
        nltk.data.find("taggers/averaged_perceptron_tagger")
        nltk.data.find("tokenizers/punkt")
        return True
    except (ImportError, LookupError):
        return False


def text_sentiment_score(text: str, negative: bool = False,
                         use_nltk: Optional[bool] = None) -> float:
    """One sentence's sentiment score."""
    if use_nltk is None:
        use_nltk = _nltk_ready()
    words = word_tokenize(text)
    if use_nltk:
        from nltk import pos_tag
        from nltk.corpus import sentiwordnet

        score = 0.0
        for w, penn in pos_tag(words):
            syns = list(sentiwordnet.senti_synsets(w, TAG_MAP.get(penn, "")))
            if syns:
                score += sum(s.pos_score() - s.neg_score()
                             for s in syns) / len(syns)
    else:
        score = sum(_POSITIVE.get(w, _NEGATIVE.get(w, 0.0))
                    for w in (w.lower() for w in words))
    return -score if negative else score


def batch_texts_sentiment_scores(batch_texts: Sequence[str],
                                 negative: bool = False) -> List[float]:
    """Per-sentence scores for a flat batch of texts (the softmax over
    candidates is ``energies.sentiment_probs``, on the device)."""
    use_nltk = _nltk_ready()
    return [text_sentiment_score(t, negative=negative, use_nltk=use_nltk)
            for t in batch_texts]
