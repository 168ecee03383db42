"""Per-vocab-token control-energy tables (sentiment valence, universal POS).

Vendored from conzic_tpu/text/lexicons.py.

The reference computes control energies by running NLTK on every decoded
candidate sentence inside the hot loop (``word_tokenize`` + ``pos_tag`` +
SentiWordNet per candidate). Table mode precomputes per-token tables over
the BERT vocabulary once, so the energies become gathers on the device.

The tables are built one of two ways:
  - NLTK mode (when NLTK's data packs are installed): SentiWordNet synset
    scores / perceptron-tagger tags per standalone word, the reference's
    per-word terms.
  - built-in mode (no NLTK data): curated valence word lists and a
    closed-class/suffix rule tagger.

Per-token tables approximate sentence-context tagging; the difference only
perturbs the control energy, not the LM/CLIP energies.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

from conzic_torch.text.vocab import token_body

UNIVERSAL_TAGS = [
    "ADJ", "ADP", "ADV", "CONJ", "DET", "NOUN",
    "NUM", "PRON", "PRT", "VERB", ".", "X",
]
TAG_TO_ID = {t: i for i, t in enumerate(UNIVERSAL_TAGS)}

# --- built-in closed classes (universal tagset) ----------------------------
_DET = set("a an the this that these those every each some any no another all both".split())
_ADP = set(
    "in on at by with from of into onto over under near between through during "
    "against about above across after along among around before behind below "
    "beneath beside inside outside toward towards upon within without off".split()
)
_CONJ = set("and or but nor so yet while although because if when than whether".split())
_PRON = set(
    "i you he she it we they me him her us them my your his its our their mine "
    "yours hers ours theirs who whom whose which what something anything "
    "nothing everything someone anyone everyone".split()
)
_PRT = set("not to n't 's up down out".split())
_ADV = set(
    "very too also just then there here now never always often again more most "
    "well really quite almost together away back still even only".split()
)
_VERB = set(
    "is are was were be been being am has have had do does did will would can "
    "could shall should may might must go goes went gone make makes made take "
    "takes took get gets got".split()
)
_ADJ = set(
    "big small large little red blue green yellow black white brown pink purple "
    "orange gray grey old young new good bad great nice pretty beautiful happy "
    "sad angry lovely cute sunny dark bright colorful tall short long high low "
    "hot cold warm cool wet dry clean dirty busy quiet loud soft hard easy "
    "other many few several such own same different full empty fresh".split()
)

_NUM_RE = re.compile(r"^[0-9]+([.,][0-9]+)?$")
_PUNCT_RE = re.compile(r"^[^\w\s]+$")

_ADJ_SUFFIX = ("ous", "ful", "ive", "able", "ible", "less", "ish", "ian", "ary")
_NOUN_SUFFIX = ("tion", "sion", "ment", "ness", "ity", "ship", "ism", "ist", "hood")
_ADV_SUFFIX = ("ly",)
_VERB_SUFFIX = ("ing", "ed", "ify", "ize", "ise")


def rule_tag(word: str) -> str:
    """Universal POS tag for a standalone lowercase word (rule-based)."""
    if not word:
        return "X"
    if _PUNCT_RE.match(word):
        return "."
    if _NUM_RE.match(word):
        return "NUM"
    if word in _DET:
        return "DET"
    if word in _ADP:
        return "ADP"
    if word in _CONJ:
        return "CONJ"
    if word in _PRON:
        return "PRON"
    if word in _PRT:
        return "PRT"
    if word in _ADV:
        return "ADV"
    if word in _VERB:
        return "VERB"
    if word in _ADJ:
        return "ADJ"
    for s in _ADV_SUFFIX:
        if word.endswith(s) and len(word) > len(s) + 2:
            return "ADV"
    for s in _VERB_SUFFIX:
        if word.endswith(s) and len(word) > len(s) + 2:
            return "VERB"
    for s in _ADJ_SUFFIX:
        if word.endswith(s) and len(word) > len(s) + 1:
            return "ADJ"
    for s in _NOUN_SUFFIX:
        if word.endswith(s) and len(word) > len(s) + 1:
            return "NOUN"
    return "NOUN"


# --- built-in sentiment valences -------------------------------------------
_POSITIVE = {
    w: 0.5
    for w in (
        "good great nice beautiful happy lovely cute pretty wonderful amazing "
        "excellent fantastic perfect awesome delightful charming pleasant joyful "
        "cheerful bright sunny smiling smile love loved loving enjoy enjoying "
        "fun funny friendly gentle kind sweet warm cozy fresh clean peaceful "
        "calm relaxing elegant graceful adorable brilliant vibrant colorful "
        "best better glad pleased delicious cool stylish cheer laugh laughing "
        "playful lively healthy rich successful win winning winner celebrate "
        "celebration festive paradise gorgeous stunning magnificent splendid "
        "superb fabulous terrific impressive remarkable thriving blooming"
    ).split()
}
_POSITIVE.update({"happy": 0.75, "beautiful": 0.75, "love": 0.75, "perfect": 0.75})
_NEGATIVE = {
    w: -0.5
    for w in (
        "bad sad angry ugly terrible horrible awful nasty dirty gloomy dark "
        "broken sick ill dead death dying cry crying tears lonely alone afraid "
        "scared fear fearful dangerous hurt pain painful poor wrong worst worse "
        "hate hated boring dull empty cold bitter cruel evil miserable unhappy "
        "depressed depressing annoying disgusting dreadful filthy rotten ruined "
        "wounded injured violent storm stormy rain rainy mess messy trash "
        "garbage waste failed failure lose losing loser weak tired exhausted "
        "hungry starving abandoned damaged grim bleak dismal"
    ).split()
}
_NEGATIVE.update({"sad": -0.75, "terrible": -0.75, "hate": -0.75, "awful": -0.75})


def _nltk_available() -> bool:
    try:
        import nltk

        nltk.data.find("corpora/sentiwordnet")
        nltk.data.find("taggers/averaged_perceptron_tagger")
        # pos_tag(tagset="universal") additionally needs the tagset mapping
        nltk.data.find("taggers/universal_tagset")
        return True
    except LookupError:
        return False
    except ImportError:
        return False


def build_pos_table(
    vocab: Dict[str, int], use_nltk: Optional[bool] = None
) -> np.ndarray:
    """(V,) int32 universal-POS tag id per vocab token. ``##`` pieces get X
    (they never start a tagged word on their own)."""
    if use_nltk is None:
        use_nltk = _nltk_available()
    table = np.full((len(vocab),), TAG_TO_ID["X"], np.int32)
    if use_nltk:
        from nltk import pos_tag
    for tok, i in vocab.items():
        body = token_body(tok)
        if tok.startswith(("[", "<")) or tok.startswith("##") or not body:
            continue
        if use_nltk:
            tag = pos_tag([body], tagset="universal")[0][1]
            table[i] = TAG_TO_ID.get(tag, TAG_TO_ID["X"])
        else:
            table[i] = TAG_TO_ID[rule_tag(body)]
    return table


def build_sentiment_table(
    vocab: Dict[str, int], use_nltk: Optional[bool] = None
) -> np.ndarray:
    """(V,) float32 per-word valence (positive minus negative).

    Exact mode mirrors the reference's per-word term: mean over
    ``senti_synsets(word)`` of ``pos_score - neg_score``
    (sentiments_classifer.py:26-30).
    """
    if use_nltk is None:
        use_nltk = _nltk_available()
    table = np.zeros((len(vocab),), np.float32)
    if use_nltk:
        from nltk.corpus import sentiwordnet

        for tok, i in vocab.items():
            body = token_body(tok)
            if tok.startswith(("[", "<")) or tok.startswith("##") or not body:
                continue
            syns = list(sentiwordnet.senti_synsets(body))
            if syns:
                table[i] = sum(s.pos_score() - s.neg_score() for s in syns) / len(
                    syns
                )
    else:
        for tok, i in vocab.items():
            body = token_body(tok)
            if body in _POSITIVE:
                table[i] = _POSITIVE[body]
            elif body in _NEGATIVE:
                table[i] = _NEGATIVE[body]
    return table


def template_matrix(pos_template, num_tags: int = len(UNIVERSAL_TAGS)) -> np.ndarray:
    """(T, num_tags+1) binary matrix: slot t accepts tag j. Column
    ``num_tags`` is the "empty slot" column: an empty template entry accepts
    anything, and a sentence shorter than the template scores its padded
    slots via the same rule as the reference (pad tag "" matches only empty
    template entries — POS_classifier.py:18-27)."""
    T = len(pos_template)
    m = np.zeros((T, num_tags + 1), np.float32)
    for t, allowed in enumerate(pos_template):
        entries = allowed if isinstance(allowed, (list, tuple)) else [allowed]
        if not entries or entries == [""]:
            m[t, :] = 1.0  # empty template slot accepts everything
            continue
        for tag in entries:
            if tag in TAG_TO_ID:
                m[t, TAG_TO_ID[tag]] = 1.0
    return m
