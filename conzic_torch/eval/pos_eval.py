"""POS-template evaluation (host side).

Vendored from conzic_tpu/eval/pos_eval.py (its command line waits for the
port's CLIs): tag captions with the universal tagset, score the
template-match accuracy (matched slots / template length) and histogram
the tag at a word position. NLTK's tagger runs when its data is installed,
else the rule tagger of ``text.lexicons``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from conzic_torch.eval.ndiv import word_tokenize
from conzic_torch.text.lexicons import UNIVERSAL_TAGS, rule_tag


def tag_words(words: Sequence[str]) -> List[str]:
    try:
        from nltk import pos_tag

        return [t for _, t in pos_tag(list(words), tagset="universal")]
    except (ImportError, LookupError):
        return [rule_tag(w.lower()) for w in words]


def text_pos_analysis(text: str) -> List[str]:
    return tag_words(word_tokenize(text))


def batch_texts_pos_analysis(
    batch_texts: Sequence[str], pos_template: Sequence
) -> Tuple[List[List[str]], List[float]]:
    """Returns (tags per text, accuracy per text)."""
    pos_tags: List[List[str]] = []
    pos_scores: List[float] = []
    total_num = len(pos_template)
    for text in batch_texts:
        res_tag = text_pos_analysis(text)
        if len(res_tag) <= total_num:
            cur_tag = res_tag + [""] * (total_num - len(res_tag))
        else:
            cur_tag = res_tag[:total_num]
        correct = 0
        for word_id, slot in enumerate(pos_template):
            # the reference's operators, quirk kept (PARITY.md): a list
            # slot is membership, a STRING slot a substring test, so a
            # short caption's ""-padded tags match every string slot; only
            # a bare "" slot (not [""] or []) always matches
            if slot == "":
                correct += 1
            elif cur_tag[word_id] in slot:
                correct += 1
        pos_tags.append(res_tag)
        pos_scores.append(correct / total_num)
    return pos_tags, pos_scores


def histogram_position(captions: Sequence[str], word_id: int) -> dict:
    """Tag histogram at a fixed word position."""
    hist = {t: 0 for t in UNIVERSAL_TAGS}
    for cap in captions:
        tags = text_pos_analysis(cap)
        if word_id < len(tags):
            hist[tags[word_id]] = hist.get(tags[word_id], 0) + 1
    return hist
