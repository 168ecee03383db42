"""POS-template evaluation (host side).

Counterpart of ``conzic_tpu/eval/pos_eval.py``: tag captions with the
universal tagset, score the template-match accuracy (matched slots /
template length) and histogram the tag at a word position over a results
file of ``api.run``. NLTK's tagger runs when its data is installed, else
the rule tagger of ``text.lexicons``.

    python -m conzic_torch.eval.pos_eval results/.../iter_N.json \
        [--word_id 12] [--template '[["DET"], ["NOUN"]]']
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import List, Sequence, Tuple

from conzic_torch.eval.ndiv import word_tokenize
from conzic_torch.text.lexicons import UNIVERSAL_TAGS, rule_tag


@functools.lru_cache(maxsize=None)
def _nltk_pos_tag():
    """NLTK's ``pos_tag`` when NLTK and its tagger data are installed,
    else None; decided once per process, as ``ndiv.word_tokenize``
    decides its tokenizer."""
    try:
        from nltk import pos_tag

        pos_tag(["a"], tagset="universal")  # reads the tagger data
        return pos_tag
    except (ImportError, LookupError):
        return None


def tag_words(words: Sequence[str]) -> List[str]:
    pos_tag = _nltk_pos_tag()
    if pos_tag is None:
        return [rule_tag(w.lower()) for w in words]
    return [t for _, t in pos_tag(list(words), tagset="universal")]


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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("results_json", help="an iter_N.json results file")
    p.add_argument("--word_id", type=int, default=12)
    p.add_argument("--template", type=str, default=None,
                   help="JSON list template, e.g. '[[\"DET\"],[\"NOUN\"]]'")
    args = p.parse_args(argv)
    with open(args.results_json, encoding="utf-8") as f:
        res = json.load(f)
    captions: List[str] = []
    for v in (res.values() if isinstance(res, dict) else res):
        captions.extend(v if isinstance(v, list) else [v])
    if args.template:
        template = json.loads(args.template)
        _, scores = batch_texts_pos_analysis(captions, template)
        print("mean template accuracy:", sum(scores) / max(len(scores), 1))
    print("tag histogram at word", args.word_id, ":",
          histogram_position(captions, args.word_id))


if __name__ == "__main__":
    main()
