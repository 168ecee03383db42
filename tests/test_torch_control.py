"""The port's control pieces == ``conzic_tpu``'s: lexicon tables, host
evaluators and the control energy terms.

The tables and template matrices must be equal over the synthetic test and
full-size vocabularies and ``trained_tiny/vocab.txt``; the evaluators must
give equal results on seeded fuzzed captions; the energy terms must agree
bit for bit where the reference's compiled arithmetic can be reproduced
(sums of table values; the mean over T slots and the division by the POS
temperature, which XLA compiles into products with float32 reciprocals;
the combine's order of additions) and within 8 fp32 ulps where a softmax
or ``exp`` rounds. Two differences of the reference's compiler are pinned
by how far they reach: XLA's ``exp`` on the CPU differs from PyTorch's by
one ulp at a few small integers, and XLA contracts the combine's products
and sums into fused multiply-adds.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import TRAINED_TINY
from conzic_tpu import config as jax_config
from conzic_tpu import energies as jen
from conzic_tpu.eval import ndiv as jndiv
from conzic_tpu.eval import pos_eval as jpos
from conzic_tpu.eval import sentiment_eval as jsent
from conzic_tpu.text import lexicons as jlex
from conzic_tpu.text import vocab as jvocab
from conzic_torch import config, energies
from conzic_torch.eval import ndiv, pos_eval, sentiment_eval
from conzic_torch.text import lexicons, vocab

ULPS = 8  # softmax and exp terms: within 8 fp32 ulps of the reference


def _vocab(source):
    if source == "test":
        return vocab.make_test_wordpiece_vocab()
    if source == "fullsize":
        return vocab.make_fullsize_wordpiece_vocab()
    with open(os.path.join(TRAINED_TINY, "vocab.txt"),
              encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _bits_equal(a, b):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# lexicons
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["test", "fullsize", "trained_tiny"])
def test_tables_match_reference(source):
    v = _vocab(source)
    if source != "trained_tiny":
        assert v == getattr(jvocab, f"make_{source}_wordpiece_vocab")()
    for name in ("build_pos_table", "build_sentiment_table"):
        got = getattr(lexicons, name)(v)
        want = getattr(jlex, name)(v)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the built-in tables: no NLTK data in either package's environment
    assert lexicons._nltk_available() == jlex._nltk_available()


def test_rule_tag_matches_reference():
    words = sorted({vocab.token_body(t) for t in _vocab("fullsize")})
    words += ["", "...", "3.5", "1,000", "quickly", "ly", "running", "ing",
              "famous", "kindness", "realize", "x", "n't", "'s", "A"]
    assert ([lexicons.rule_tag(w) for w in words]
            == [jlex.rule_tag(w) for w in words])
    assert lexicons.UNIVERSAL_TAGS == jlex.UNIVERSAL_TAGS
    assert lexicons._POSITIVE == jlex._POSITIVE
    assert lexicons._NEGATIVE == jlex._NEGATIVE


TEMPLATES = [
    config.DEFAULT_POS_TEMPLATE,
    [["DET"], [""], [], "", "NOUN", ["ADJ", "NOUN", "UNKNOWN"]],
    [["."], ["X", "NUM"], "VERB"],
    [],
]


@pytest.mark.parametrize("template", TEMPLATES)
def test_template_matrix_matches_reference(template):
    got = lexicons.template_matrix(template)
    want = jlex.template_matrix(template)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_config_defaults_match_reference():
    assert config.DEFAULT_POS_TEMPLATE == jax_config.DEFAULT_POS_TEMPLATE
    ours, theirs = config.ConzicConfig(), jax_config.ConzicConfig()
    for knob in ("pos_type", "bridge_mode", "ctl_mode", "verbose"):
        assert getattr(ours, knob) == getattr(theirs, knob), knob


# ---------------------------------------------------------------------------
# host evaluators
# ---------------------------------------------------------------------------

_WORDS = ("a the image of girl dog happy sad beautiful terrible love hate "
          "nice awful sunny rain quickly running famous kindness red two "
          "3 3.5 . , ! ? ' - it's don't isn't Happy SAD Love").split()


def fuzz_captions(n=200, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        words = [_WORDS[i] for i in rng.randint(0, len(_WORDS),
                                                rng.randint(0, 16))]
        seps = [" ", "", "  "]
        text = ""
        for w in words:
            text += seps[rng.randint(0, 3)] + w
        out.append(text)
    return out


def test_word_tokenize_matches_reference():
    for text in fuzz_captions():
        assert ndiv.word_tokenize(text) == jndiv.word_tokenize(text)


def test_diversity_matches_reference():
    caps = fuzz_captions(60, seed=1)
    groups = [caps[i:i + 5] for i in range(0, 60, 5)]
    v_ours, v_theirs = [], []
    for g in groups:
        ours, v_ours = ndiv.calc_diversity(g, v_ours)
        theirs, v_theirs = jndiv.calc_diversity(g, v_theirs)
        assert ours == theirs
    assert v_ours == v_theirs


@pytest.mark.parametrize("negative", [False, True])
def test_sentiment_scores_match_reference(negative):
    caps = fuzz_captions(seed=2)
    ours = sentiment_eval.batch_texts_sentiment_scores(caps, negative)
    theirs = jsent.batch_texts_sentiment_scores(caps, negative)
    # Python numbers (an empty caption sums to the int 0, as there)
    assert [type(s) for s in ours] == [type(s) for s in theirs]
    assert ours == theirs
    assert any(s != 0 for s in ours)
    assert sentiment_eval.TAG_MAP == jsent.TAG_MAP
    assert sentiment_eval._nltk_ready() == jsent._nltk_ready()
    for text in caps[:20]:
        assert (sentiment_eval.text_sentiment_score(text, negative)
                == jsent.text_sentiment_score(text, negative))


@pytest.mark.parametrize("template", TEMPLATES[:3] + [
    "DET NOUN VERB".split(), ["", [""], "NOUN"]])
def test_pos_analysis_matches_reference(template):
    """String slots are substring tests and only a bare "" slot always
    matches, in both packages."""
    caps = fuzz_captions(seed=3)
    assert (pos_eval.batch_texts_pos_analysis(caps, template)
            == jpos.batch_texts_pos_analysis(caps, template))


def test_pos_string_slot_quirk_is_kept():
    # "" (a padded tag of a short caption) is a substring of any string
    # slot, so a one-word caption matches every string slot after its word
    _, scores = pos_eval.batch_texts_pos_analysis(["dog"], ["DET", "NOUN",
                                                            "VERB"])
    assert scores == [2 / 3]  # "dog" is NOUN, not in "DET"; "" in the rest
    _, scores = pos_eval.batch_texts_pos_analysis(["dog"], [["DET"], [""],
                                                            []])
    assert scores == [1 / 3]  # only [""] holds the padded ""


def test_tags_and_histogram_match_reference():
    caps = fuzz_captions(seed=4)
    for text in caps:
        assert (pos_eval.text_pos_analysis(text)
                == jpos.text_pos_analysis(text))
    for word_id in (0, 2, 7):
        assert (pos_eval.histogram_position(caps, word_id)
                == jpos.histogram_position(caps, word_id))


# ---------------------------------------------------------------------------
# energy terms
# ---------------------------------------------------------------------------


def _cand(seed, B=4, k=24, S=14, V=40, tie_heavy=False):
    """(B, k) candidate ids and (B, k, S) candidate rows holding them."""
    rng = np.random.RandomState(seed)
    hi = 4 if tie_heavy else V
    rows = rng.randint(0, hi, size=(B, 1, S)).repeat(k, axis=1)
    ids = rng.randint(0, hi, size=(B, k))
    col = rng.randint(1, S - 1, size=B)
    rows[np.arange(B), :, col] = ids
    return ids, rows


@pytest.mark.parametrize("tie_heavy", [False, True])
def test_repeat_penalty_matches_reference(tie_heavy):
    ids, rows = _cand(0, tie_heavy=tie_heavy)
    got = energies.repeat_penalty(torch.from_numpy(ids),
                                  torch.from_numpy(rows)).numpy()
    want = np.asarray(jax.jit(jen.repeat_penalty)(ids, rows))
    repeats = (rows == ids[:, :, None]).sum(2) - 1
    # bit for bit but where the two exps differ, by one ulp, at an integer
    r = np.arange(rows.shape[2], dtype=np.float32)
    off = r[np.asarray(jnp.exp(r)).view(np.int32)
            != torch.exp(torch.from_numpy(r)).numpy().view(np.int32)]
    same = ~np.isin(repeats, off)
    assert _bits_equal(got[same], want[same])
    assert _ulps(got, want) <= 1
    if tie_heavy:
        assert repeats.max() >= 4  # the rows reach the integers that differ


def test_exp_of_small_integers_against_xla():
    """XLA's exp on the CPU against PyTorch's at 0 .. 77 (a row holds at
    most 77 ids): equal but for one ulp at a few integers (4, 13, 48, 49,
    54, 58 and 64 with this repository's versions; ROADMAP Queue 3)."""
    r = np.arange(78, dtype=np.float32)
    xla = np.asarray(jax.jit(jnp.exp)(r))
    ours = torch.exp(torch.from_numpy(r)).numpy()
    assert xla[0] == ours[0] == 1.0
    assert _ulps(xla, ours) <= 1
    assert _bits_equal(xla[:4], ours[:4])  # no, one, two or three repeats


def test_exp_difference_moves_no_argmax():
    """Tie-heavy candidate sets whose repeat counts include 4 and 13: the
    combined score's argmax (first maximum) is the same whichever exp the
    penalty takes, because a one-ulp change of the penalty is smaller than
    any gap between the other terms of two candidates."""
    rng = np.random.RandomState(5)
    B, k, S = 64, 16, 15
    rows = np.zeros((B, k, S), np.int64)
    ids = np.zeros((B, k), np.int64)
    for b in range(B):
        for j in range(k):
            n = rng.choice([0, 1, 4, 5, 13, 14])  # copies of the id
            ids[b, j] = j + 1
            rows[b, j, :] = 100 + rng.randint(0, 3, size=S)
            rows[b, j, :min(n, S)] = j + 1
            rows[b, j, S - 1] = j + 1 if n else rows[b, j, S - 1]
    lm = np.where(rng.rand(B, k) < 0.6, 0.0, rng.rand(B, k)).astype(
        np.float32)
    clip = np.full((B, k), 1.0 / k, np.float32)
    ctl = np.full((B, k), 1.0 / k, np.float32)
    got = energies.combine_scores(
        torch.from_numpy(lm), torch.from_numpy(clip), 0.02, 2.0,
        torch.from_numpy(ctl), 5.0,
        energies.repeat_penalty(torch.from_numpy(ids),
                                torch.from_numpy(rows)))
    f32 = jnp.float32
    want = jen.combine_scores(lm, clip, f32(0.02), f32(2.0), ctl, f32(5.0),
                              jen.repeat_penalty(ids, rows))
    np.testing.assert_array_equal(torch.argmax(got, dim=1).numpy(),
                                  np.asarray(jnp.argmax(want, axis=1)))


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("table", ["builtin", "random"])
def test_sentiment_scores_and_probs_match_reference(table, negative):
    ids, rows = _cand(1, tie_heavy=table == "builtin")
    rng = np.random.RandomState(2)
    if table == "builtin":  # valences of the built-in lists: exact sums
        senti = rng.choice([0.0, 0.0, 0.5, 0.75, -0.5, -0.75],
                           size=40).astype(np.float32)
    else:  # per-synset means, as NLTK's tables hold: sums round
        senti = (rng.randn(40) * 0.3).astype(np.float32)
    got = energies.sentiment_scores(torch.from_numpy(rows),
                                    torch.from_numpy(senti), negative)
    want = jen.sentiment_scores(rows, jnp.asarray(senti), negative)
    if table == "builtin":
        assert _bits_equal(got.numpy(), want)
    else:
        assert _ulps(got.numpy(), want) <= ULPS
    probs = energies.sentiment_probs(got).numpy()
    assert _ulps(probs, np.asarray(jen.sentiment_probs(want))) <= ULPS


@pytest.mark.parametrize("W,T", [(12, 12), (8, 12), (16, 12), (11, 7)])
def test_pos_accuracy_and_probs_match_reference(W, T):
    """pos_accuracy is the reference's mean over T slots as XLA compiles
    it, the count times float32(1 / T), bit for bit; pos_probs divides by
    0.1 as a product with 10.0."""
    rng = np.random.RandomState(W * 100 + T)
    B, k, V, C = 3, 20, 50, len(lexicons.UNIVERSAL_TAGS) + 1
    word_ids = rng.randint(0, V, size=(B, k, W))
    pos_table = rng.randint(0, C - 1, size=V).astype(np.int32)
    template = (rng.rand(T, C) < 0.4).astype(np.float32)
    word_valid = (rng.rand(B, k, W) < 0.8).astype(np.int32)
    got = energies.pos_accuracy(*(torch.from_numpy(a) for a in (
        word_ids, pos_table, template, word_valid)))
    want = jen.pos_accuracy(word_ids, pos_table, template, word_valid)
    assert _bits_equal(got.numpy(), want)
    jitted = jax.jit(jen.pos_accuracy)(word_ids, pos_table, template,
                                       word_valid)
    assert _bits_equal(got.numpy(), jitted)
    probs = energies.pos_probs(got).numpy()
    assert _ulps(probs, np.asarray(jen.pos_probs(want))) <= ULPS
    # the softmax's input, bit for bit
    assert _bits_equal(energies._div_const(got, 0.1).numpy(),
                       jax.jit(lambda a: a / 0.1)(want))


def test_constant_divisions_follow_xla_not_true_division():
    """The reference divides by a constant (the T of a mean, the POS
    temperature) as XLA compiles it, a product with the float32
    reciprocal; a true division gives other values at some inputs, and so
    would other caption scores. A divisor the reference passes at run time
    (the LM temperature) stays a true division."""
    counts = np.arange(13, dtype=np.float32)
    xla = np.asarray(jax.jit(lambda c: c / 12.0)(counts))
    ours = energies._div_const(torch.from_numpy(counts), 12.0).numpy()
    true = energies._div(torch.from_numpy(counts), 12.0).numpy()
    assert _bits_equal(ours, xla)
    assert not _bits_equal(true, xla)  # 7 / 12 rounds the other way
    acc = (np.arange(13, dtype=np.float32) * np.float32(1 / 12))
    assert _bits_equal(energies._div_const(torch.from_numpy(acc), 0.1),
                       jax.jit(lambda a: a / 0.1)(acc))
    logits = np.random.RandomState(0).randn(64).astype(np.float32)
    assert _bits_equal(energies._div(torch.from_numpy(logits), 0.1),
                       jax.jit(lambda a, t: a / t)(logits, np.float32(0.1)))


def test_combine_order_and_first_maximum_match_reference():
    """((alpha lm + beta clip) + gamma ctl) + penalty, bit for bit against
    the reference's formula, on values where another order of the
    additions rounds differently, and the argmax keeps the first of tied
    maxima. XLA's compiled combine contracts products and sums into fused
    multiply-adds, one ulp away at some entries; its argmax is the same
    here."""
    rng = np.random.RandomState(7)
    B, k = 16, 32
    lm = np.where(rng.rand(B, k) < 0.5, 0.0,
                  rng.rand(B, k)).astype(np.float32)
    clip = rng.rand(B, k).astype(np.float32) * 1e-3
    ctl = rng.choice([1.0 / 3, 1e-8, 0.5], size=(B, k)).astype(np.float32)
    pen = rng.choice([0.0, -0.17182817, -1e-7], size=(B, k)).astype(
        np.float32)
    lm[:, :8] = lm[:, :1]  # exact ties among the first candidates
    clip[:, :8] = clip[:, :1]
    ctl[:, :8] = ctl[:, :1]
    pen[:, :8] = pen[:, :1]
    t = [torch.from_numpy(a) for a in (lm, clip, ctl, pen)]
    got = energies.combine_scores(t[0], t[1], 0.02, 2.0, t[2], 5.0, t[3])
    f32 = jnp.float32
    hyper = (f32(0.02), f32(2.0), ctl, f32(5.0), pen)
    want = jen.combine_scores(lm, clip, *hyper)
    assert _bits_equal(got.numpy(), want)
    fused = jax.jit(jen.combine_scores)(lm, clip, *hyper)
    assert _ulps(got.numpy(), fused) <= 1
    for ref in (want, fused):
        np.testing.assert_array_equal(torch.argmax(got, dim=1).numpy(),
                                      np.asarray(jnp.argmax(ref, axis=1)))
    other = 0.02 * t[0] + (2.0 * t[1] + (5.0 * t[2] + t[3]))
    assert not torch.equal(other, got)  # the order is observable here
    free = energies.combine_scores(t[0], t[1], 0.02, 2.0)
    assert _bits_equal(free.numpy(), jen.combine_scores(
        lm, clip, f32(0.02), f32(2.0)))
