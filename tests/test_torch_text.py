"""The port's text side == ``conzic_tpu``'s, byte for byte.

The vendored tokenizers run over the fuzz inputs of
tests/test_tokenizer_fuzz.py; the stop masks and the bridge table are built
from the same vocabularies; candidate-row assembly and the exact top-k must
give identical ids, including the tie order of ``jax.lax.top_k`` where the
T=0.1 softmax underflows to exact zeros.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_tokenizer_fuzz import fuzz_strings

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_tpu import energies as jax_energies
from conzic_tpu.text import bridge as jax_bridge
from conzic_tpu.text import vocab as jax_vocab
from conzic_tpu.text.bpe import CLIPBPETokenizer as JaxBPE
from conzic_tpu.text.wordpiece import WordPieceTokenizer as JaxWordPiece
from conzic_torch import energies
from conzic_torch.text import bridge, vocab
from conzic_torch.text.bpe import CLIPBPETokenizer
from conzic_torch.text.wordpiece import WordPieceTokenizer


def _vocab_file(d, v):
    path = os.path.join(d, "vocab.txt")
    with open(path, "w", encoding="utf-8") as f:
        for tok in sorted(v, key=v.get):
            f.write(tok + "\n")
    return path


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """(port wordpiece, jax wordpiece, port bpe, jax bpe) over the test
    vocabularies."""
    d = str(tmp_path_factory.mktemp("torch_text"))
    v = vocab.make_test_wordpiece_vocab(extra_words=["unknownword", "stuff",
                                                     "mixed"])
    assert v == jax_vocab.make_test_wordpiece_vocab(
        extra_words=["unknownword", "stuff", "mixed"])
    wp_path = _vocab_file(d, v)
    bpe_files = vocab.make_test_bpe_files(d)
    jd = str(tmp_path_factory.mktemp("jax_text"))
    jax_bpe_files = jax_vocab.make_test_bpe_files(jd)
    for ours, theirs in zip(bpe_files, jax_bpe_files):
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    return (WordPieceTokenizer.from_vocab_file(wp_path),
            JaxWordPiece.from_vocab_file(wp_path),
            CLIPBPETokenizer.from_files(*bpe_files),
            JaxBPE.from_files(*bpe_files))


def test_wordpiece_matches_reference_package(tokenizers):
    wp, jwp, _, _ = tokenizers
    for s in fuzz_strings(300, seed=0):
        assert wp.tokenize(s) == jwp.tokenize(s), repr(s)
        assert wp.encode(s) == jwp.encode(s), repr(s)
    rng = np.random.RandomState(2)
    rows = [rng.randint(0, wp.vocab_size, size=rng.randint(1, 20)).tolist()
            for _ in range(100)]
    for skip in (False, True):
        assert (wp.batch_decode(rows, skip_special_tokens=skip)
                == jwp.batch_decode(rows, skip_special_tokens=skip))


def test_bpe_matches_reference_package(tokenizers):
    _, _, bpe, jbpe = tokenizers
    for s in fuzz_strings(300, seed=3):
        assert bpe.tokenize(s) == jbpe.tokenize(s), repr(s)
        assert bpe.encode(s) == jbpe.encode(s), repr(s)
    for w in ("image", "of", "a", "unknownword", "mixed42tokens", "zzz"):
        assert bpe.encode_word_ids(w) == jbpe.encode_word_ids(w)


@pytest.mark.parametrize("source", ["test", "fullsize"])
def test_stop_masks_match(source):
    if source == "test":
        v, jv = vocab.make_test_wordpiece_vocab(), \
            jax_vocab.make_test_wordpiece_vocab()
    else:
        v, jv = vocab.make_fullsize_wordpiece_vocab(), \
            jax_vocab.make_fullsize_wordpiece_vocab()
    assert v == jv
    extra = ["girl", "dog"]
    for a, b in zip(vocab.build_token_masks(v, extra_stop_words=extra),
                    jax_vocab.build_token_masks(jv, extra_stop_words=extra)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for tok in ("##ing", "[CLS]", "image", "."):
        assert vocab.token_body(tok) == jax_vocab.token_body(tok)


def test_bridge_table_matches(tokenizers):
    wp, jwp, bpe, jbpe = tokenizers
    ours = bridge.build_bridge_table(wp, bpe)
    theirs = jax_bridge.build_bridge_table(jwp, jbpe)
    assert ours.ids.tobytes() == np.asarray(theirs.ids).tobytes()
    assert ours.lens.tobytes() == np.asarray(theirs.lens).tobytes()
    assert ((ours.bos_id, ours.eos_id, ours.pad_id, ours.max_pieces)
            == (theirs.bos_id, theirs.eos_id, theirs.pad_id,
                theirs.max_pieces))


@pytest.mark.parametrize("clip_len", [8, 24])
def test_assembly_matches(tokenizers, clip_len):
    wp, _, bpe, _ = tokenizers
    table = bridge.build_bridge_table(wp, bpe)
    frame = dict(bos_id=table.bos_id, eos_id=table.eos_id,
                 pad_id=table.pad_id, clip_len=clip_len)
    rng = np.random.RandomState(clip_len)
    B, P, k = 3, 7, 5
    rows = rng.randint(0, wp.vocab_size, size=(B, P)).astype(np.int32)
    cands = rng.randint(0, wp.vocab_size, size=(B, k)).astype(np.int32)
    cands[:, 0] = 0  # a collapsed [PAD] candidate bridges to no piece
    pos = rng.randint(0, P, size=B).astype(np.int32)
    jt = (jnp.asarray(table.ids), jnp.asarray(table.lens))
    tt = (torch.from_numpy(table.ids), torch.from_numpy(table.lens))

    want = jax_bridge.assemble_clip_ids(jnp.asarray(rows), *jt, **frame)
    got = bridge.assemble_clip_ids(torch.from_numpy(rows), *tt, **frame)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    want = jax_bridge.assemble_clip_ids_substitute(
        jnp.asarray(rows), jnp.asarray(cands), jnp.asarray(pos), *jt, **frame)
    got = bridge.assemble_clip_ids_substitute(
        torch.from_numpy(rows), torch.from_numpy(cands),
        torch.from_numpy(pos).long(), *tt, **frame)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_topk_tie_order_matches_lax_top_k():
    """At T=0.1 most of the vocabulary underflows to exactly 0.0, so the
    tail of the top-k is a tie broken by index; the port must pick the
    ids ``jax.lax.top_k`` picks, and collapse masked ones to [PAD]."""
    rng = np.random.RandomState(0)
    B, V, k = 4, 3000, 200
    logits = (rng.randn(B, V) * 12).astype(np.float32)
    logits[:, ::7] = logits[:, :1]  # exact ties among nonzero entries too
    mask = (rng.rand(V) > 0.1).astype(np.float32)
    jprobs = jax_energies.masked_lm_probs(jnp.asarray(logits),
                                          jnp.asarray(mask), 0.1)
    probs = energies.masked_lm_probs(torch.from_numpy(logits),
                                     torch.from_numpy(mask), 0.1)
    # tie-heavy: fewer than k entries of each row are nonzero
    assert ((np.asarray(jprobs) > 0).sum(-1) < k).all()
    np.testing.assert_array_equal(probs.numpy() == 0, np.asarray(jprobs) == 0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6,
                               atol=0)
    _, lax_ids = jax.lax.top_k(jprobs, k)
    jv, ji = jax_energies.topk_candidates(jprobs, jnp.asarray(mask), k)
    tv, ti = energies.topk_candidates(probs, torch.from_numpy(mask), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(
        ti.numpy(), np.asarray(lax_ids) * mask[np.asarray(lax_ids)])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    # a per-row (B, V) mask takes the same path
    _, ti2 = energies.topk_candidates(
        probs, torch.from_numpy(np.tile(mask, (B, 1))), k)
    np.testing.assert_array_equal(ti2.numpy(), ti.numpy())
