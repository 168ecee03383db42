"""The port's controlled ``Captioner.run`` == ``conzic_tpu``'s, ids byte for
byte and control scores equal.

Both captioners carry the same fp32 tiny random towers (the pair of
tests/test_torch_engine.py) and get the same image embeddings and seeded
schedule ``RandomState``. Every controlled case must give identical
``iter_ids``, ``best_ids`` and captions, ``iter_ctl`` equal as float32
values, and cosines within 1e-4: sentiment and POS control in table mode,
the same in exact mode (sentence-level scoring of every decoded candidate
on the host), and free captioning with the exact bridge (decode and
re-tokenize on the host). The reference-contract entry functions
``generate_caption`` and ``control_generate_caption`` must return the same
lists and write the same log lines, with the same order rules.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import _embeds, _pair

from conzic_tpu.engine import sampler as jax_sampler
from conzic_torch.engine import sampler
from conzic_torch.text.lexicons import template_matrix

COS_ATOL = 1e-4
TEMPLATE = [["DET"], ["NOUN"], "ADJ", "", ["VERB", "NOUN"]]
_WANT = {}


def _set_cfg(caps, cfg_kw):
    saved = [{k: getattr(c.cfg, k) for k in cfg_kw} for c in caps]
    for c in caps:
        for k, v in cfg_kw.items():
            setattr(c.cfg, k, v)
    return saved


def _restore(caps, saved):
    for c, old in zip(caps, saved):
        for k, v in old.items():
            setattr(c.cfg, k, v)


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.iter_ids, np.asarray(want.iter_ids))
    np.testing.assert_array_equal(got.best_ids, np.asarray(want.best_ids))
    assert got.gen_texts_list == want.gen_texts_list
    assert got.iter_ctl.dtype == np.float32
    np.testing.assert_array_equal(got.iter_ctl, np.asarray(want.iter_ctl))
    np.testing.assert_allclose(np.asarray(got.clip_score_sequence),
                               np.asarray(want.clip_score_sequence),
                               rtol=0, atol=COS_ATOL)


def assert_same_run(caps, cfg_kw, embeds, **run_kw):
    """Run both captioners with the config fields ``cfg_kw`` set on both,
    then restore them; returns the port's result."""
    jc, pc = caps
    saved = _set_cfg(caps, cfg_kw)
    try:
        args = dict(prompt="Image of a", temperature=0.1, alpha=0.02,
                    beta=2.0, gamma=5.0, **run_kw)
        key = repr((id(jc), sorted(cfg_kw.items()), embeds.shape,
                    sorted(run_kw.items())))
        if key not in _WANT:
            _WANT[key] = jc.run(jnp.asarray(embeds),
                                rng=np.random.RandomState(7), **args)
        got = pc.run(embeds, rng=np.random.RandomState(7), **args)
    finally:
        _restore(caps, saved)
    assert_same_result(got, _WANT[key])
    return got


# (config fields, run arguments): the cases of chip_smoke.py's phase 3 and
# a few more (both host modes at once, the parallel order, fused samples)
CASES = {
    "sentiment-table-positive-sequential": (
        {}, dict(ctl="sentiment", order="sequential")),
    "sentiment-table-negative-sequential": (
        {}, dict(ctl="sentiment", negative=True, order="sequential")),
    "sentiment-table-positive-shuffle": (
        {}, dict(ctl="sentiment", order="shuffle")),
    "sentiment-table-negative-shuffle": (
        {}, dict(ctl="sentiment", negative=True, order="shuffle")),
    "pos-table-default": ({}, dict(ctl="pos", order="sequential")),
    "pos-table-per-call": (
        {}, dict(ctl="pos", order="sequential", pos_template=TEMPLATE)),
    "sentiment-exact": (
        dict(ctl_mode="exact"), dict(ctl="sentiment", order="sequential")),
    "pos-exact": (dict(ctl_mode="exact"), dict(ctl="pos",
                                               order="sequential")),
    "pos-exact-per-call": (
        dict(ctl_mode="exact"),
        dict(ctl="pos", order="sequential", pos_template=TEMPLATE)),
    "bridge-exact-sequential": (dict(bridge_mode="exact"),
                                dict(order="sequential")),
    "bridge-exact-span": (dict(bridge_mode="exact"), dict(order="span")),
    "bridge-exact-parallel": (dict(bridge_mode="exact"),
                              dict(order="parallel")),
    "both-exact-sentiment-negative-shuffle": (
        dict(bridge_mode="exact", ctl_mode="exact"),
        dict(ctl="sentiment", negative=True, order="shuffle")),
    "sentiment-table-samples": (
        {}, dict(ctl="sentiment", order="shuffle", n_samples=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_controlled_run_matches_reference(case):
    cfg_kw, run_kw = CASES[case]
    got = assert_same_run(_pair("random"), cfg_kw, _embeds("random", 2),
                          max_len=5, top_k=12, max_iter=2, **run_kw)
    if "ctl" in run_kw:  # the control term scored something
        assert (got.iter_ctl != 0).any()
    else:
        assert (got.iter_ctl == 0).all()


def test_sentiment_polarity_steers_the_captions():
    caps, emb = _pair("random"), _embeds("random", 2)
    runs = [assert_same_run(caps, {}, emb, max_len=5, top_k=12, max_iter=2,
                            ctl="sentiment", negative=neg,
                            order="sequential") for neg in (False, True)]
    assert not np.array_equal(runs[0].iter_ids, runs[1].iter_ids)


def test_per_call_template_leaves_the_shared_tables():
    _, pc = _pair("random")
    pc.run(_embeds("random", 1), prompt="Image of a", max_len=4, top_k=8,
           temperature=0.1, max_iter=1, alpha=0.02, beta=2.0, gamma=5.0,
           ctl="pos", pos_template=TEMPLATE)
    np.testing.assert_array_equal(pc.tables["template"].numpy(),
                                  template_matrix(pc.cfg.pos_type))


def test_host_callables_are_built_once():
    _, pc = _pair("random")
    assert pc._get_host_bridge(32) is pc._get_host_bridge(32)
    assert pc._get_host_bridge(32) is not pc._get_host_bridge(24)
    a = pc._get_host_ctl("pos", False, TEMPLATE)
    assert a is pc._get_host_ctl("pos", False, [list(s) if isinstance(
        s, list) else s for s in TEMPLATE])
    assert a is not pc._get_host_ctl("pos", False, TEMPLATE[:-1])
    assert (pc._get_host_ctl("sentiment", True, None)
            is not pc._get_host_ctl("sentiment", False, None))


def test_host_bridge_mirrors_batch_encode():
    """One candidate batch through the exact bridge == the tokenizers'
    decode then ``batch_encode(max_length=clip_len, pad_to_max=True)``,
    and == the reference's host bridge."""
    jc, pc = _pair("random")
    rng = np.random.RandomState(3)
    inner = torch.from_numpy(rng.randint(0, pc.wp.vocab_size, (2, 3, 9)))
    ids, mask = pc._get_host_bridge(16)(inner)
    texts = pc.wp.batch_decode(inner.reshape(6, 9).numpy(),
                               skip_special_tokens=True)
    want_ids, want_mask = pc.bpe.batch_encode(texts, max_length=16,
                                              pad_to_max=True)
    assert ids.dtype == mask.dtype == torch.int32
    np.testing.assert_array_equal(ids.reshape(6, 16).numpy(), want_ids)
    np.testing.assert_array_equal(mask.reshape(6, 16).numpy(), want_mask)
    ref_ids, ref_mask = jc._get_host_bridge(16)(inner.numpy())
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)


# ---------------------------------------------------------------------------
# the reference's entry functions
# ---------------------------------------------------------------------------


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler = _Lines()
    logger.handlers = [handler]
    return logger, handler


def _same_entry_call(port_fn, jax_fn, **kw):
    """Both entry functions on the same embeddings; the returned lists and
    the log lines (but for the timing line) must be equal."""
    jc, pc = _pair("random")
    emb = _embeds("random", 2)
    names = ["img0.jpg", "img1.jpg"]
    saved = _set_cfg((jc, pc), dict(verbose=True))
    try:
        logs = []
        outs = []
        for fn, cap, e, tag in ((jax_fn, jc, jnp.asarray(emb), "jax"),
                                (port_fn, pc, emb, "port")):
            logger, handler = _logger(f"entry-{tag}")
            outs.append(fn(names, cap, e, logger, prompt="Image of a",
                           batch_size=2, max_len=5, top_k=12,
                           temperature=0.1, max_iter=2, alpha=0.02, beta=2.0,
                           rng=np.random.RandomState(7), **kw))
            logs.append([x for x in handler.lines
                         if not x.startswith("Finished in")])
    finally:
        _restore((jc, pc), saved)
    (jtexts, jscores), (ptexts, pscores) = outs
    assert ptexts == jtexts
    assert ptexts[-2] == jtexts[-2] and ptexts[-1] == jtexts[-1]
    np.testing.assert_allclose(np.asarray(pscores), np.asarray(jscores),
                               rtol=0, atol=COS_ATOL)
    assert logs[0] == logs[1]
    assert len(logs[1]) == 2 * 2 + 3 * 2  # two iterations, three lines
    return ptexts


@pytest.mark.parametrize("order", ["sequential", "span"])
def test_generate_caption_matches_reference(order):
    _same_entry_call(sampler.generate_caption, jax_sampler.generate_caption,
                     generate_order=order)


@pytest.mark.parametrize("ctl_type,style,template,order,runs_as", [
    ("sentiment", "positive", None, "span", "shuffle"),
    ("sentiment", "negative", None, "sequential", "sequential"),
    ("sentiment", "positive", None, "random", "shuffle"),
    ("pos", "positive", None, "shuffle", "sequential"),
    ("pos", "negative", TEMPLATE, "span", "sequential"),
])
def test_control_generate_caption_matches_reference(ctl_type, style,
                                                    template, order,
                                                    runs_as):
    texts = _same_entry_call(
        sampler.control_generate_caption,
        jax_sampler.control_generate_caption, gamma=5.0, ctl_type=ctl_type,
        style_type=style, pos_type=template, generate_order=order)
    # the order the entry function ran is the coerced one
    _, pc = _pair("random")
    direct = pc.run(_embeds("random", 2), prompt="Image of a", max_len=5,
                    top_k=12, temperature=0.1, max_iter=2, alpha=0.02,
                    beta=2.0, gamma=5.0, order=runs_as, ctl=ctl_type,
                    negative=ctl_type == "sentiment" and style == "negative",
                    pos_template=template, rng=np.random.RandomState(7))
    assert direct.gen_texts_list == texts


def test_entry_function_replicates_one_image():
    """One preprocessed (H, W, C) image is captioned batch_size times, as
    the same image stacked batch_size times is."""
    _, pc = _pair("random")
    v = pc.clip_model.config.vision
    px = np.random.RandomState(4).rand(v.image_size, v.image_size,
                                       v.num_channels).astype(np.float32)
    logger, _ = _logger("entry-pixels")
    kw = dict(prompt="Image of a", batch_size=2, max_len=4, top_k=8,
              temperature=0.1, max_iter=1, alpha=0.02, beta=2.0, gamma=5.0,
              ctl_type="sentiment")
    one = sampler.control_generate_caption(
        ["a", "b"], pc, px, logger, rng=np.random.RandomState(7), **kw)
    stacked = sampler.control_generate_caption(
        ["a", "b"], pc, np.stack([px, px]), logger,
        rng=np.random.RandomState(7), **kw)
    assert one == stacked
    assert one[0][-2][0] == one[0][-2][1]
