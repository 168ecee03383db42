"""The port's command-line path == ``conzic_tpu``'s.

``conzic_torch.api.demo.main`` and ``conzic_torch.api.run.main`` load
``trained_tiny/`` through ``--lm_model`` / ``--match_model`` on the CPU and
must write the reference package's log lines (all but the timing lines and
the echo of the parsed flags) and its ``results/`` tree byte for byte, when
``conzic_tpu``'s CLIs run with the same flags. Also held: the batch runner's
drop of a trailing partial batch and skip of an unreadable file, fused
samples equal to looped ones, the runtime helpers (prefetch, timers, tracing, seeding, log names), the reference
signatures of ``compat``, CLIPScore, and the ndiv and POS command lines on
the written tree.
"""

import builtins
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import TRAINED_TINY
from conzic_tpu import compat as jax_compat
from conzic_tpu.api import demo as jax_demo
from conzic_tpu.api import run as jax_run
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_tpu.eval import clipscore as jax_clipscore
from conzic_tpu.eval import ndiv as jax_ndiv
from conzic_tpu.eval import pos_eval as jax_pos_eval
from conzic_tpu.runtime import logging as jax_logging
from conzic_tpu.runtime import seeding as jax_seeding
from conzic_torch import compat
from conzic_torch.api import demo, run
from conzic_torch.config import ConzicConfig
from conzic_torch.engine import sampler
from conzic_torch.engine.sampler import Captioner
from conzic_torch.eval import clipscore, ndiv, pos_eval
from conzic_torch.runtime import logging as port_logging
from conzic_torch.runtime import profiling, seeding
from conzic_torch.runtime.prefetch import prefetch_map

EXAMPLES = os.path.join(os.path.dirname(TRAINED_TINY), "examples")
TINY = ["--lm_model", TRAINED_TINY, "--match_model", TRAINED_TINY,
        "--device", "cpu", "--dtype", "float32", "--sentence_len", "4",
        "--candidate_k", "8", "--num_iterations", "2"]


def _lines(log_dir):
    """The log file's lines, but for the timing lines and the echo of the
    parsed flags (the two packages' flags differ in --device and
    --attn_impl)."""
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name), encoding="utf-8") as f:
        return [x for x in f.read().splitlines()
                if not x.startswith(("Finished in", "Namespace("))]


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _in_dir(path, monkeypatch, fn, argv):
    os.makedirs(path, exist_ok=True)
    monkeypatch.chdir(path)
    fn(argv)
    return path


DEMO_CASES = {
    "caption, fused samples": ["--order", "shuffle", "--samples_num", "2"],
    "sentiment negative": ["--run_type", "controllable", "--order",
                           "sequential", "--sentiment_type", "negative",
                           "--samples_num", "1"],
}


@pytest.mark.parametrize("case", list(DEMO_CASES))
def test_demo_matches_reference(case, tmp_path, monkeypatch):
    argv = TINY + DEMO_CASES[case] + [
        "--caption_img_path", os.path.join(EXAMPLES, "girl.jpg")]
    want = _in_dir(tmp_path / "jax", monkeypatch, jax_demo.main, argv)
    got = _in_dir(tmp_path / "port", monkeypatch, demo.main, argv)
    ours = _lines(os.path.join(got, "logger"))
    assert ours == _lines(os.path.join(want, "logger"))
    assert sum(x.startswith("final caption:") for x in ours) == (
        2 if "fused" in case else 1)
    if "fused" in case:  # the loop of single samples writes the same
        loop = _in_dir(tmp_path / "loop", monkeypatch, demo.main,
                       argv + ["--no_fuse_samples"])
        assert _lines(os.path.join(loop, "logger")) == ours


@pytest.fixture(scope="module")
def run_trees(tmp_path_factory):
    """The results trees and logs of both packages' run CLI over
    examples/ (three images, batches of two: one batch), two samples."""
    root = tmp_path_factory.mktemp("run")
    argv = TINY + ["--order", "shuffle", "--samples_num", "2",
                   "--batch_size", "2", "--caption_img_path", EXAMPLES]
    cwd = os.getcwd()
    try:
        for tag, fn in (("jax", jax_run.main), ("port", run.main)):
            os.makedirs(root / tag)
            os.chdir(root / tag)
            fn(argv)
    finally:
        os.chdir(cwd)
    return root


def test_run_matches_reference(run_trees):
    ours = _tree(run_trees / "port" / "results")
    assert ours == _tree(run_trees / "jax" / "results")
    assert sorted(os.path.basename(p) for p in ours) == [
        "best_clipscore.json", "best_clipscore.json", "iter_0.json",
        "iter_0.json", "iter_1.json", "iter_1.json"]
    best = json.loads(next(v for k, v in ours.items()
                           if k.endswith("sample_0/best_clipscore.json")))
    assert sorted(best) == ["dog", "girl"]  # sorted names, drop_last
    assert (_lines(run_trees / "port" / "logger")
            == _lines(run_trees / "jax" / "logger"))


def test_run_drops_the_partial_batch_and_skips_unreadable_files(
        tmp_path, monkeypatch):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (40, 56, 3), dtype=np.uint8)
                        ).save(img_dir / f"img_{i}.png")
    (img_dir / "corrupt.jpg").write_bytes(b"not an image at all")
    _in_dir(tmp_path / "out", monkeypatch, run.main, TINY + [
        "--order", "sequential", "--samples_num", "1", "--batch_size", "2",
        "--num_iterations", "1", "--caption_img_path", str(img_dir)])
    log = "\n".join(_lines(tmp_path / "out" / "logger"))
    assert "skipping unreadable image corrupt.jpg" in log
    (sample_dir,) = (tmp_path / "out" / "results").glob("*/sample_0")
    assert sorted(os.listdir(sample_dir)) == ["best_clipscore.json",
                                              "iter_0.json"]
    with open(sample_dir / "iter_0.json") as f:
        assert sorted(json.load(f)) == ["img_0", "img_1"]


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path,
                                                       monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    monkeypatch.chdir(tmp_path)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(argv + ["--caption_img_path",
                          os.path.join(EXAMPLES, "girl.jpg")])
    with pytest.raises(SystemExit, match="image not found"):
        demo.main(TINY + ["--caption_img_path", str(tmp_path / "no.jpg")])


def test_prefetch_map_order_errors_and_abandonment():
    for workers in (1, 4):
        assert list(prefetch_map(lambda x: x * 2, range(17),
                                 workers=workers)) == [
            x * 2 for x in range(17)]

        def boom(x):
            if x == 5:
                raise ValueError("x5")
            return x

        got = []
        with pytest.raises(ValueError, match="x5"):
            for v in prefetch_map(boom, range(10), workers=workers):
                got.append(v)
        assert got == [0, 1, 2, 3, 4]
        before = {t.ident for t in threading.enumerate()}
        gen = prefetch_map(lambda x: x, range(100), workers=workers)
        assert next(gen) == 0
        gen.close()
        deadline = time.time() + 5.0
        extra = ["?"]
        while extra and time.time() < deadline:
            extra = [t for t in threading.enumerate()
                     if t.ident not in before and t.is_alive()]
            time.sleep(0.05)
        assert not extra, f"prefetch worker leaked: {extra}"


def test_stage_timers_annotate_and_trace(tmp_path, monkeypatch):
    # a span is a shared no-op without a profiler, and either way lets the
    # body's exception through
    assert profiling.span("stage") is profiling.span("other")
    with pytest.raises(ValueError, match="real error"):
        with profiling.span("stage"):
            raise ValueError("real error")
    with profiling.trace():  # no directory: nothing is written
        pass
    monkeypatch.setenv("CONZIC_TRACE_DIR", str(tmp_path / "trace"))
    with profiling.trace():
        with profiling.span("entry.preprocess"):
            torch.ones(4).sum()
        with pytest.raises(ValueError, match="real error"):
            with profiling.span("stage"):
                raise ValueError("real error")
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as f:
        assert "conzic.entry.preprocess" in f.read()


def test_seeding_and_log_names_match_reference():
    ours, theirs = seeding.set_seed(5), jax_seeding.set_seed(5)
    assert ours.randint(0, 1000, 8).tolist() == theirs.randint(0, 1000,
                                                               8).tolist()
    seeding.set_seed(5)
    a = torch.rand(3)
    seeding.set_seed(5)
    assert torch.equal(torch.rand(3), a)
    for kw in ({}, dict(run_type="controllable"),
               dict(run_type="controllable", sentiment_type="negative"),
               dict(run_type="controllable", control_type="pos")):
        cfg, jcfg = ConzicConfig(**kw), JaxConfig(**kw)
        assert port_logging.run_type_label(cfg) == \
            jax_logging.run_type_label(jcfg)
        assert port_logging.run_log_filename(cfg, "demo")[:-24] == \
            jax_logging.run_log_filename(jcfg, "demo")[:-24]
    assert port_logging.null_logger().handlers


def test_config_defaults_match_reference():
    ours, theirs = ConzicConfig(), JaxConfig()
    for knob in ("seed", "batch_size", "run_type", "prompt", "order",
                 "control_type", "sentiment_type", "samples_num",
                 "sentence_len", "candidate_k", "alpha", "beta", "gamma",
                 "lm_temperature", "num_iterations", "lm_model",
                 "match_model", "caption_img_path", "logger_dir",
                 "results_dir", "prune_k", "prune_stage1", "topk_chunk",
                 "topk_recall", "clip_window", "mesh_data_axis"):
        assert getattr(ours, knob) == getattr(theirs, knob), knob


@pytest.fixture(scope="module")
def tiny_pair():
    jc = JaxCaptioner.from_tiny_dir(JaxConfig(dtype="float32", verbose=False),
                                    TRAINED_TINY)
    pc = Captioner.from_tiny_dir(ConzicConfig(dtype="float32", verbose=False),
                                 TRAINED_TINY, device="cpu")
    return jc, pc


def test_compat_signatures_match_reference(tiny_pair):
    jc, pc = tiny_pair
    emb = np.random.RandomState(0).randn(
        1, pc.clip_model.config.projection_dim).astype(np.float32)
    logger = port_logging.null_logger()
    kw = dict(prompt="Image of a", batch_size=1, max_len=4, top_k=6,
              temperature=0.1, max_iter=2, alpha=0.02, beta=2.0,
              generate_order="sequential")
    texts, scores = compat.generate_caption(["x.jpg"], pc, None, None, emb,
                                            None, logger, **kw)
    jtexts, _ = jax_compat.generate_caption(["x.jpg"], jc, None, None,
                                            jnp.asarray(emb), None,
                                            jax_logging.null_logger(), **kw)
    assert texts == jtexts and len(scores) == 3
    ctexts, _ = compat.control_generate_caption(
        ["x.jpg"], pc, None, None, emb, None, logger, gamma=5.0,
        ctl_type="pos", **kw)
    assert len(ctexts) == 3
    with pytest.raises(TypeError, match="Captioner"):
        compat.generate_caption(["x"], object(), None, None, emb, None,
                                logger)
    assert (compat.get_init_text(pc.wp, "Image of a", 4, 2)
            == jax_compat.get_init_text(jc.wp, "Image of a", 4, 2))
    assert compat.get_init_text(pc, "Image of a", 4, 2) == \
        jax_compat.get_init_text(jc, "Image of a", 4, 2)
    mask = np.ones((1, pc.wp.vocab_size), np.float32)
    for holder, jholder in ((pc.wp, jc.wp), (pc, jc)):
        for index in (1, 3):
            np.testing.assert_array_equal(
                compat.update_token_mask(holder, mask, 4, index),
                jax_compat.update_token_mask(jholder, mask, 4, index))


def test_clip_scores_match_reference(tiny_pair, run_trees):
    jc, pc = tiny_pair
    paths = [os.path.join(EXAMPLES, n) for n in sorted(os.listdir(EXAMPLES))]
    caps = ["image of a red circle", "a dog", "the horse at the top ."]
    got = clipscore.clip_scores(pc, paths, caps, batch_size=2)
    want = jax_clipscore.clip_scores(jc, paths, caps, batch_size=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    (best,) = (run_trees / "port" / "results").glob(
        "*/sample_0/best_clipscore.json")
    per_image = clipscore.score_results_file(pc, str(best), EXAMPLES)
    want = jax_clipscore.score_results_file(jc, str(best), EXAMPLES)
    assert sorted(per_image) == sorted(want) == ["dog.jpg", "girl.jpg"]
    for name in want:
        assert abs(per_image[name] - want[name]) < 1e-4


def test_ndiv_and_pos_eval_command_lines_match_reference(run_trees,
                                                         capsys):
    results = run_trees / "port" / "results"
    per_image = {}
    for path in sorted(results.glob("*/sample_*/iter_1.json")):
        for image_id, cap in json.loads(path.read_text()).items():
            per_image.setdefault(image_id, []).append(cap)
    corpus = run_trees / "corpus.json"
    corpus.write_text(json.dumps([{"captions": c}
                                  for c in per_image.values()]))
    stop = run_trees / "stop.txt"
    stop.write_text("a\nof\n")
    (iter_file,) = results.glob("*/sample_1/iter_0.json")
    outs = []
    for div_main, pos_main in ((ndiv.main, pos_eval.main),
                               (jax_ndiv.main, jax_pos_eval.main)):
        div_main([str(corpus), "--stop_words_path", str(stop)])
        pos_main([str(iter_file), "--word_id", "3", "--template",
                  '[["NOUN"], ["ADP"], "DET", ["ADJ", "NOUN"]]'])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "div_1:" in outs[0] and "mean template accuracy:" in outs[0]


def test_word_tokenize_and_the_tagger_decide_nltk_once(monkeypatch):
    texts = ["A dog, running!", "it's a girl's hat.", "", "Don't STOP 3.5"]
    for t in texts:
        assert ndiv.word_tokenize(t) == jax_ndiv.word_tokenize(t)
        words = ndiv.word_tokenize(t)
        assert pos_eval.tag_words(words) == jax_pos_eval.tag_words(words)
    real_import = builtins.__import__

    def no_nltk(name, *args, **kw):
        if name.split(".")[0] == "nltk":
            raise AssertionError(f"imported {name} again")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_nltk)
    for t in texts:
        pos_eval.text_pos_analysis(t)
    assert ndiv._nltk_tokenizer.cache_info().misses == 1
    assert pos_eval._nltk_pos_tag.cache_info().misses == 1


def test_entry_functions_take_pil_images_as_the_reference(tiny_pair):
    """One PIL image through both packages' entry functions: the same
    captions, replicated over the batch."""
    jc, pc = tiny_pair
    img = Image.open(os.path.join(EXAMPLES, "horse.png")).convert("RGB")
    kw = dict(prompt="Image of a", batch_size=2, max_len=4, top_k=8,
              temperature=0.1, max_iter=1, alpha=0.02, beta=2.0,
              generate_order="sequential")
    got = sampler.generate_caption(["h", "h"], pc, img,
                                   port_logging.null_logger(),
                                   rng=np.random.RandomState(3), **kw)
    want = jax_demo.generate_caption(["h", "h"], jc, img,
                                     jax_logging.null_logger(),
                                     rng=np.random.RandomState(3), **kw)
    assert got[0] == want[0]
