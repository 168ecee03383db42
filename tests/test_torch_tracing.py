"""The port's tracing (``conzic_torch/runtime/profiling.py``) on the CPU:
the span tree of a tiny generation under ``torch.profiler``, nothing
recorded or counted without a profiler, the weight-cast counter against
a hand count, the counters' lock, the ``CONZIC_TRACE_DIR`` trace of
``api.run``, and a proposer's expert layers (SDAR's): one span a layer a
forward and the routed rows of its held experts."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import (  # noqa: F401
    SDAR_TRAFFIC,
    TRAINED_TINY,
    one_torch_thread,
    sdar_tiny_captioner,
)
from conzic_torch.api import run
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.gibbs import row_chunk_width
from conzic_torch.engine.sampler import Captioner
from conzic_torch.runtime import profiling

EXAMPLES = os.path.join(os.path.dirname(TRAINED_TINY), "examples")
B, K, L, ITERS, ROW_CHUNK = 2, 16, 4, 2, 16


def tiny(param_dtype="float32"):
    cfg = ConzicConfig()
    cfg.clip_row_chunk, cfg.clip_len = ROW_CHUNK, 24
    cfg.param_dtype = param_dtype
    return Captioner.from_random(cfg, device="cpu")


@pytest.fixture(scope="module")
def cap():
    return tiny()


def request(cap, order="shuffle"):
    pixels = torch.rand(B, 64, 64, 3,
                        generator=torch.Generator().manual_seed(0))
    emb = cap.encode_images(pixels)
    return cap.run(emb, prompt="Image of a", max_len=L, top_k=K,
                   temperature=0.1, max_iter=ITERS, alpha=0.02, beta=2.0,
                   order=order, rng=np.random.RandomState(3))


def traced(cap, order="shuffle"):
    """(result, {name: [(start, end)]} of the conzic. spans, counters)."""
    profiling.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = request(cap, order)
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            s = e.start_ns()
            spans.setdefault(e.name()[len(profiling.PREFIX):], []).append(
                (s, s + e.duration_ns()))
    return result, spans, profiling.take_counts()


def inside(outer, spans):
    a, b = outer
    return [x for x in spans if a <= x[0] and x[1] <= b]


def test_span_tree_of_a_generation(cap):
    _, spans, _ = traced(cap)
    n = {name: len(v) for name, v in spans.items()}
    chunks = K // row_chunk_width(B, K, ROW_CHUNK)
    assert chunks == 2
    assert n == {"entry.encode_images": 1, "engine.generate": 1,
                 "engine.prefix_kv": 1, "engine.iteration": ITERS,
                 "engine.step": ITERS * L, "towers.lm": ITERS * L,
                 "engine.candidates": ITERS * L,
                 "towers.text_chunk": ITERS * L * chunks,
                 "engine.commit": ITERS * L, "engine.fetch": 1,
                 "engine.decode": 1}
    (gen,) = spans["engine.generate"]
    assert not inside(gen, spans["entry.encode_images"])
    for name in ("engine.prefix_kv", "engine.iteration", "engine.fetch",
                 "engine.decode"):
        assert len(inside(gen, spans[name])) == n[name]
    for it in spans["engine.iteration"]:
        assert len(inside(it, spans["engine.step"])) == L
    for step in spans["engine.step"]:
        assert len(inside(step, spans["towers.lm"])) == 1
        assert len(inside(step, spans["engine.candidates"])) == 1
        assert len(inside(step, spans["towers.text_chunk"])) == chunks
        assert len(inside(step, spans["engine.commit"])) == 1
        # the step's stages follow one another
        (lm,), (cands,), (commit,) = (
            inside(step, spans[s]) for s in ("towers.lm", "engine.candidates",
                                             "engine.commit"))
        text = inside(step, spans["towers.text_chunk"])
        assert lm[1] <= cands[0] and cands[1] <= min(t[0] for t in text)
        assert max(t[1] for t in text) <= commit[0]


@pytest.mark.parametrize("order", ["span", "parallel"])
def test_span_and_parallel_orders_run_the_lm_beside_the_steps(cap, order):
    _, spans, _ = traced(cap, order)
    assert len(spans["engine.step"]) == ITERS * L
    if order == "parallel":
        assert len(spans["towers.lm"]) == ITERS  # one forward a sweep
    else:
        assert ITERS <= len(spans["towers.lm"]) <= ITERS * L
    for step in spans["engine.step"]:
        assert not inside(step, spans["towers.lm"])
        assert len(inside(step, spans["engine.commit"])) == 1


def test_nothing_is_recorded_or_counted_without_a_profiler(cap,
                                                           monkeypatch):
    _, _, counts = traced(cap)
    assert counts[profiling.WEIGHT_CASTS] > 0
    want, _, _ = traced(cap)

    def refuse(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got = request(cap)
    assert not profiling._on
    assert profiling.take_counts() == {}
    np.testing.assert_array_equal(got.iter_ids, want.iter_ids)
    assert got.gen_texts_list == want.gen_texts_list


def hand_count(cap):
    """Parameters cast from fp32 to bf16 in one tiny request: each
    ``Linear``'s weight and bias, the embedding tables, BERT's tied
    decoder table; the projections have no bias."""
    bert = cap.bert_model.config
    text = cap.clip_model.config.text
    vision = cap.clip_model.config.vision
    lm_step = 3 + bert.num_layers * 6 * 2 + 2 + 1
    text_chunk = 2 + text.num_layers * 6 * 2 + 1
    chunks = K // row_chunk_width(B, K, ROW_CHUNK)
    image = 3 + vision.num_layers * 6 * 2 + 1
    prefix = 2 + text.num_layers * 6 * 2
    return ITERS * L * (lm_step + chunks * text_chunk) + image + prefix


def test_weight_casts_equal_the_hand_count(cap):
    _, _, counts = traced(cap)
    assert counts == {profiling.WEIGHT_CASTS: hand_count(cap)} == {
        profiling.WEIGHT_CASTS: 726}


def test_bf16_parameters_are_never_cast():
    _, spans, counts = traced(tiny("bfloat16"))
    assert len(spans["engine.step"]) == ITERS * L
    assert counts.get(profiling.WEIGHT_CASTS, 0) == 0


def test_counters_lose_no_update_under_threads():
    n_threads, per = 4 * (os.cpu_count() or 1), 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        profiling.take_counts()
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.request_span("engine.generate"):
                threads = [threading.Thread(
                    target=lambda: [profiling.count("test") for _ in
                                    range(per)]) for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.take_counts() == {"test": n_threads * per}
    assert not profiling._on


def test_live_holds_inside_a_request_span_under_a_profiler():
    """``live`` tells a site whose count costs work of its own (the
    LayerNorm kernel's plan) whether to do it; the CPU's LayerNorm is the
    plain version and counts no plan."""
    from conzic_torch.kernels.layer_norm import layer_norm

    profiling.take_counts()
    x = torch.randn(3, 64)
    assert not profiling.live()
    with profile(activities=[ProfilerActivity.CPU]):
        assert not profiling.live()
        with profiling.request_span("engine.generate"):
            assert profiling.live()
            layer_norm(x, torch.ones(64), torch.zeros(64), 1e-5)
        assert not profiling.live()
    assert profiling.take_counts() == {}


@pytest.mark.parametrize("held", [8, 4])
def test_expert_spans_and_rows_of_a_proposer_with_experts(held):
    """Every SDAR layer's router and held experts run in one
    ``towers.lm.experts`` span inside ``towers.lm``; the routed rows of the
    held experts: with all 8 held, every token's top 2 (a hand count),
    with 4, fewer; none counted with no profiler."""
    cap = sdar_tiny_captioner(experts_held=held)
    t = SDAR_TRAFFIC
    lm = cap.bert_model.config
    pixels = torch.rand(2, 64, 64, 3,
                        generator=torch.Generator().manual_seed(0))

    def generate():
        emb = cap.encode_images(pixels)
        return cap.run(emb, prompt=t["prompt"], max_len=t["sentence_len"],
                       top_k=t["candidate_k"], temperature=0.1,
                       max_iter=t["iterations"], alpha=0.02, beta=2.0,
                       order="shuffle", rng=np.random.RandomState(3))

    profiling.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced_ids = generate().iter_ids
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            s = e.start_ns()
            spans.setdefault(e.name()[len(profiling.PREFIX):], []).append(
                (s, s + e.duration_ns()))
    rows = profiling.take_counts()[profiling.LM_EXPERT_ROWS]
    steps = t["iterations"] * t["sentence_len"]
    assert len(spans["towers.lm.experts"]) == steps * lm.num_layers
    for outer in spans["towers.lm"]:
        assert len(inside(outer, spans["towers.lm.experts"])) == (
            lm.num_layers)
    tokens = 2 * (1 + 3 + t["sentence_len"] + 1)  # B rows, framed
    every = steps * lm.num_layers * tokens * lm.num_experts_per_tok
    if held == lm.num_experts:
        assert rows == every
    else:
        assert 0 < rows < every
    np.testing.assert_array_equal(generate().iter_ids, traced_ids)
    assert profiling.take_counts() == {}


def test_run_writes_a_trace_with_the_spans(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("CONZIC_TRACE_DIR", str(trace_dir))
    monkeypatch.chdir(tmp_path)
    run.main(["--random_models", "tiny", "--device", "cpu",
              "--sentence_len", "3", "--candidate_k", "8",
              "--num_iterations", "1", "--samples_num", "1",
              "--batch_size", "2", "--caption_img_path", EXAMPLES])
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"conzic.engine.step", "conzic.engine.generate",
            "conzic.entry.encode_images", "conzic.entry.preprocess"} <= names
    assert int(doc["conzic." + profiling.WEIGHT_CASTS]) > 0
    assert not profiling._on
