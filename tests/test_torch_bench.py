"""``conzic_torch.bench`` against ``bench.py``: the quality gate, the lookup
of quality cells, the best quality-bounded point and the metric label give
the same warnings, cells, labels, sample sizes, borrow flags and points on
the same synthetic matrices and ladders (those of
``tests/test_bench_gate.py``), for the same effective settings; the
command's refusals and its JSON line.

Both gates read one temporary directory: ``bench.py`` through its
``__file__``, the port through ``RECORDS_DIR``. The port's messages name
its own record and tools; the comparison maps those names back. Last, the
checkpoint runbook's smoke, whose last step is the bench.
"""

import hashlib
import importlib
import json
import os
import subprocess
import sys

import pytest

import conzic_torch.bench as port_bench
from conzic_torch.tools import checkpoint_runbook as runbook
from _torch_port import one_torch_thread  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the port's names in its messages -> bench.py's
PORT_NAMES = (
    ("records_torch/PRUNING_MATRIX.json", "PRUNING_MATRIX.json"),
    ("python -m conzic_torch.tools.validate_pruning",
     "tools/validate_pruning.py"),
    ("conzic_torch.tools.approx_quality_cells",
     "tools/approx_quality_cells.py"),
)
KNOBS = ("PRUNE", "TOPK_MODE", "TOPK_RECALL", "PRUNE_FINAL_EXACT", "QUANT",
         "STAGE1", "STAGE1_LAYERS", "STAGE1_PRECUT", "STAGE1_PRECUT_MODE",
         "STAGE1_PRECUT_LAYERS", "STAGE1_CTL", "CTL", "CLIP_LEN", "BATCH",
         "MASK_IMPL", "CLIP_WINDOW")
DEFAULTS = dict(PRUNE=None, TOPK_MODE="exact", TOPK_RECALL=0.95,
                PRUNE_FINAL_EXACT=False, QUANT="none", STAGE1="proxy",
                STAGE1_LAYERS=2, STAGE1_PRECUT=0, STAGE1_PRECUT_MODE="proxy",
                STAGE1_PRECUT_LAYERS=1, STAGE1_CTL="auto", CTL=None,
                CLIP_LEN=24, BATCH=32, MASK_IMPL="gather", CLIP_WINDOW=0)

# the synthetic matrices of tests/test_bench_gate.py
_BASE_CELLS = {
    "sequential/free/prune5": {
        "caption_exact": 0.5, "token_agreement": 0.7,
        "best_cosine_delta": 0.004, "speedup": 10.0},
    "sequential/free/prune5+final_exact": {"best_cosine_delta": 0.0005},
}
MATRICES = {
    "base": {"weights": "synthetic", "cells": _BASE_CELLS},
    "larger sample": {"weights": "synthetic", "cells": {
        "sequential/free/prune5": {"best_cosine_delta": 0.004},
        "sequential/free/prune5@n16": {"best_cosine_delta": 0.02}}},
    "long context": {"weights": "synthetic", "cells": {
        "sequential/free/prune5": {"best_cosine_delta": 0.004},
        "sequential/free/prune5@n8@len77": {"best_cosine_delta": 0.02},
        "sequential/free/prune7@n16@len77": {"best_cosine_delta": 0.001}}},
    "anchored": {"weights": "synthetic", "cells": {
        "sequential/pos/prune5": {"best_cosine_delta": 0.03},
        "shuffle/free/prune5": {"best_cosine_delta": 0.03},
        "sequential/pos/prune5@n16": {"best_cosine_delta": 0.03}}},
    "quant and factorized": {"weights": "synthetic", "cells": {
        "sequential/free/prune5": {"best_cosine_delta": 0.02},
        "sequential/free/prune5+int8": {"best_cosine_delta": 0.02},
        "sequential/free/prune5+fact50": {"best_cosine_delta": 0.002},
        "sequential/free/prune5+fact50pc24": {"best_cosine_delta": 0.003},
        "sequential/free/prune3+fact50pc24t17": {
            "best_cosine_delta": 0.03}}},
    "ctl": {"weights": "synthetic", "cells": {
        "sequential/free/prune5": {"best_cosine_delta": 0.004},
        "sequential/pos/prune5": {"best_cosine_delta": 0.9},
        "sequential/pos/prune5+ctlrank": {"best_cosine_delta": 0.02}}},
    "trained": {"weights": "random-full", "cells": {
        "sequential/free/prune5": {"best_cosine_delta": 0.004},
        "sequential/free/prune3": {"best_cosine_delta": 0.02}},
        "trained": {"weights": "trained-tiny", "cells": {
            "sequential/free/prune5@n32": {
                "best_cosine_delta": 0.003, "checkpoint": "trained_tiny12"},
            "sequential/free/prune5+final_exact@n32": {
                "best_cosine_delta": -0.005,
                "attr_recall_full": 0.84, "attr_recall_pruned": 0.55},
            "sequential/free/prune3@n32": {"best_cosine_delta": 0.02}}}},
}
# operating points: (knob overrides, EFFECTIVE)
POINTS = [
    (dict(PRUNE=5), {}),
    (dict(PRUNE=3), {}),
    (dict(PRUNE=7), {}),
    (dict(PRUNE=5, PRUNE_FINAL_EXACT=True), {}),
    (dict(PRUNE=5, CLIP_LEN=77), {}),
    (dict(PRUNE=7, CLIP_LEN=77), {}),
    (dict(PRUNE=5, QUANT="int8"), {}),
    (dict(PRUNE=5, QUANT="int8"), {"quant": "none"}),
    (dict(PRUNE=5, STAGE1="factorized"), {"stage1_pct": 50}),
    (dict(PRUNE=5, STAGE1="factorized"), {"stage1_pct": 25}),
    (dict(PRUNE=5, STAGE1="factorized", STAGE1_PRECUT=24),
     {"stage1_pct": 50}),
    (dict(PRUNE=3, STAGE1="factorized", STAGE1_PRECUT=24,
          STAGE1_PRECUT_MODE="tower"),
     {"stage1_pct": 50, "precut_tower_pct": 17}),
    (dict(PRUNE=5, STAGE1="factorized", STAGE1_LAYERS=6), {}),
    (dict(PRUNE=5, CTL="pos"), {}),
    (dict(PRUNE=5, CTL="sentiment"), {}),
    (dict(PRUNE=5, CTL="pos", STAGE1_CTL="off"), {}),
]
LADDERS = {
    "under and over": {"points": [
        {"name": "fast-but-over", "caps_per_s": 95.0,
         "gate_cell": "sequential/free/prune3", "session": "s"},
        {"name": "slow-under", "caps_per_s": 52.0,
         "gate_cell": "sequential/free/prune5", "session": "s"},
        {"name": "hybrid", "caps_per_s": 10.0,
         "gate_cell": "sequential/free/prune5+final_exact", "session": "s"},
    ]},
    "ctl and superseded": {"points": [
        {"name": "ctl-fast", "caps_per_s": 90.0, "mode": "pos",
         "gate_cell": "sequential/pos/prune5", "session": "s"},
        {"name": "old-program", "caps_per_s": 85.0, "mode": "free",
         "superseded": "replaced", "gate_cell": "sequential/free/prune5"},
        {"name": "free-over", "caps_per_s": 50.0, "mode": "free",
         "gate_cell": "sequential/free/prune3", "session": "s"},
    ]},
}


@pytest.fixture()
def benches(tmp_path, monkeypatch):
    """(bench.py, conzic_torch.bench), both reading ``tmp_path``, every
    knob at its default, EFFECTIVE empty; restored afterwards."""
    ref = importlib.import_module("bench")
    monkeypatch.setattr(ref, "__file__", str(tmp_path / "bench.py"))
    monkeypatch.setattr(port_bench, "RECORDS_DIR", str(tmp_path))
    for mod in (ref, port_bench):
        for name in KNOBS:
            monkeypatch.setattr(mod, name, DEFAULTS[name])
        monkeypatch.setattr(mod, "EFFECTIVE", {})
    return ref, port_bench


def set_point(mods, knobs, effective):
    for mod in mods:
        for name, val in {**DEFAULTS, **knobs}.items():
            setattr(mod, name, val)
        mod.EFFECTIVE.clear()
        mod.EFFECTIVE.update(effective)


def write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)


def port_stderr(text: str) -> str:
    for port, ref in PORT_NAMES:
        text = text.replace(port, ref)
    return text


@pytest.mark.parametrize("matrix", [None, *MATRICES])
def test_gate_warns_as_bench_py(benches, tmp_path, capsys, matrix):
    """Every operating point against every matrix (and against none): the
    same stderr, name for name."""
    if matrix is not None:
        write(tmp_path / "PRUNING_MATRIX.json", MATRICES[matrix])
    ref, port = benches
    said = 0
    for knobs, effective in POINTS:
        set_point((ref, port), knobs, effective)
        ref.check_prune_quality()
        want = capsys.readouterr().err
        port.check_prune_quality()
        got = port_stderr(capsys.readouterr().err)
        assert got == want, (knobs, effective)
        said += bool(want)
    assert said >= len(POINTS) // 3


@pytest.mark.parametrize("clip_len", [24, 77])
def test_lookup_quality_cell_as_bench_py(benches, clip_len):
    ref, port = benches
    heads = {k.split("@")[0] for m in MATRICES.values()
             for src in (m["cells"], m.get("trained", {}).get("cells", {}))
             for k in src} | {"sequential/free/prune9"}
    for matrix in MATRICES.values():
        for head in sorted(heads):
            assert (port.lookup_quality_cell(matrix, head, clip_len)
                    == ref.lookup_quality_cell(matrix, head, clip_len))


@pytest.mark.parametrize("ladder", LADDERS)
def test_best_quality_bounded_point_as_bench_py(benches, tmp_path, ladder):
    ref, port = benches
    assert port.best_quality_bounded_point() is None  # no records
    write(tmp_path / "LADDER.json", LADDERS[ladder])
    assert port.best_quality_bounded_point() is None  # no matrix yet
    found = []
    for matrix in MATRICES.values():
        write(tmp_path / "PRUNING_MATRIX.json", matrix)
        want = ref.best_quality_bounded_point()
        assert port.best_quality_bounded_point() == want
        found.append(want)
    assert any(found)


def _bench_py_label(ref, monkeypatch, capsys, knobs, effective) -> dict:
    """bench.py's JSON line for a point, its measurement replaced by a
    constant that records ``effective`` as its build would."""
    def measured():
        ref.EFFECTIVE.update(effective)
        return 1.0

    monkeypatch.setattr(ref, "bench_ours", measured)
    monkeypatch.setenv("CONZIC_BENCH_SKIP_TORCH", "1")
    monkeypatch.setattr(ref, "BASELINE_CACHE",
                        os.path.join(REPO, "BASELINE_MEASURED.json"))
    monkeypatch.setattr(ref, "INIT_TIMEOUT_S", 0)
    ref.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


LABEL_POINTS = [
    ({}, {"quant": "none"}),
    (dict(CTL="sentiment"), {"quant": "none"}),
    (dict(CLIP_LEN=77, MASK_IMPL="compare", CLIP_WINDOW=48),
     {"quant": "none"}),
    (dict(PRUNE=5, PRUNE_FINAL_EXACT=True), {"quant": "none"}),
    (dict(PRUNE=3, STAGE1="factorized", STAGE1_LAYERS=6, STAGE1_PRECUT=32),
     {"quant": "none", "stage1_pct": 50, "precut_tower_pct": 0}),
    (dict(PRUNE=3, STAGE1="factorized", STAGE1_PRECUT=24,
          STAGE1_PRECUT_MODE="tower"),
     {"quant": "none", "stage1_pct": 50, "precut_tower_pct": 17}),
    (dict(PRUNE=3, CTL="pos", QUANT="int8_all"), {"quant": "int8_all"}),
    (dict(QUANT="int8"), {"quant": "none"}),  # the CPU drops it
]


@pytest.mark.parametrize("knobs,effective", LABEL_POINTS)
def test_label_and_keys_as_bench_py(benches, monkeypatch, capsys, knobs,
                                    effective):
    ref, port = benches
    set_point((ref, port), knobs, {})
    want = _bench_py_label(ref, monkeypatch, capsys, knobs, effective)
    port.EFFECTIVE.update(effective)
    assert port.metric_label() == want["metric"]
    basis = json.load(open(os.path.join(REPO, "BASELINE_MEASURED.json")))
    assert port.describe_baseline_basis(
        basis.get("basis"), 1.0) == want["vs_baseline_basis"]


def test_approx_is_labelled_and_gated_as_the_exact_point(
        benches, tmp_path, monkeypatch, capsys):
    """CONZIC_BENCH_TOPK_MODE=approx runs the exact top-k in the port: the
    label and the gate are bench.py's for topk_mode=exact."""
    ref, port = benches
    write(tmp_path / "PRUNING_MATRIX.json", MATRICES["base"])
    set_point((ref, port), dict(PRUNE=5), {})
    want = _bench_py_label(ref, monkeypatch, capsys, {}, {"quant": "none"})
    ref.check_prune_quality()
    want_err = capsys.readouterr().err
    set_point((port,), dict(PRUNE=5, TOPK_MODE="approx", TOPK_RECALL=0.9),
              {"quant": "none"})
    assert port.metric_label() == want["metric"]
    assert port.gate_head() == "sequential/free/prune5"
    port.check_prune_quality()
    assert port_stderr(capsys.readouterr().err) == want_err


def _run_bench(env_extra: dict) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CONZIC_BENCH_")}
    env.update(OMP_NUM_THREADS="1", **env_extra)
    return subprocess.run([sys.executable, "-m", "conzic_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("name,val", [
    ("CONZIC_BENCH_STAGE1", "factorised"),
    ("CONZIC_BENCH_CTL", "sentimnet"),
    ("CONZIC_BENCH_TOPK_MODE", "aprox"),
    ("CONZIC_BENCH_QUANT", "int4"),
    ("CONZIC_BENCH_ATTN", "palas"),
])
def test_typo_exits_with_bench_py_message(name, val):
    r = _run_bench({name: val, "CONZIC_BENCH_CPU": "1"})
    assert r.returncode != 0 and r.stdout == ""
    ref = subprocess.run([sys.executable, "-c", "import bench"], cwd=REPO,
                         env={**os.environ, name: val}, capture_output=True,
                         text=True, timeout=120)
    assert ref.returncode != 0
    assert r.stderr.strip().splitlines()[-1] == \
        ref.stderr.strip().splitlines()[-1]


def test_no_card_exits_without_a_json_line():
    """Without CUDA and without CONZIC_BENCH_CPU=1 there is no CPU
    fallback: a non-zero exit and nothing on stdout."""
    import torch

    assert not torch.cuda.is_available()
    r = _run_bench({})
    assert r.returncode != 0
    assert r.stdout == ""
    assert "CUDA is not available" in r.stderr


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


TINY = {"CONZIC_BENCH_CPU": "1", "CONZIC_BENCH_SMALL_MODELS": "1",
        "CONZIC_BENCH_BATCH": "2", "CONZIC_BENCH_K": "8",
        "CONZIC_BENCH_ITERS": "1", "CONZIC_BENCH_SENTENCE_LEN": "3"}


def test_cpu_tiny_run_prints_bench_py_keys():
    """The command at a tiny shape on the CPU: one JSON line with
    bench.py's keys, the run wall times on stderr, the committed baseline
    file read and left as it was."""
    baseline = os.path.join(REPO, "BASELINE_MEASURED.json")
    before = _digest(baseline)
    r = _run_bench(TINY)
    assert r.returncode == 0, r.stderr
    (line,) = r.stdout.strip().splitlines()
    doc = json.loads(line)
    assert set(doc) == {"metric", "value", "unit", "vs_baseline",
                        "vs_baseline_basis", "quality_bounded"}
    assert doc["metric"] == "captions/sec/chip len=3 iters=1 k=8 B=2"
    assert doc["value"] > 0 and doc["vs_baseline"] > 0
    assert "run wall s: [" in r.stderr
    assert _digest(baseline) == before


def test_run_without_baseline_writes_none(tmp_path, monkeypatch, capsys):
    """With the baseline file absent, vs_baseline is null and no baseline
    file is written (bench.py would measure and write one); without
    records, quality_bounded is null."""
    for name, val in dict(BATCH=2, K=8, ITERS=1, SENTENCE_LEN=3,
                          DEVICE="cpu").items():
        monkeypatch.setattr(port_bench, name, val)
    monkeypatch.setattr(port_bench, "SMALL_MODELS", True)
    monkeypatch.setattr(port_bench, "EFFECTIVE", {})
    cache = tmp_path / "BASELINE_MEASURED.json"
    monkeypatch.setattr(port_bench, "BASELINE_CACHE", str(cache))
    monkeypatch.setattr(port_bench, "RECORDS_DIR", str(tmp_path / "records"))
    port_bench.main()
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["vs_baseline"] is None and doc["vs_baseline_basis"] is None
    assert doc["quality_bounded"] is None
    assert not cache.exists() and not os.listdir(tmp_path)


def test_checkpoint_runbook_smoke(tmp_path):
    """The runbook's smoke on the CPU: every step runs (the goldens step
    recorded as skipped, with its reason) and the dossier has the
    reference's steps."""
    out = tmp_path / "DOSSIER.json"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "conzic_torch.tools.checkpoint_runbook",
         "--random_models", "--cpu", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with open(out) as f:
        doc = json.load(f)
    # tools/checkpoint_runbook.py:88-185
    assert set(doc) == {"mode", "steps", "device"}
    assert doc["mode"] == "smoke-random" and doc["device"] == "cpu"
    assert list(doc["steps"]) == [
        "goldens", "pruning_matrix", "factorized_tier", "quant_quality_int8",
        "quant_quality_int8_all", "demo_examples", "sketchycoco", "bench"]
    assert doc["steps"]["goldens"] == {"skipped": runbook.GOLDENS_SKIPPED}
    assert (tmp_path / "PRUNING_MATRIX_SMOKE.json").exists()
