"""Whole runs of the harness on the CPU at tiny widths: discovery by
name, the result line's schema, the refusal without a card, and the
correctness check catching a broken timed path."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import faults, run, trace
from bench_port.conftest import write_tiny_tree

ROOT = Path(__file__).resolve().parents[2]


def run_line(root, *extra, trace_on=0, capsys=None):
    argv = ["--workload", "tiny-cell", "--seed", str(2 ** 31 + 11),
            "--seconds", "0.5", "--trace", str(trace_on), *extra]
    assert run.main(argv, root=root, device="cpu") == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_files_are_found_by_name(tmp_path):
    root = write_tiny_tree(tmp_path)
    (root / "bench_port" / "metrics" / "new_metric.py").write_text(
        "def read(trace):\n    return 42.0\n")
    (root / "bench_port" / "counts" / "new_kernel.py").write_text(
        "TARGETS = ()\nKERNEL_NAMES = ('new_kernel',)\n")
    cell = run.Cell(root, "tiny-cell")
    assert cell.config["name"] == "tiny"
    assert cell.traffic["images_per_request"] == 2
    assert set(cell.limits) >= {"commit_gap_mean", "text_errors"}
    assert run.metric_reader(root, "new_metric")(None) == 42.0
    assert "new_kernel" in trace.counts_modules(root)
    with pytest.raises(SystemExit):
        run.Cell(root, "no-such-cell")


def test_result_line_schema(tiny_root, one_thread, capsys):
    line, err = run_line(tiny_root, capsys=capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"caps_per_s", "peak_mem_gib", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for k, v in line["checked"].items():
        assert set(v) == {"value", "limit"}
    # each number beside its limit, last on standard error
    tail = err.strip().splitlines()[-len(line["checked"]):]
    assert [t.split(":")[0] for t in tail] == [
        f"check {k}" for k in line["checked"]]


def test_traced_run_schema(tiny_root, one_thread, capsys):
    line, _ = run_line(tiny_root, trace_on=1, capsys=capsys)
    assert line["correct"] is True and line["attempted"] == 2
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    assert line["metrics"]["weights_gib"]["value"] > 0


def test_no_card_no_result(tiny_root):
    # the command as the driver runs it, in a checkout of the tiny tree
    # on a machine without CUDA: an exit code other than 0, no result
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", "tiny-cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


# --- the timed path broken underneath: correct has to come out false -----

@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_timed_path_is_not_correct(fault, tiny_root, one_thread,
                                          monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    cell = run.Cell(tiny_root, "tiny-cell")
    result = run.run(cell, 2 ** 31 + 5, 0, False, "cpu", requests=2)
    assert result["correct"] is False, result["checked"]


def test_sound_tiny_fp32_run_agrees_to_rounding(tiny_root, one_thread):
    cell = run.Cell(tiny_root, "tiny-cell")
    result = run.run(cell, 2 ** 31 + 5, 0, False, "cpu", requests=2)
    got = result["readings"]
    assert result["correct"] is True
    assert got["image_embed_err"] < 1e-5 and got["text_cos_err"] < 1e-5
    assert got["commit_gap_mean"] < 1e-6 and got["lm_gap_mean"] < 1e-5
    assert got["frame_errors"] == got["text_errors"] == 0


def test_control_tool_reads_sound_runs_and_controls(tmp_path, one_thread,
                                                    capsys):
    from bench_port import control

    root = write_tiny_tree(tmp_path)
    assert control.main(["--workload", "tiny-cell", "--seeds", "3",
                         "--control-seeds", "3", "--faults", "half_batch",
                         "--fault-seeds", "2"], root=root,
                        device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    summary = lines[-1]
    kinds = [x["kind"] for x in lines[:-1]]
    assert kinds.count("sound") == kinds.count("reference_fp8") == 3
    assert kinds.count("half_batch") == 2
    assert all(x["correct"] for x in lines if x.get("kind") == "sound")
    assert not any(x["correct"] for x in lines
                   if x.get("kind") == "half_batch")
    # the fp8 reference in the program's place reads many times wider
    # than the program as configured does
    for k in ("image_embed_err", "lm_gap_mean", "commit_gap_mean",
              "commit_gap_step_median"):
        assert (summary["reference_fp8_min"][k]
                >= 3 * summary["sound_max"][k]), k
    assert np.isfinite(summary["sound_max"]["commit_gap_mean"])


def test_commit_gap_step_median_reads_past_one_tipped_step():
    # ten steps of 32 commits: nine that commit the reference's best or
    # near it, and one where a near-tie tipped for the whole batch
    from bench_port.check import Tally

    tally = Tally()
    steps = [np.full(32, 1e-4)] * 9 + [np.full(32, 0.02)]
    for gaps in steps:
        tally.add("commit", gaps)
        tally.add("commit_step", [np.mean(gaps)])
    got = tally.readings()
    assert got["commit_gap_mean"] == pytest.approx(0.1 * 0.02 + 0.9 * 1e-4)
    assert got["commit_gap_step_median"] == pytest.approx(1e-4)
    # a gap that is not finite in most steps (a forbidden token) stays so
    tally.add("commit_step", [np.inf] * 12)
    assert tally.readings()["commit_gap_step_median"] == np.inf


def test_weights_bytes_counts_each_storage_once():
    from bench_port import system

    class Towers:
        def __init__(self):
            self.a, self.b = torch.nn.Linear(4, 4), torch.nn.Linear(4, 4)
            self.b.weight = self.a.weight  # tied, as BERT's decoder is
            self.b.register_buffer("ids", torch.zeros(3, dtype=torch.int64))
            self.cfg = {"not": "a module"}

    # a.weight 64, a.bias 16, b.bias 16, ids 24 bytes
    assert system.weights_bytes(Towers()) == 64 + 16 + 16 + 24
