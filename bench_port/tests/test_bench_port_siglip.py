"""SigLIP as the matcher family (``families/siglip.py``): found by the
configuration's ``model_type``, its weights and operations pinned, the
measured configurations' operations unchanged, and the new per-layer
metric read from a traced run of a tiny SigLIP tree at the cell's batch
and k; the tiny tree's run correct in fp32 and each planted fault
caught."""

import json
import math
from pathlib import Path

import pytest

from bench_port import run, trace
from bench_port.conftest import TINY_LIMITS, TINY_LM, write_tiny_tree
from bench_port.flops import request_flops

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
SEED = 2 ** 31 + 5


def load(sub, name):
    return json.loads((PKG / sub / f"{name}.json").read_text())


def write_siglip_tree(root: Path, **traffic) -> Path:
    """The tiny tree with ``tiny``: conzic-so400m's configuration at tiny
    widths (heads of the published 72) in fp32, and ``traffic`` over the
    tiny traffic."""
    write_tiny_tree(root)
    cfg = load("configs", "conzic-so400m")
    cfg["name"] = "tiny"
    cfg["lm"].update(TINY_LM)
    small = dict(hidden_size=144, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=176)
    cfg["match"]["text_config"].update(small, vocab_size=1000,
                                       projection_size=144)
    cfg["match"]["vision_config"].update(small, image_size=56)
    cfg["run"]["dtype"] = "float32"
    pkg = root / "bench_port"
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    path = pkg / "traffic" / "tiny.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **traffic}))
    return root


def test_the_family_is_found_by_model_type():
    cell = run.Cell(ROOT, "so400m-batch8")
    assert Path(cell.families["match"].__file__).name == "siglip.py"
    assert Path(cell.families["lm"].__file__).name == "bert.py"
    assert cell.config["match"]["model_type"] == "siglip"
    assert cell.traffic["images_per_request"] == 8
    assert "match_text_positions_per_step" in [m["name"]
                                               for m in cell.per_layer]


def test_spec_and_request_flops_are_pinned():
    cfg = load("configs", "conzic-so400m")
    fams = run.families(ROOT, cfg)
    n = sum(math.prod(shape) for _, shape, _ in fams["match"].spec(cfg))
    assert n == 877_960_498  # 449,734,896 text, 428,225,600 vision, 2
    both = n + sum(math.prod(shape) for _, shape, _ in fams["lm"].spec(cfg))
    assert both * 4 / 2 ** 30 == 3.6786302775144577  # weights_gib
    assert request_flops(cfg, load("traffic", "batch8"), fams) == (
        8508131333775360.0)
    # 1,600 candidate rows a step, each through 27 x 1152 at 64 positions
    # (53,126,627,328) and the head at the last (2,654,208)
    assert fams["match"].flops(cfg, load("traffic", "batch8"))["step"] == (
        1600 * 53_129_281_536)


@pytest.mark.parametrize("config, want", [
    ("conzic-b32", 1370023579222016.0),
    ("conzic-l14", 3070574836973568.0),
])
def test_request_flops_of_the_clip_cells_are_unchanged(config, want):
    cfg = load("configs", config)
    assert request_flops(cfg, load("traffic", "batch32"),
                         run.families(ROOT, cfg)) == want


def test_positions_per_step_read_the_cells_rows(tmp_path, one_thread):
    root = write_siglip_tree(tmp_path, images_per_request=8, candidate_k=200,
                             sentence_len=2, iterations=1, check_steps=1)
    cell = run.Cell(root, "tiny-cell")
    result = run.run(cell, SEED, 0, True, "cpu")
    assert result["correct"] is True, result["checked"]
    metrics = result["metrics"]
    assert metrics["match_text_positions_per_step"]["value"] == 1600 * 64


def test_no_target_without_the_programs_entry(monkeypatch):
    import importlib.util

    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    mod = run.load_module(PKG / "counts" / "match_text.py")
    assert mod.TARGETS == ()
    assert "match_text" in trace.counts_modules(ROOT)


def test_tiny_siglip_run_is_correct(tmp_path, one_thread):
    cell = run.Cell(write_siglip_tree(tmp_path), "tiny-cell")
    result = run.run(cell, SEED, 0, False, "cpu", requests=2)
    assert result["correct"] is True, result["checked"]
    assert set(cell.limits) == set(TINY_LIMITS)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_tiny_siglip_check_catches_planted_faults(tmp_path, one_thread,
                                                  monkeypatch, fault):
    from bench_port import faults

    cell = run.Cell(write_siglip_tree(tmp_path), "tiny-cell")
    faults.FAULTS[fault](monkeypatch.setattr)
    result = run.run(cell, SEED, 0, False, "cpu", requests=2)
    assert result["correct"] is False
