"""pytest settings of the benchmark's own tests (``bench_port/tests/``).

    python -m pytest bench_port/tests -q

The ``card`` marker names a test that runs on an NVIDIA card; it decides
inside the test whether one is present and skips with its reason on a
machine without one. The fixtures write a tiny benchmark tree (a
``BENCHMARK.json`` with one cell, its configuration, traffic and limits,
and copies of the metric and count readers and of the tower families)
into a temporary directory:
the harness finds everything in it by name, as it does in a checkout.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs on an NVIDIA card; skips without one")


TINY_LM = dict(vocab_size=600, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=64)
# the text tower keeps CLIP's vocabulary: the synthetic BPE is made at
# that size
TINY_TEXT = dict(vocab_size=49408, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=128)
TINY_VISION = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, image_size=64, patch_size=16)
# the tiny cell computes in float32, where the program and the reference
# agree to about 1e-7 (test_sound_tiny_fp32_run_agrees_to_rounding)
TINY_LIMITS = dict(image_embed_err=1e-4, lm_gap_mean=1e-4,
                   commit_gap_mean=1e-5, commit_gap_step_median=1e-5,
                   text_cos_err=1e-4, frame_errors=0,
                   text_errors=0)
TINY_TRAFFIC = dict(images_per_request=2, candidate_k=8, sentence_len=4,
                    iterations=2, check_requests=2, check_steps=4)


def write_tiny_tree(root: Path, dtype: str = "float32",
                    limits: dict = None) -> Path:
    """A benchmark tree with the cell ``tiny-cell`` (configuration
    ``tiny``: conzic-b32's file at tiny widths, in ``dtype``; traffic
    ``tiny``: batch32's at tiny sizes) under ``root``."""
    cfg = json.loads((PKG / "configs" / "conzic-b32.json").read_text())
    cfg["name"] = "tiny"
    cfg["lm"].update(TINY_LM)
    cfg["match"]["projection_dim"] = 32
    cfg["match"]["text_config"].update(TINY_TEXT)
    cfg["match"]["vision_config"].update(TINY_VISION)
    cfg["run"]["dtype"] = dtype
    traffic = json.loads((PKG / "traffic" / "batch32.json").read_text())
    traffic.update(TINY_TRAFFIC)
    limits = limits or TINY_LIMITS
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": "tiny-cell", "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m["workloads"] = ["tiny-cell"]
    pkg = root / "bench_port"
    for sub in ("configs", "traffic", "limits"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "tiny-cell.json").write_text(json.dumps(limits))
    for sub in ("metrics", "counts", "families"):
        shutil.copytree(PKG / sub, pkg / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_tree(tmp_path)


@pytest.fixture
def one_thread():
    """torch on one CPU thread, as the repo's tests run it."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
