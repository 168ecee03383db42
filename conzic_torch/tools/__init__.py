"""The quality and measurement studies of ``conzic_torch``: counterparts of
the JAX repository's ``tools/`` scripts that drive the engine, under the
same names, command lines and output schemas.

    python -m conzic_torch.tools.validate_pruning --random_models --matrix
    python -m conzic_torch.tools.trained_quality_cells --ladder
    python -m conzic_torch.tools.bench_ladder

Each runs on the CUDA card unless ``--cpu`` asks for the CPU. Each writes
its record under ``records_torch/`` at the root of the checkout, by the
reference's file name, with a ``device`` field: the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them, or ``"cpu"``. A CPU run writes ``<name>.cpu-smoke.json``
beside it instead, which ``conzic_torch.bench`` never reads.
"""

from __future__ import annotations

import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RECORDS_DIR = os.path.join(REPO, "records_torch")
SMOKE_SUFFIX = ".cpu-smoke.json"


def record_path(name: str) -> str:
    """``records_torch/<name>``: where a study's card run writes."""
    return os.path.join(RECORDS_DIR, name)


def tool_device(cpu: bool) -> str:
    """The device a study runs on: the card unless ``--cpu`` was given."""
    return "cpu" if cpu else "cuda"


def divert_cpu_output(out: str, default: str, cpu: bool) -> str:
    """A CPU run writing to the default record goes to its
    ``.cpu-smoke.json`` twin, where the bench never reads."""
    if cpu and out == default:
        out = default + SMOKE_SUFFIX
        print(f"--cpu smoke run: writing to {out}")
    return out


def device_label(device) -> str:
    """``"cpu"``, or the card's name and power limit as nvidia-smi gives
    them."""
    import torch

    if torch.device(device).type == "cpu":
        return "cpu"
    from conzic_torch.kernels.build import card_line

    return card_line()


def write_record(path: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
