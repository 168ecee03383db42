"""Each cell on the card for a few seconds, and its control: a sound run
is correct, the reference in fp8 put in the program's place is not.
Skips without an NVIDIA card; on the card:
python -m pytest bench_port/tests -m card."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def need_card(chips: int = 1):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} cards")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    from bench_port import run

    c = run.Cell(ROOT, cell)
    need_card(c.chips)
    result = run.run(c, 2 ** 31 + 101, 3.0, False, "cuda")
    assert result["correct"] is True, result["checked"]
    for m in c.end_to_end:
        assert result["metrics"][m["name"]]["value"] > 0, m["name"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    from bench_port import check, run

    c = run.Cell(ROOT, cell)
    need_card(c.chips)
    result = run.run(c, 2 ** 31 + 202, 0, False, "cuda",
                     requests=c.traffic["check_requests"], controls=("fp8",))
    assert result["correct"] is True, result["checked"]
    fp8 = result["control"]["fp8"]
    assert check.verdict(fp8, c.limits) is False, fp8
