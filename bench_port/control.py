"""The readings the limits of a cell's correctness check are set from.

    python3 -m bench_port.control --workload CELL --seeds 12 \\
        --control-seeds 3 [--faults half_batch,token_altered] \\
        [--fault-seeds 3]

In one process, at the cell's own sizes and load: the program as the
configuration states it on ``--seeds`` seeds, and the control, the step
below the configuration's bf16, on ``--control-seeds`` of them:
``reference_fp8``, the plain reference with every matrix product's
operands in fp8 put in the program's place, judged on the same served
states. Each fault of ``--faults`` (``bench_port/faults.py``) is planted
in the program on ``--fault-seeds`` seeds, and its run judged as a sound
one is. Each seed runs the traffic's ``check_requests`` requests and is
judged as a run judges its window. One JSON line a reading; the last line
sums them up: the sound runs' largest reading of each number and the
smallest of the control and of each fault. The same lines go to
``chiprun_out/control_<cell>.json`` when that directory exists.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from bench_port import faults, run


def main(argv=None, root: Path = run.ROOT, device: str = "cuda") -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--faults", default="",
                        help="faults to plant, of " + ", ".join(faults.FAULTS))
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=2 ** 31 + 7)
    args = parser.parse_args(argv)
    cell = run.Cell(Path(root), args.workload)
    n = cell.traffic["check_requests"]
    lines = []

    def say(line: dict) -> None:
        lines.append(line)
        print(json.dumps(line), flush=True)

    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        r = run.run(cell, seed, 0, False, device, requests=n,
                    controls=("fp8",) if i < args.control_seeds else ())
        say({"kind": "sound", "seed": seed, "correct": r["correct"],
             "numbers": r["readings"]})
        if "control" in r:
            say({"kind": "reference_fp8", "seed": seed,
                 "numbers": r["control"]["fp8"]})
    kinds = ["sound", "reference_fp8"] if args.control_seeds else ["sound"]
    for name in filter(None, args.faults.split(",")):
        for seed in seeds[:args.fault_seeds]:
            with faults.planted(name):
                r = run.run(cell, seed, 0, False, device, requests=n)
            say({"kind": name, "seed": seed, "correct": r["correct"],
                 "numbers": r["readings"]})
        kinds.append(name)

    def widest(kind, pick):
        got = [x["numbers"] for x in lines if x["kind"] == kind]
        return {k: pick(float(x[k]) for x in got) for k in got[0]}

    summary = {"workload": cell.name, "sound_max": widest("sound", max)}
    for kind in kinds[1:]:
        summary[f"{kind}_min"] = widest(kind, min)
    say(summary)
    out = Path(root) / "chiprun_out"
    if out.is_dir():
        with open(out / f"control_{cell.name}.json", "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
