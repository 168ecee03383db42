"""The port's operating-point ladder, measured on the card: runs
``python -m conzic_torch.bench`` repeatedly, in turns, under the
full-parity headline's two routes and under each ladder point's
environment, and writes ``records_torch/LADDER.json``.

The reference's ``LADDER.json`` holds rates measured on the TPU; this
record is the port's own. Each row keeps every invocation's ``value``
(captions/s, ``bench``'s timing rule), their median as ``caps_per_s``
and the quartiles. A point's ``gate_cell`` is the head of the quality cell that
``conzic_torch.bench`` resolves against ``records_torch/PRUNING_MATRIX.json``
(``conzic_torch.tools.trained_quality_cells`` measures it), so the
bench's ``quality_bounded`` field names the fastest point under the gate.

Usage:
  python -m conzic_torch.tools.bench_ladder [--runs 5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

from conzic_torch.tools import REPO, device_label, record_path, write_record
from conzic_torch.tools.validate_pruning import cell_key, session_tag

OUT_PATH = record_path("LADDER.json")

# the full-parity headline: bench.py's default route (the reference's
# library attention) and the port's kernel route
HEADLINE = {
    "xla": {},
    "pallas": {"CONZIC_BENCH_ATTN": "pallas"},
}
# the README's flagship (the factorized stage-1 at 6 of 12 layers behind a
# proxy pre-cut to 32, 3 survivors) at its quoted batch, and its hybrid
# tier (the proxy keeps 5; the last iteration scores all k), both on the
# kernel route
POINTS = [
    {"name": "prune3+fact50pc32 B=512 (flagship)",
     "env": {"CONZIC_BENCH_ATTN": "pallas", "CONZIC_BENCH_PRUNE": "3",
             "CONZIC_BENCH_STAGE1": "factorized",
             "CONZIC_BENCH_STAGE1_LAYERS": "6",
             "CONZIC_BENCH_STAGE1_PRECUT": "32",
             "CONZIC_BENCH_BATCH": "512"},
     "gate_cell": cell_key(prune_k=3, stage1="factorized", stage1_pct=50,
                           precut=32),
     "mode": "free"},
    {"name": "prune5 hybrid B=32 (final sweep full-parity)",
     "env": {"CONZIC_BENCH_ATTN": "pallas", "CONZIC_BENCH_PRUNE": "5",
             "CONZIC_BENCH_PRUNE_FINAL_EXACT": "1",
             "CONZIC_BENCH_BATCH": "32"},
     "gate_cell": cell_key(prune_k=5, final_exact=True),
     "mode": "free"},
]


def bench_once(env: dict) -> dict:
    """One ``python -m conzic_torch.bench`` under ``env`` (over the
    caller's environment, other ``CONZIC_BENCH_*`` knobs removed): its
    JSON line; raises when it fails."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("CONZIC_BENCH_")}
    full.update(env)
    p = subprocess.run([sys.executable, "-m", "conzic_torch.bench"],
                       cwd=REPO, env=full, capture_output=True, text=True,
                       timeout=1800)
    sys.stderr.write(p.stderr[-2000:])
    if p.returncode != 0:
        raise RuntimeError(f"bench under {env} exited {p.returncode}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def summarize(values) -> dict:
    """Median and quartiles of a row's values."""
    q1, med, q3 = np.percentile(values, [25, 50, 75])
    return {"caps_per_s": round(float(med), 4),
            "quartiles": [round(float(q1), 4), round(float(q3), 4)],
            "values": list(values), "n": len(values)}


def ladder_doc(values: dict, metrics: dict) -> dict:
    return {
        "_doc": ("The port's operating points, measured by "
                 "conzic_torch.tools.bench_ladder on the card named in "
                 "'device': each row's caps_per_s is the median of 'values', "
                 "one python -m conzic_torch.bench invocation each, rows in "
                 "turns. gate_cell names the records_torch/PRUNING_MATRIX."
                 "json cell head that bounds the point's quality."),
        "device": device_label("cuda"),
        "session": session_tag(),
        "headline": {
            n: {"env": env, "metric": metrics[f"headline {n}"],
                **summarize(values[f"headline {n}"])}
            for n, env in HEADLINE.items()},
        "points": [
            {**pt, "metric": metrics[pt["name"]], "session": session_tag(),
             **summarize(values[pt["name"]])}
            for pt in POINTS],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--runs", type=int, default=5,
                   help="invocations of the bench per row, in turns")
    p.add_argument("--out", default=OUT_PATH)
    args = p.parse_args(argv)

    rows = [(f"headline {n}", env) for n, env in HEADLINE.items()]
    rows += [(pt["name"], pt["env"]) for pt in POINTS]
    values = {name: [] for name, _ in rows}
    metrics = {}
    for r in range(args.runs):
        for name, env in rows:
            line = bench_once(env)
            values[name].append(line["value"])
            metrics[name] = line["metric"]
            print(f"[{r}] {name}: {json.dumps(line)}", flush=True)
        # every round rewrites the record: a later failure keeps the rounds
        doc = ladder_doc(values, metrics)
        write_record(args.out, doc)
    print(json.dumps({n: r["caps_per_s"] for n, r in doc["headline"].items()}))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
