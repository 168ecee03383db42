"""The benchmark of ``conzic_torch`` on one NVIDIA H100: one run of one cell.

    python3 -m bench_port.run --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout. Everything is found by name from
``BENCHMARK.json``: the cell's configuration in
``bench_port/configs/<config>.json``, its traffic in
``bench_port/traffic/<traffic>.json``, the limits of its correctness check
in ``bench_port/limits/<cell>.json``, each per-layer metric's reader in
``bench_port/metrics/<metric>.py``, each kernel's counts in
``bench_port/counts/<kernel>.py``, and the proposer's and the matcher's
tower families in ``bench_port/families/<model_type>.py`` by the
``model_type`` of the configuration's ``lm`` and ``match``.

Set-up: the kernels are built (cached under ``build/`` in the checkout),
the vocabularies and both towers' weights are made on the card from the
seed, the captioner is built through the port's constructors, and one
request of the cell's shapes cut to one iteration warms every shape up.
``--trace 0`` then runs a closed loop of one client: each request starts
when the last returned, while ``--seconds`` have not run out, and the
window closes at the last completion. ``--trace 1`` runs one request
untraced and one under ``torch.profiler``, and reports the per-layer
metrics of the traced one. Then the program is freed and the plain
reference judges what was served (``bench_port/check.py``).

The last line of standard output is the result, a JSON object; each
number compared goes to standard error beside its limit, last.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # the process's start, for setup_s

import os  # noqa: E402

# one thread in each OpenMP and BLAS pool, set before torch and numpy load:
# the process's only busy thread is the one that launches the kernels
for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_pool, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level modules that the program and the benchmark must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "conzic_tpu")


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads`` with everything found by its names."""

    def __init__(self, root: Path, name: str):
        bench = load_json(root / "BENCHMARK.json")
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        w = found[0]
        self.root, self.name, self.chips = root, name, w["chips"]
        pkg = root / "bench_port"
        config_file = f"bench_port/configs/{w['config']}.json"
        self.config = load_json(root / config_file)
        self.traffic = load_json(pkg / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(pkg / "limits" / f"{name}.json")
        self.families = families(root, self.config, config_file)

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def load_module(path: Path):
    """The module of one file of the benchmark, found by its path."""
    name = "bench_port_file." + "_".join(path.with_suffix("").parts[-2:])
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def families(root: Path, config: dict, source: str = "the configuration"
             ) -> Dict[str, object]:
    """The modules of the proposer's (``lm``) and the matcher's
    (``match``) tower families, ``bench_port/families/<model_type>.py``
    by each dict's ``model_type``. There is no default: a missing or
    unknown one exits, naming the file looked for."""
    found = {}
    for role in ("lm", "match"):
        name = config[role].get("model_type")
        if name is None:
            raise SystemExit(f"{source}: {role!r} names no model_type; its "
                             "tower family is bench_port/families/"
                             "<model_type>.py")
        path = Path("bench_port") / "families" / f"{name}.py"
        if not (Path(root) / path).is_file():
            raise SystemExit(f"{source}: {role!r} is of model_type "
                             f"{name!r}, and there is no {path}")
        found[role] = load_module(Path(root) / path)
    return found


def metric_reader(root: Path, name: str):
    """``bench_port/metrics/<name>.py``'s ``read``."""
    return load_module(Path(root) / "bench_port" / "metrics"
                       / f"{name}.py").read


def forbidden_modules() -> List[str]:
    """FORBIDDEN top-level names that ``sys.modules`` holds, compared as
    whole names."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        requests: int = 0, controls: Tuple[str, ...] = ()) -> dict:
    """One run of ``cell``; returns the result's fields. ``requests`` runs
    that many requests in place of a window of ``seconds``; for each
    precision of ``controls`` ("fp8") the result's ``control`` also holds
    the check's numbers of the reference in that precision put in the
    program's place."""
    import torch

    from bench_port import check, inputs, system
    from bench_port import trace as tracing
    from bench_port.flops import request_flops

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg, traffic, fams = cell.config, cell.traffic, cell.families
    seeds = inputs.Seeds(seed)
    if on_card:
        from conzic_torch.kernels import build
        build.build_all()
    vocab = {role: f.vocab(cfg) for role, f in fams.items()}
    # the proposer's weights are drawn before the matcher's
    spec = fams["lm"].spec(cfg) + fams["match"].spec(cfg)

    def weights():
        return inputs.make_weights(spec, seeds.weights, dev, cfg["weights"])

    captioner = system.build(cfg, traffic, fams, vocab, weights(), dev)
    driver = system.Driver(captioner, traffic)
    B = traffic["images_per_request"]

    def request(r: int, iterations: int = 0):
        px_seed, sched_seed = seeds.request(r)
        px = fams["match"].pixels(cfg, px_seed, B, dev)
        return driver.request(px, px_seed, sched_seed, iterations)

    request(1 << 30, iterations=1)  # warm-up: every shape, one iteration
    sync()
    setup_s = time.perf_counter() - _T0
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0

    seconds_of = {"setup": setup_s}
    served, failed, metrics, request_s = [], 0, {}, []
    device_info: Dict[str, object] = {}
    breakdown = None
    steps = traffic["samples"] * traffic["iterations"] * traffic[
        "sentence_len"]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_start = t_last = time.perf_counter()
    try:
        if not trace:
            r = 0
            while (r < requests if requests
                   else time.perf_counter() - t_start < seconds):
                served.append(request(r))
                request_s.append(time.perf_counter() - t_last)
                t_last = time.perf_counter()
                r += 1
        else:
            served.append(request(0))
            t_traced = time.perf_counter()
            out, tr = tracing.traced(
                lambda: request(1), steps,
                request_flops(cfg, traffic, fams), sync,
                tracing.counts_modules(cell.root))
            served.append(out)
            t_last = time.perf_counter()
            tr.weights_bytes = system.weights_bytes(captioner)
            seconds_of["traced request and its reduction"] = (
                t_last - t_traced)
    except Exception:  # a failed request: reported, and not correct
        traceback.print_exc()
        failed = 1
    sync()
    seconds_of["window"] = time.perf_counter() - t_start
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    captions = len(served) * B * traffic["samples"]
    if not trace:
        elapsed = t_last - t_start
        values = {
            "caps_per_s": captions / elapsed if elapsed > 0 else 0.0,
            "peak_mem_gib": window_peak / 2 ** 30,
            "setup_s": setup_s,
        }
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    elif not failed:
        for m in cell.per_layer:
            value = metric_reader(cell.root, m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tracing.top_device_ops(tr),
                     "idle_gaps": [[k, v] for k, v in tr.gaps[:10]]}
    attempted = len(served) + failed

    # the program's state goes before the reference runs
    driver = captioner = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    judge = check.Judge(cfg, traffic, fams, vocab, weights(), dev)
    numbers = judge.judge(served, seeds.check_rng())
    seconds_of["check"] = time.perf_counter() - t_check
    control_numbers = {p: judge.control(served, seeds.check_rng(), p)
                       for p in controls}
    print("seconds: " + ", ".join(f"{k} {v:.3f}"
                                  for k, v in seconds_of.items()),
          file=sys.stderr)
    if request_s:
        print("request seconds: " + " ".join(f"{x:.3f}" for x in request_s),
              file=sys.stderr)
    correct = (failed == 0 and attempted > 0
               and check.verdict(numbers, cell.limits))
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics}
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": max(setup_peak, window_peak),
            **device_info, "power": power_limit()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0, **device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a reading that is not finite (a forbidden token) is written as text
    def finite(x: float):
        return x if math.isfinite(x) else str(x)

    if control_numbers:
        result["control"] = {p: {k: finite(v) for k, v in n.items()}
                             for p, n in control_numbers.items()}
    result["readings"] = {k: finite(v) for k, v in numbers.items()}
    result["checked"] = {k: {"value": finite(numbers[k]), "limit": limit}
                         for k, limit in cell.limits.items()}
    return result


def main(argv: Optional[List[str]] = None, root: Path = ROOT,
         device: str = "cuda") -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = Cell(Path(root), args.workload)

    import torch

    # one host thread for the CPU's share of the work: other threads of
    # this process would take cores from the one that launches the kernels
    torch.set_num_threads(1)
    if device == "cuda":
        if not torch.cuda.is_available():
            print("bench_port: CUDA is not available; the benchmark runs "
                  "on the card", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"bench_port: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"bench_port: the run loaded {', '.join(found)}; the port "
              "and the benchmark import none of them", file=sys.stderr)
        return 3
    if device == "cuda":
        print(f"card: {result['device']['power']}", file=sys.stderr)
    for k, v in result["checked"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
