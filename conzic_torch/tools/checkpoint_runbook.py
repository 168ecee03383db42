"""Checkpoint-day runbook: ONE command -> the quality dossier. The
counterpart of the reference's ``tools/checkpoint_runbook.py``, running
the port's steps in sequence and writing one dossier JSON:

  1. golden-activation parity against HF torch: the reference's
     ``tools/make_goldens.py`` has no counterpart (the port's tests hold it
     against ``conzic_tpu`` directly), so the step is recorded as skipped
     with that reason,
  2. the pruning / hybrid quality matrix
     (``conzic_torch.tools.validate_pruning --matrix``, beside the dossier:
     ``PRUNING_MATRIX_REAL.json``, or ``_SMOKE.json`` in smoke mode),
  2b. the factorized speed tier (automatic depth, held-out cosine and its
     quality deltas),
  3. the int8 tiers' quality (``conzic_torch.tools.validate_quant``),
  4. a demo run over the shipped example image (``conzic_torch.api.demo``),
  5. (``--images``) the SketchyCOCOcaption pipeline
     (``conzic_torch.tools.sketchycoco_bench``),
  6. the headline throughput (``conzic_torch.bench``).

Smoke mode (``--random_models``) drives the same steps on tiny random
towers at tiny sizes, to keep the runbook itself verified.

Usage:
  python -m conzic_torch.tools.checkpoint_runbook \
      --lm_model /ckpts/bert-base-uncased \
      --match_model /ckpts/clip-vit-base-patch32 [--images DIR] [--out F]
  python -m conzic_torch.tools.checkpoint_runbook --random_models --cpu
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from conzic_torch.tools import (
    REPO,
    device_label,
    record_path,
    tool_device,
    write_record,
)

GOLDENS_SKIPPED = (
    "no counterpart in conzic_torch: the reference's tools/make_goldens.py "
    "compares its towers with HF torch; the port's tests hold its towers "
    "against conzic_tpu's on the same weights instead")


def run_step(name, cmd, results, timeout=7200, env=None):
    print(f"=== {name}: {' '.join(cmd)}", flush=True)
    t0 = time.time()
    try:
        p = subprocess.run(
            cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO,
            env=env,
        )
        results[name] = {
            "rc": p.returncode,
            "wall_s": round(time.time() - t0, 1),
            "tail": (p.stdout + p.stderr)[-2000:],
        }
        status = "ok" if p.returncode == 0 else f"FAILED rc={p.returncode}"
        print(f"=== {name}: {status} ({results[name]['wall_s']}s)",
              flush=True)
    except subprocess.TimeoutExpired:
        results[name] = {"rc": None, "error": f"timeout {timeout}s"}
        print(f"=== {name}: TIMEOUT", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lm_model", default="bert-base-uncased")
    p.add_argument("--match_model", default="openai/clip-vit-base-patch32")
    p.add_argument("--random_models", action="store_true",
                   help="smoke mode: random-weight stand-ins, tiny configs")
    p.add_argument("--images", default=None,
                   help="SketchyCOCOcaption image dir (step 5; skipped "
                        "when absent)")
    p.add_argument("--out", default=record_path("DOSSIER.json"))
    p.add_argument("--cpu", action="store_true",
                   help="run every step on the CPU")
    args = p.parse_args(argv)

    if not args.random_models:
        for path in (args.lm_model, args.match_model):
            if not os.path.isdir(path):
                sys.exit(
                    f"checkpoint dir not found: {path!r} — pass local HF "
                    "checkpoint dirs, or --random_models for the smoke run"
                )

    py = sys.executable
    models = ["--lm_model", args.lm_model, "--match_model", args.match_model]
    cpu = ["--cpu"] if args.cpu else []
    smoke = args.random_models
    results = {"mode": "smoke-random" if smoke else "real-checkpoints",
               "device": device_label(tool_device(args.cpu)),
               "steps": {}}
    steps = results["steps"]

    # 1. activation parity against HF torch
    steps["goldens"] = {"skipped": GOLDENS_SKIPPED}

    # 2. the pruning + hybrid quality matrix on these weights; the smoke
    # never overwrites the matrix the bench reads
    matrix_out = os.path.join(
        os.path.dirname(os.path.abspath(args.out)),
        "PRUNING_MATRIX_SMOKE.json" if smoke else "PRUNING_MATRIX_REAL.json")
    cmd = [py, "-m", "conzic_torch.tools.validate_pruning", "--matrix",
           "--out", matrix_out, *cpu]
    # smoke: --prune_k 4 keeps the order/ctl rows pruned at k=16
    cmd += (["--random_models", "tiny", "--iters", "2", "--n_images", "2",
             "--sentence_len", "5", "--k", "16", "--prune_k", "4"]
            if smoke else [*models])
    run_step("pruning_matrix", cmd, steps)

    # 2b. the factorized speed tier: the automatic depth at the calibration
    # floor, its held-out cosine and its full-vs-factorized deltas
    cmd = [py, "-m", "conzic_torch.tools.validate_pruning",
           "--prune_stage1", "factorized", "--topk_mode", "exact", *cpu]
    cmd += (["--random_models", "tiny", "--iters", "2", "--n_images", "2",
             "--sentence_len", "5", "--k", "16", "--prune_k", "4",
             "--stage1_layers", "1", "--stage1_precut", "8"]
            if smoke else
            ["--prune_k", "3", "--stage1_layers", "0",
             "--stage1_precut", "24", *models])
    run_step("factorized_tier", cmd, steps)

    # 3. int8 tier quality (both tiers: CLIP scoring only, and + BERT)
    for tier in ("int8", "int8_all"):
        cmd = [py, "-m", "conzic_torch.tools.validate_quant", "--quant",
               tier, *cpu]
        cmd += (["--random_models", "tiny", "--iters", "2", "--n_images",
                 "2", "--sentence_len", "5", "--k", "16"]
                if smoke else [*models])
        run_step(f"quant_quality_{tier}", cmd, steps)

    # 4. demo captions over the shipped example (human-checkable output)
    demo_cmd = [py, "-m", "conzic_torch.api.demo", "--run_type", "caption",
                "--caption_img_path", "examples/girl.jpg",
                "--samples_num", "1",
                "--device", tool_device(args.cpu)]
    demo_cmd += (["--random_models", "tiny", "--sentence_len", "5",
                  "--candidate_k", "16", "--num_iterations", "2"]
                 if smoke else [*models])
    run_step("demo_examples", demo_cmd, steps)

    # 5. the SketchyCOCOcaption pipeline (needs the dataset)
    if args.images:
        cmd = [py, "-m", "conzic_torch.tools.sketchycoco_bench",
               "--images", args.images, *cpu]
        cmd += (["--random_models", "--iters", "2", "--k", "16",
                 "--sentence_len", "5", "--samples", "1"]
                if smoke else [*models])
        run_step("sketchycoco", cmd, steps)
    else:
        steps["sketchycoco"] = {"skipped": "no --images dir provided"}

    # 6. headline throughput (weight-independent; recorded beside quality)
    env = dict(os.environ)
    if args.cpu:
        env["CONZIC_BENCH_CPU"] = "1"
    if smoke:
        env["CONZIC_BENCH_BATCH"] = "2"
        env["CONZIC_BENCH_ITERS"] = "2"
        env["CONZIC_BENCH_K"] = "16"
        env["CONZIC_BENCH_SMALL_MODELS"] = "1"
    run_step("bench", [py, "-m", "conzic_torch.bench"], steps, env=env)

    write_record(args.out, results)
    # a step failed unless it exited 0 or was skipped; a timeout records
    # rc=None and counts as a failure
    failed = [n for n, r in steps.items()
              if isinstance(r, dict) and "skipped" not in r
              and r.get("rc") != 0]
    status = "ALL STEPS OK" if not failed else "FAILED: " + ", ".join(failed)
    print(f"dossier written to {args.out}; {status}")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
