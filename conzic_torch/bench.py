"""Headline benchmark of ``conzic_torch``: captions/sec on one card at
sentence_len=10, 15 Gibbs iterations, k=200, B=32 (the reference's
``bench.py`` configuration and contract).

    python -m conzic_torch.bench

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"vs_baseline_basis", "quality_bounded"}, the keys of ``bench.py``; the
wall time of each timed run goes to stderr on an earlier line.

Full-width random towers from seed 0 over the synthetic 30,522-token
WordPiece vocabulary and the 49,408-token CLIP text vocabulary (weight
values do not affect throughput), or the tiny test towers under
``CONZIC_BENCH_SMALL_MODELS=1`` (a smoke of the harness, not a headline).

The same ``CONZIC_BENCH_*`` knobs and defaults as ``bench.py``, so one
environment selects one configuration in both headlines; the default
``CONZIC_BENCH_ATTN=xla`` is the reference's library route and
``pallas`` the port's kernel route. Knobs the port has no meaning for:
``CONZIC_BENCH_XLA_OPTIONS`` is accepted and ignored (as
``--compiler_options``); ``CONZIC_BENCH_TOPK_MODE=approx`` runs the exact
top-k (the reference's ``approx_max_k`` is exact off the TPU), so the
label and the quality gate name the exact operating point.

It runs on the CUDA card and exits non-zero without one, printing no JSON
line; ``CONZIC_BENCH_CPU=1`` asks for the CPU, where the ``quant`` and
``param_dtype`` requests are dropped as the reference drops them off the
TPU. ``vs_baseline`` divides by the committed ``BASELINE_MEASURED.json``
(the reference's loop on torch CPU), read only: the port measures no
baseline and writes no baseline file. The pruned-tier quality gate and
``quality_bounded`` read the port's own records under ``records_torch/``
(``python -m conzic_torch.tools.trained_quality_cells``,
``conzic_torch.tools.validate_pruning``, ``conzic_torch.tools.bench_ladder``).
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np

from conzic_torch.tools import REPO, RECORDS_DIR

SENTENCE_LEN = int(os.environ.get("CONZIC_BENCH_SENTENCE_LEN", "10"))
ITERS = int(os.environ.get("CONZIC_BENCH_ITERS", "15"))
K = int(os.environ.get("CONZIC_BENCH_K", "200"))
BATCH = int(os.environ.get("CONZIC_BENCH_BATCH", "32"))
PRUNE = int(os.environ.get("CONZIC_BENCH_PRUNE", "0")) or None
PRUNE_FINAL_EXACT = os.environ.get("CONZIC_BENCH_PRUNE_FINAL_EXACT") == "1"
CLIP_LEN = int(os.environ.get("CONZIC_BENCH_CLIP_LEN", "24"))
ATTN = os.environ.get("CONZIC_BENCH_ATTN", "xla")
PARAM_DTYPE = os.environ.get("CONZIC_BENCH_PARAM_DTYPE", "bfloat16")
KV_CHUNK = int(os.environ.get("CONZIC_BENCH_KV_CHUNK", "16"))
ROW_CHUNK = int(os.environ.get("CONZIC_BENCH_ROW_CHUNK", "800"))
TOKEN_BUDGET = int(os.environ.get("CONZIC_BENCH_TOKEN_BUDGET", "16000"))
PAD_TO = int(os.environ.get("CONZIC_BENCH_PAD_TO", "-1"))  # -1 = auto
CLIP_WINDOW = int(os.environ.get("CONZIC_BENCH_CLIP_WINDOW", "0"))
TOPK_CHUNK = int(os.environ.get("CONZIC_BENCH_TOPK_CHUNK", "2048"))
TOPK_MODE = os.environ.get("CONZIC_BENCH_TOPK_MODE", "exact")
TOPK_RECALL = float(os.environ.get("CONZIC_BENCH_TOPK_RECALL", "0.95"))
MASK_IMPL = os.environ.get("CONZIC_BENCH_MASK_IMPL", "gather")
QUANT = os.environ.get("CONZIC_BENCH_QUANT", "none")
STAGE1 = os.environ.get("CONZIC_BENCH_STAGE1", "proxy")
STAGE1_LAYERS = int(os.environ.get("CONZIC_BENCH_STAGE1_LAYERS", "2"))
STAGE1_PRECUT = int(os.environ.get("CONZIC_BENCH_STAGE1_PRECUT", "0"))
STAGE1_PRECUT_MODE = os.environ.get("CONZIC_BENCH_STAGE1_PRECUT_MODE",
                                    "proxy")
STAGE1_PRECUT_LAYERS = int(
    os.environ.get("CONZIC_BENCH_STAGE1_PRECUT_LAYERS", "1"))
STAGE1_CTL = os.environ.get("CONZIC_BENCH_STAGE1_CTL", "auto")
CTL = os.environ.get("CONZIC_BENCH_CTL", "") or None
XLA_OPTIONS = os.environ.get("CONZIC_BENCH_XLA_OPTIONS")  # ignored
SMALL_MODELS = os.environ.get("CONZIC_BENCH_SMALL_MODELS") == "1"
DEVICE = "cpu" if os.environ.get("CONZIC_BENCH_CPU") == "1" else "cuda"

BASELINE_CACHE = os.path.join(REPO, "BASELINE_MEASURED.json")
# the effective operating point recorded by build_captioner and bench_ours,
# which the metric label and the quality gate describe
EFFECTIVE: dict = {}
PROMPT = "Image of a"


def check_knobs() -> None:
    """Refuse a typo'd knob value before anything is built, with
    ``bench.py``'s message: every consumer compares with a literal, so a
    typo would bench another tier under the requested label."""
    for name, val, allowed in (
        ("CONZIC_BENCH_TOPK_MODE", TOPK_MODE, ("exact", "approx")),
        ("CONZIC_BENCH_MASK_IMPL", MASK_IMPL, ("gather", "compare")),
        ("CONZIC_BENCH_QUANT", QUANT, ("none", "int8", "int8_all")),
        ("CONZIC_BENCH_STAGE1", STAGE1, ("proxy", "factorized")),
        ("CONZIC_BENCH_STAGE1_PRECUT_MODE", STAGE1_PRECUT_MODE,
         ("proxy", "tower")),
        ("CONZIC_BENCH_STAGE1_CTL", STAGE1_CTL, ("auto", "on", "off")),
        ("CONZIC_BENCH_CTL", CTL, (None, "sentiment", "pos")),
        ("CONZIC_BENCH_ATTN", ATTN, ("xla", "pallas", "pallas_out",
                                     "pallas_block", "twoblock", "xla_bhsd")),
    ):
        if val not in allowed:
            sys.exit(f"{name}={val!r} is not one of {allowed}")


def build_captioner():
    from conzic_torch.config import ConzicConfig
    from conzic_torch.engine.sampler import Captioner
    from conzic_torch.models.configs import BertConfig, CLIPConfig
    from conzic_torch.text.vocab import make_fullsize_wordpiece_vocab

    on_card = DEVICE == "cuda"
    cfg = ConzicConfig()
    cfg.verbose = False
    cfg.attn_impl = ATTN
    cfg.dtype = "bfloat16" if on_card else "float32"
    cfg.param_dtype = PARAM_DTYPE if on_card else "float32"
    cfg.kv_chunk_size = KV_CHUNK
    cfg.clip_row_chunk = ROW_CHUNK
    cfg.clip_token_budget = TOKEN_BUDGET
    cfg.quant = QUANT if on_card else "none"
    EFFECTIVE["quant"] = cfg.quant
    cfg.clip_pad_to = PAD_TO
    cfg.clip_window = CLIP_WINDOW
    cfg.topk_chunk = TOPK_CHUNK
    cfg.mask_impl = MASK_IMPL
    if PRUNE:  # the config's tier, which Captioner validates
        cfg.prune_k = PRUNE
        cfg.prune_stage1 = STAGE1
        cfg.prune_stage1_layers = STAGE1_LAYERS
        cfg.prune_stage1_precut = STAGE1_PRECUT
        cfg.prune_stage1_precut_mode = STAGE1_PRECUT_MODE
        cfg.prune_stage1_precut_layers = STAGE1_PRECUT_LAYERS
        cfg.prune_stage1_ctl = STAGE1_CTL
    if SMALL_MODELS:
        cap = Captioner.from_random(config=cfg, device=DEVICE)
    else:
        cap = Captioner.from_random(
            config=cfg, bert_config=BertConfig(), clip_config=CLIPConfig(),
            wp_vocab=make_fullsize_wordpiece_vocab(),
            clip_text_vocab_size=49408, device=DEVICE)
    layers = cap.clip_model.config.text.num_layers
    EFFECTIVE["stage1_pct"] = round(100 * STAGE1_LAYERS / layers)
    EFFECTIVE["precut_tower_pct"] = (
        round(100 * STAGE1_PRECUT_LAYERS / layers)
        if STAGE1_PRECUT and STAGE1_PRECUT_MODE == "tower" else 0)
    return cap


def bench_ours() -> float:
    import torch

    cap = build_captioner()
    cap.cfg.clip_len = CLIP_LEN
    rng = np.random.RandomState(0)
    image_embeds = torch.from_numpy(
        rng.randn(BATCH, cap.clip_model.config.projection_dim)
        .astype(np.float32)).to(cap.device)

    def run():
        return cap.run(
            image_embeds, prompt=PROMPT, max_len=SENTENCE_LEN, top_k=K,
            temperature=0.1, max_iter=ITERS, alpha=0.02, beta=2.0,
            gamma=5.0 if CTL else 0.0, order="sequential", ctl=CTL,
            rng=np.random.RandomState(42), prune_k=PRUNE,
            prune_final_exact=PRUNE_FINAL_EXACT)

    run()  # warm-up: kernel loads, pruned-tier tables, allocator
    if PRUNE and STAGE1 == "factorized":
        # the automatic depth (CONZIC_BENCH_STAGE1_LAYERS=0) resolves in
        # the first run; label and gate describe the depth that ran
        EFFECTIVE["stage1_pct"] = round(
            100 * cap.cfg.prune_stage1_layers
            / cap.clip_model.config.text.num_layers)
    walls = []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        run()  # returns host arrays: the card has finished
        walls.append(time.perf_counter() - t)
        elapsed = time.perf_counter() - t0
        if elapsed > 30 or len(walls) >= 16:
            break
    print("run wall s: " + json.dumps([round(w, 4) for w in walls]),
          file=sys.stderr, flush=True)
    return BATCH * len(walls) / elapsed


def lookup_quality_cell(matrix, head, clip_len=24):
    """Resolve the best-estimator quality cell for an operating-point
    ``head`` (the cell-key grammar's prefix): trained-weights cells first,
    then the random-weight cells; within a source, the largest-sample
    ``@n<N>`` cell wins; ``@len<L>`` cells are preferred at non-default
    clip_len.

    Returns (cell, weights_label, n_sample, borrowed_default_len)."""
    cells = matrix.get("cells", {})

    def scan(source_cells, lentail):
        point = {}
        for k, v in source_cells.items():
            if lentail:
                if not k.endswith(lentail):
                    continue
                k = k[: -len(lentail)]
            elif "@len" in k:
                continue
            if k == head:
                point[4] = v
            else:
                m = re.fullmatch(re.escape(head) + r"@n(\d+)", k)
                if m:
                    point[int(m.group(1))] = v
        return point

    sources = []
    if matrix.get("trained", {}).get("cells"):
        sources.append(("trained-tiny", matrix["trained"]["cells"]))
    sources.append((matrix.get("weights"), cells))
    for label, source_cells in sources:
        borrowed = False
        point = scan(source_cells, f"@len{clip_len}" if clip_len != 24 else "")
        if not point and clip_len != 24:
            point = scan(source_cells, "")
            borrowed = bool(point)
        if point:
            n = max(point)
            return point[n], label, n, borrowed
    return None, None, None, False


def gate_head() -> str:
    """The cell head of the operating point that ran, in
    ``conzic_torch.tools.validate_pruning.cell_key``'s order. No
    ``+approx`` suffix: the port runs the exact top-k under either mode."""
    if STAGE1 == "factorized":
        pct = EFFECTIVE.get("stage1_pct", round(100 * STAGE1_LAYERS / 12))
        suffix = f"+fact{pct:g}"
        if STAGE1_PRECUT:
            suffix += f"pc{STAGE1_PRECUT}"
            pc_pct = EFFECTIVE.get(
                "precut_tower_pct",
                round(100 * STAGE1_PRECUT_LAYERS / 12)
                if STAGE1_PRECUT_MODE == "tower" else 0)
            if pc_pct:
                suffix += f"t{pc_pct:g}"
    else:
        suffix = ""
    if CTL and STAGE1_CTL != "off":
        suffix += "+ctlrank"
    if PRUNE_FINAL_EXACT:
        suffix += "+final_exact"
    quant = EFFECTIVE.get("quant", QUANT)
    if quant != "none":
        suffix += f"+{quant}"
    return f"sequential/{CTL or 'free'}/prune{PRUNE}{suffix}"


def check_prune_quality():
    """Gate the (non-parity) pruned headline on the port's quality matrix,
    ``records_torch/PRUNING_MATRIX.json``: warn when it is missing, has no
    cell for this operating point, or shows material CLIPScore or
    attribute-recall loss there."""
    path = os.path.join(RECORDS_DIR, "PRUNING_MATRIX.json")
    if not os.path.exists(path):
        print("WARNING: prune_k set but records_torch/PRUNING_MATRIX.json "
              "is missing — run python -m "
              "conzic_torch.tools.validate_pruning --matrix first; the "
              "pruned number has no quality bound attached.",
              file=sys.stderr)
        return
    with open(path) as f:
        matrix = json.load(f)
    head = gate_head()
    cell, weights_label, n, borrowed = lookup_quality_cell(
        matrix, head, CLIP_LEN)
    if borrowed:
        print(f"NOTE: no clip_len={CLIP_LEN} quality cell — gating "
              f"on the clip_len=24 cells for this prune/mode point.",
              file=sys.stderr)
    if cell is None:
        print(f"WARNING: records_torch/PRUNING_MATRIX.json has no cell for "
              f"{head} — this operating point's quality is unmeasured "
              f"(python -m conzic_torch.tools.validate_pruning --matrix "
              f"--merge / conzic_torch.tools.approx_quality_cells adds it).",
              file=sys.stderr)
        return
    delta = cell["best_cosine_delta"]
    if weights_label == "trained-tiny":
        ckpt = cell.get("checkpoint", "trained_tiny")
        print(f"quality gate: trained-tiny cell ({ckpt}), "
              f"best-cosine delta {delta:+.4f} @n{n}", file=sys.stderr)
    if delta > 0.01:
        print(f"WARNING: best-cosine delta at this operating point is "
              f"{delta:+.4f} (> 0.01); treat the pruned throughput as "
              f"quality-degraded ({weights_label}).", file=sys.stderr)
    af, ap = cell.get("attr_recall_full"), cell.get("attr_recall_pruned")
    if af is not None and ap is not None and af - ap > 0.10:
        print(f"WARNING: attribute recall drops {af:.2f}→{ap:.2f} at "
              f"this operating point (Δ>{0.10}); the caption names "
              f"fewer scene attributes than full parity even though "
              f"the Δcos gate {'passes' if delta <= 0.01 else 'fails'}.",
              file=sys.stderr)


def best_quality_bounded_point():
    """The fastest operating point of the port's ladder
    (``records_torch/LADDER.json``, caps/s measured on the card) whose
    quality cell in ``records_torch/PRUNING_MATRIX.json`` sits under the
    0.01 Δcos gate, or the smallest-delta point when none does. Returns a
    dict for the JSON line, or None without both records."""
    lpath = os.path.join(RECORDS_DIR, "LADDER.json")
    mpath = os.path.join(RECORDS_DIR, "PRUNING_MATRIX.json")
    if not (os.path.exists(lpath) and os.path.exists(mpath)):
        return None
    with open(lpath) as f:
        ladder = json.load(f)
    with open(mpath) as f:
        matrix = json.load(f)
    best = nearest = None
    for pt in ladder.get("points", []):
        # free-mode rows only, and never a row superseded by a program change
        if pt.get("mode", "free") != "free" or "superseded" in pt:
            continue
        cell, label, n, _ = lookup_quality_cell(matrix, pt["gate_cell"])
        if cell is None:
            continue
        delta = cell["best_cosine_delta"]
        entry = {
            "config": pt["name"],
            "captions_per_sec": pt["caps_per_s"],
            "gate_cell": f"{pt['gate_cell']}@n{n}",
            "best_cosine_delta": round(delta, 5),
            "weights": label,
            "weights_checkpoint": cell.get("checkpoint", "trained_tiny")
            if label == "trained-tiny" else None,
            "under_gate": delta <= 0.01,
            "session": pt.get("session"),
        }
        af = cell.get("attr_recall_full")
        ap = cell.get("attr_recall_pruned")
        if af is not None and ap is not None:
            entry["attr_recall"] = [round(af, 3), round(ap, 3)]
            entry["attr_recall_drop"] = round(af - ap, 3) > 0.10
        if delta <= 0.01 and (
                best is None or pt["caps_per_s"] > best["captions_per_sec"]):
            best = entry
        if nearest is None or delta < nearest["best_cosine_delta"]:
            nearest = entry
    return best or nearest


def describe_baseline_basis(basis, vs):
    """One sentence stating what the vs_baseline ratio is: an extrapolation
    from a few torch-CPU positions at B=1, not a full run."""
    if basis:
        spread = basis.get("per_position_spread_pct")
        return (
            f"torch-CPU loop at B={basis.get('batch', 1)}, extrapolated "
            f"from {basis.get('positions_measured')} of "
            f"{basis.get('positions_total')} positions"
            + (f" (per-position spread {spread:g}%)"
               if spread is not None else "")
            + "; synthetic vocab; cross-VM drift up to ~12% (BASELINE.md)")
    if vs is not None:
        return ("torch-CPU loop extrapolated from 4 positions at B=1 "
                "(pre-r5 cache: per-position spread unrecorded); "
                "synthetic vocab; cross-VM drift up to ~12%")
    return None


def read_baseline():
    """(captions_per_sec, basis) of the committed baseline file, read only;
    (None, None) without it."""
    try:
        with open(BASELINE_CACHE) as f:
            cached = json.load(f)
        return cached["captions_per_sec"], cached.get("basis")
    except (OSError, ValueError, KeyError):
        return None, None


def metric_label() -> str:
    quant = EFFECTIVE.get("quant", QUANT)
    return (
        f"captions/sec/chip len={SENTENCE_LEN} iters={ITERS} k={K} B={BATCH}"
        + (f" ctl={CTL}" if CTL else "")
        + (f" clip_len={CLIP_LEN}" if CLIP_LEN != 24 else "")
        + (f" prune_k={PRUNE}" if PRUNE else "")
        + ((f" stage1=fact{EFFECTIVE.get('stage1_pct')}"
            + ((f"pc{STAGE1_PRECUT}"
                + (f"t{EFFECTIVE.get('precut_tower_pct')}"
                   if EFFECTIVE.get("precut_tower_pct") else ""))
               if STAGE1_PRECUT else ""))
           if PRUNE and STAGE1 == "factorized" else "")
        + (" ctlrank" if PRUNE and CTL and STAGE1_CTL != "off" else "")
        + (" final_exact" if PRUNE and PRUNE_FINAL_EXACT else "")
        + (f" quant={quant}" if quant != "none" else "")
        + (f" mask={MASK_IMPL}" if MASK_IMPL != "gather" else "")
        + (f" win={CLIP_WINDOW}" if CLIP_WINDOW else ""))


def main():
    check_knobs()
    import torch

    if DEVICE == "cuda" and not torch.cuda.is_available():
        sys.exit("conzic_torch.bench: CUDA is not available; the headline "
                 "runs on the card (CONZIC_BENCH_CPU=1 asks for the CPU)")
    ours = bench_ours()
    if PRUNE:  # after the run: the gate describes what ran
        check_prune_quality()
    baseline, basis = read_baseline()
    vs = (ours / baseline) if baseline else None
    quality_bounded = None
    try:
        quality_bounded = best_quality_bounded_point()
    except (OSError, ValueError, KeyError, TypeError) as e:
        # the headline must never die on a malformed ladder
        print(f"quality-bounded lookup failed: {e}", file=sys.stderr)
    print(json.dumps({
        "metric": metric_label(),
        "value": round(ours, 4),
        "unit": "captions/sec",
        "vs_baseline": round(vs, 2) if vs else None,
        "vs_baseline_basis": describe_baseline_basis(basis, vs),
        "quality_bounded": quality_bounded,
    }), flush=True)


if __name__ == "__main__":
    main()
