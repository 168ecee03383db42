"""Configuration of the port, and the command-line flags of its entry
points.

Counterpart of ``conzic_tpu/config.py``: one ``ConzicConfig`` with the
reference CLIs' flags (names and defaults) and the fields that
``Captioner`` reads, and ``add_reference_args`` / ``config_from_args``,
which every entry point shares. :meth:`ConzicConfig.validate` refuses the
combinations of the pruned tiers' knobs that the reference refuses, with
its messages.

XLA's own knobs: ``scan_layers`` is refused with ``NotImplementedError``
naming it (the port runs unrolled layers); ``--compiler_options`` is
accepted and ignored, as
the reference ignores it on every backend but the TPU. So is
``allow_deep_stage1``: it lifts the reference's guard on the depth of a
``lax.map``, and the port has no map.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

# knob -> the only value the port supports
_UNPORTED = {
    "scan_layers": False,
}
# the host modes: "table" runs on the device; "exact" runs the reference's
# decode and re-tokenize (bridge_mode) or sentence-level tagging (ctl_mode)
# on the host, once per Gibbs step
HOST_MODES = ("table", "exact")
# attention routes, by the reference's names (conzic_tpu/models/layers.py
# MultiHeadAttention): which hand-written kernel carries an attention block
KERNEL_IMPLS = ("pallas", "pallas_out", "pallas_block")
# and the reference's own formulations ("xla", its default, "xla_bhsd",
# "twoblock"): plain PyTorch products on the card, no hand-written kernel
ATTN_IMPLS = KERNEL_IMPLS + ("xla", "xla_bhsd", "twoblock")
QUANT_TIERS = ("none", "int8", "int8_all")

DEFAULT_POS_TEMPLATE: List[List[str]] = [
    ["DET"], ["ADJ", "NOUN"], ["NOUN"], ["VERB"], ["VERB"], ["ADV"],
    ["ADP"], ["DET", "NOUN"], ["NOUN"], ["NOUN", "."], [".", "NOUN"],
    [".", "NOUN"],
]


@dataclasses.dataclass
class ConzicConfig:
    # --- the reference CLIs' flags, names and defaults ---------------------
    seed: int = 42  # default schedule RandomState of Captioner.run
    batch_size: int = 1
    run_type: str = "caption"  # caption | controllable
    prompt: str = "Image of a"
    order: str = "shuffle"  # sequential | shuffle | span | random | parallel
    control_type: str = "sentiment"  # sentiment | pos
    sentiment_type: str = "positive"  # positive | negative
    samples_num: int = 2
    sentence_len: int = 10
    candidate_k: int = 200
    alpha: float = 0.02
    beta: float = 2.0
    gamma: float = 5.0
    lm_temperature: float = 0.1
    num_iterations: int = 10
    lm_model: str = "bert-base-uncased"
    match_model: str = "openai/clip-vit-base-patch32"
    caption_img_path: str = "./examples/girl.jpg"
    logger_dir: str = "logger"
    results_dir: str = "results"
    # --- what Captioner reads ----------------------------------------------
    # the POS control template: per caption word, the universal tags it
    # accepts (Captioner.run's pos_template overrides it per call)
    pos_type: List[List[str]] = dataclasses.field(
        default_factory=lambda: [list(s) for s in DEFAULT_POS_TEMPLATE])
    stop_words_path: Optional[str] = None  # rule-derived mask when None
    add_extra_stopwords: List[str] = dataclasses.field(default_factory=list)
    dtype: str = "bfloat16"  # compute type on the GPU; "float32" for parity
    param_dtype: str = "float32"  # "bfloat16" stores weights in bf16
    # prefix-K/V reuse: the position sweep is cut into chunks of this many
    # steps, each with a static bound on the candidates' shared CLIP
    # prefix (engine/gibbs.py). 0 disables.
    kv_chunk_size: int = 16
    # candidate CLIP rows per text-tower pass; 0 disables chunking
    clip_row_chunk: int = 800
    # contexts longer than 48 cap a pass to about this many tokens
    clip_token_budget: int = 16000
    clip_len: int = 32  # static CLIP context (<= 77)
    # pad candidate rows to this length (masked PAD columns); -1 = auto:
    # round clip_len up to a multiple of 8 when it exceeds 64; 0 = off
    clip_pad_to: int = -1
    # "pallas": every attention through the masked-attention kernel;
    # "pallas_out": suffix-over-prefix attention fused with its output
    # projection; "pallas_block": full-row attention blocks as one kernel;
    # "xla", "xla_bhsd", "twoblock": the reference's einsum formulations
    # as plain PyTorch products (the library route). The reference
    # defaults to "xla", attention left to its compiler; the default here
    # is the kernel route.
    attn_impl: str = "pallas"
    # candidate CLIP-id assembly: "table" = the on-device bridge table;
    # "exact" = the reference's decode -> re-tokenize of every candidate
    # on the host (no prefix K/V: every candidate row is encoded in full)
    bridge_mode: str = "table"
    # control energies: "table" = per-token tables on the device;
    # "exact" = the reference's sentence-level scoring of every decoded
    # candidate on the host (eval/sentiment_eval.py, eval/pos_eval.py)
    ctl_mode: str = "table"
    verbose: bool = True  # generate_caption logs every iteration
    # --- the pruned and hybrid tiers (not parity: quality at a speed) -------
    # score only prune_k of the k candidates through the full text tower,
    # picked by a stage-1 scorer; 0 = off (full parity)
    prune_k: int = 0
    # with prune_k: the last iteration scores all k candidates, a
    # full-parity sweep over the pruned state
    prune_final_exact: bool = False
    # stage-1 scorer: "proxy" (cosine of the image with the bag of the
    # candidate sentence's per-word CLIP embeddings) or "factorized" (the
    # first prune_stage1_layers text-tower layers and a calibrated
    # projection; 0 layers = the smallest depth whose held-out cosine clears
    # STAGE1_CALIB_FLOOR)
    prune_stage1: str = "proxy"
    prune_stage1_layers: int = 2
    # factorized only: cut k -> prune_stage1_precut first, by the proxy or
    # by a shallower tower of prune_stage1_precut_layers layers; 0 = off
    prune_stage1_precut: int = 0
    prune_stage1_precut_mode: str = "proxy"
    prune_stage1_precut_layers: int = 1
    # rank every stage-1 cut of a controlled run by the whole combined
    # score (control term included) instead of the surrogate cosine:
    # "auto" and "on" do so whenever control and pruning are both on
    prune_stage1_ctl: str = "auto"
    allow_deep_stage1: bool = False  # accepted; nothing to lift here
    # encode candidate chunks over their first clip_window columns (rounded
    # up to 8) when every row of the chunk fits: exact; 0 = off
    clip_window: int = 0
    # the exact two-stage top-k's block width (energies.exact_topk_2stage,
    # which the engine takes from 128 rows up, where the card measured it
    # faster than one sort: energies.TOPK_2STAGE_MIN_ROWS)
    topk_chunk: int = 2048
    # "approx" (pruned tiers only; _spec refuses it without prune_k): the
    # reference's approx_max_k, which is exact off the TPU, so the engine
    # runs the exact top-k under either mode. topk_recall, approx's recall
    # target, is parsed and read by nothing
    topk_mode: str = "exact"
    topk_recall: float = 0.95
    # stop-mask lookup of the top-k ids: "gather" from the (V,) mask, or
    # "compare" against the banned-id lists; the same ids either way
    mask_impl: str = "gather"
    # the int8 tier (not parity): "int8" multiplies the CLIP text tower's
    # projections and MLPs in int8, "int8_all" BERT's encoder too
    quant: str = "none"
    # devices to split the (images x samples) batch over: 1 = one device,
    # N = a data mesh of N, 0 or less = every visible device
    mesh_data_axis: int = 1
    scan_layers: bool = False  # refused: the port runs unrolled layers

    def validate(self) -> None:
        for knob, supported in _UNPORTED.items():
            if getattr(self, knob) != supported:
                raise NotImplementedError(
                    f"{knob}={getattr(self, knob)!r} is not ported to "
                    f"conzic_torch yet (only {supported!r})")
        for knob in ("bridge_mode", "ctl_mode"):
            if getattr(self, knob) not in HOST_MODES:
                raise ValueError(f"unknown {knob} {getattr(self, knob)!r} "
                                 f"(one of {HOST_MODES})")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.quant not in QUANT_TIERS:
            raise ValueError(f"unknown quant {self.quant!r} (one of "
                             f"{QUANT_TIERS})")
        for knob in ("dtype", "param_dtype"):
            if getattr(self, knob) not in ("bfloat16", "float32"):
                raise ValueError(f"unknown {knob} {getattr(self, knob)!r}")
        if not 1 <= self.clip_len <= 77:
            raise ValueError(f"clip_len={self.clip_len} is not in [1, 77]")
        for knob, allowed in _CHOICES.items():
            if getattr(self, knob) not in allowed:
                raise ValueError(f"unknown {knob} {getattr(self, knob)!r} "
                                 f"(one of {allowed})")
        self._validate_pruning()

    def _validate_pruning(self) -> None:
        """The reference's refusals (``conzic_tpu/config.py`` ``validate``),
        with its messages, as ValueError."""
        def need(ok: bool, message: str) -> None:
            if not ok:
                raise ValueError(message)

        need(self.clip_window >= 0, f"clip_window={self.clip_window} < 0")
        need(self.prune_stage1_layers >= 0,
             f"prune_stage1_layers={self.prune_stage1_layers} < 0 (0 = "
             "auto-select)")
        need(self.prune_stage1_precut >= 0,
             f"prune_stage1_precut={self.prune_stage1_precut} < 0")
        need(self.prune_stage1_precut_layers >= 1,
             f"prune_stage1_precut_layers={self.prune_stage1_precut_layers}"
             " < 1")
        if self.prune_stage1 == "factorized":
            need(self.prune_k > 0,
                 "--prune_stage1 factorized requires --prune_k")
            if self.prune_stage1_precut:
                need(self.prune_stage1_precut > self.prune_k,
                     "--prune_stage1_precut must exceed --prune_k "
                     "(it is the intermediate cascade width)")
                if (self.prune_stage1_precut_mode == "tower"
                        and self.prune_stage1_layers):
                    need(self.prune_stage1_precut_layers
                         < self.prune_stage1_layers,
                         "--prune_stage1_precut_layers must be SHALLOWER "
                         "than --prune_stage1_layers (the pre-cut exists "
                         "to be cheaper than the stage it feeds)")
        else:
            need(not self.prune_stage1_precut,
                 "--prune_stage1_precut only applies to the factorized "
                 "stage-1 (the proxy IS the pre-cut scorer)")


_CHOICES = {
    "order": ("sequential", "shuffle", "span", "random", "parallel"),
    "run_type": ("caption", "controllable"),
    "control_type": ("sentiment", "pos"),
    "sentiment_type": ("positive", "negative"),
    "prune_stage1": ("proxy", "factorized"),
    "prune_stage1_precut_mode": ("proxy", "tower"),
    "prune_stage1_ctl": ("auto", "on", "off"),
    "topk_mode": ("exact", "approx"),
    "mask_impl": ("gather", "compare"),
}
# the pruned tiers' flags, after the reference's (conzic_tpu/config.py)
_PRUNE_FLAGS = (
    ("prune_k", int, "candidates scored through the full text tower, "
     "picked by the stage-1 scorer (0 = full parity)"),
    ("prune_stage1", str, "stage-1 scorer for --prune_k: the bag-of-"
     "embeddings proxy or the truncated tower (factorized)"),
    ("prune_stage1_layers", int, "text-tower layers of the factorized "
     "stage-1 (0 = the smallest depth whose calibration clears the floor)"),
    ("prune_stage1_precut", int, "factorized: first cut k to this many (0 = "
     "off)"),
    ("prune_stage1_precut_mode", str, "pre-cut scorer: the proxy or a "
     "shallower tower"),
    ("prune_stage1_precut_layers", int, "the tower pre-cut's depth (below "
     "--prune_stage1_layers)"),
    ("prune_stage1_ctl", str, "rank stage-1 cuts of controlled runs by the "
     "whole combined score"),
    ("clip_window", int, "encode candidates over their first N columns when "
     "they fit (exact; 0 = off)"),
    ("topk_chunk", int, "block width of the exact two-stage top-k"),
    ("topk_mode", str, "approx needs --prune_k; exact off the TPU"),
    ("topk_recall", float, "approx top-k's recall target"),
    ("mask_impl", str, "stop-mask lookup of the top-k ids (the same ids "
     "either way)"),
)


def add_reference_args(p: argparse.ArgumentParser) -> None:
    """The reference CLIs' flags, with ``--device cuda|cpu`` (the card
    unless the CPU is asked for). A combination of the pruned tiers' flags
    that the reference refuses ends in ``config_from_args``."""
    d = ConzicConfig()
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels on the card "
                        "and raises without one; cpu runs their plain "
                        "versions")
    p.add_argument("--run_type", default=d.run_type, nargs="?",
                   choices=_CHOICES["run_type"])
    p.add_argument("--prompt", default=d.prompt, type=str)
    p.add_argument("--order", default=d.order, nargs="?",
                   choices=_CHOICES["order"])
    p.add_argument("--control_type", default=d.control_type, nargs="?",
                   choices=_CHOICES["control_type"])
    p.add_argument("--sentiment_type", default=d.sentiment_type, nargs="?",
                   choices=_CHOICES["sentiment_type"])
    p.add_argument("--samples_num", default=d.samples_num, type=int)
    p.add_argument("--sentence_len", type=int, default=d.sentence_len)
    p.add_argument("--candidate_k", type=int, default=d.candidate_k)
    p.add_argument("--alpha", type=float, default=d.alpha)
    p.add_argument("--beta", type=float, default=d.beta)
    p.add_argument("--gamma", type=float, default=d.gamma)
    p.add_argument("--lm_temperature", type=float, default=d.lm_temperature)
    p.add_argument("--num_iterations", type=int, default=d.num_iterations)
    p.add_argument("--lm_model", type=str, default=d.lm_model)
    p.add_argument("--match_model", type=str, default=d.match_model)
    p.add_argument("--caption_img_path", type=str,
                   default=d.caption_img_path)
    p.add_argument("--stop_words_path", type=str, default=None)
    p.add_argument("--add_extra_stopwords", type=str, nargs="*", default=[])
    p.add_argument("--dtype", type=str, default=d.dtype,
                   choices=["bfloat16", "float32"])
    p.add_argument("--param_dtype", type=str, default=d.param_dtype,
                   choices=["bfloat16", "float32"])
    p.add_argument("--bridge_mode", type=str, default=d.bridge_mode,
                   choices=HOST_MODES)
    p.add_argument("--ctl_mode", type=str, default=d.ctl_mode,
                   choices=HOST_MODES)
    p.add_argument("--kv_chunk_size", type=int, default=d.kv_chunk_size)
    p.add_argument("--clip_row_chunk", type=int, default=d.clip_row_chunk)
    p.add_argument("--clip_token_budget", type=int,
                   default=d.clip_token_budget)
    p.add_argument("--clip_len", type=int, default=d.clip_len)
    p.add_argument("--clip_pad_to", type=int, default=d.clip_pad_to)
    p.add_argument("--attn_impl", type=str, default=d.attn_impl,
                   choices=ATTN_IMPLS)
    for knob, kind, help_ in _PRUNE_FLAGS:
        p.add_argument(f"--{knob}", type=kind, default=getattr(d, knob),
                       choices=_CHOICES.get(knob), help=help_)
    p.add_argument("--prune_final_exact", action="store_true",
                   help="with --prune_k: score all k in the last iteration")
    p.add_argument("--allow_deep_stage1", action="store_true",
                   help="the reference's override of a TPU runtime guard; "
                        "accepted, no effect here")
    p.add_argument("--quant", type=str, default=d.quant, choices=QUANT_TIERS,
                   help="int8: the CLIP text tower's products in int8 (not "
                        "parity); int8_all: BERT's encoder too")
    p.add_argument("--mesh_data_axis", type=int, default=d.mesh_data_axis,
                   help="devices to split the (images x samples) batch "
                        "over, one thread a device in this process: 1 = "
                        "one, 0 = every visible device. Slower than one "
                        "card on the H100 (the threads share one "
                        "interpreter); for several cards run one process "
                        "a card with --multihost")
    p.add_argument("--compiler_options", type=str, default="",
                   help="XLA's options in the reference; accepted and "
                        "ignored here")


def config_from_args(args: argparse.Namespace) -> ConzicConfig:
    """The config of the parsed flags; a knob the port refuses ends the
    program with ``validate``'s message."""
    cfg = ConzicConfig()
    for f in dataclasses.fields(ConzicConfig):
        if hasattr(args, f.name):
            setattr(cfg, f.name, getattr(args, f.name))
    try:
        cfg.validate()
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(f"conzic_torch: {e}") from None
    return cfg
