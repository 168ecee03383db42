"""Configuration of the port, and the command-line flags of its entry
points.

Counterpart of ``conzic_tpu/config.py``: one ``ConzicConfig`` with the
reference CLIs' flags (names and defaults) and the fields that
``Captioner`` reads, and ``add_reference_args`` / ``config_from_args``,
which every entry point shares. The knobs of paths not ported yet parse and
are held at their defaults by :meth:`ConzicConfig.validate`, which raises
``NotImplementedError`` naming the knob for any other value.

XLA's own knobs: ``scan_layers`` is refused like an unported tier (the port
runs unrolled layers); ``--compiler_options`` is accepted and ignored, as
the reference ignores it on every backend but the TPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

# knob -> the only value the port supports so far
_UNPORTED = {
    "prune_k": 0,
    "prune_final_exact": False,
    "prune_stage1": "proxy",
    "prune_stage1_layers": 2,
    "prune_stage1_precut": 0,
    "prune_stage1_precut_mode": "proxy",
    "prune_stage1_precut_layers": 1,
    "prune_stage1_ctl": "auto",
    "allow_deep_stage1": False,
    "clip_window": 0,
    "quant": "none",
    "topk_chunk": 2048,
    "topk_mode": "exact",
    "topk_recall": 0.95,
    "mask_impl": "gather",
    "scan_layers": False,
    "mesh_data_axis": 1,
}
# the host modes: "table" runs on the device; "exact" runs the reference's
# decode and re-tokenize (bridge_mode) or sentence-level tagging (ctl_mode)
# on the host, once per Gibbs step
HOST_MODES = ("table", "exact")
# attention routes, by the reference's names (conzic_tpu/models/layers.py
# MultiHeadAttention): which hand-written kernel carries an attention block
ATTN_IMPLS = ("pallas", "pallas_out", "pallas_block")
# the reference's other values name XLA's own fusion of the attention chain
# ("xla", its default, and "xla_bhsd") or a plain-jnp formulation
# ("twoblock"); none has a counterpart on the card
_UNPORTED_ATTN_IMPLS = ("xla", "xla_bhsd", "twoblock")

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
    # projection; "pallas_block": full-row attention blocks as one kernel.
    # The reference defaults to "xla", attention left to its compiler; the
    # card has no such route, so the default here is the kernel route.
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
    # knobs of paths not ported yet (validate() refuses other values)
    prune_k: int = 0
    prune_final_exact: bool = False
    prune_stage1: str = "proxy"
    prune_stage1_layers: int = 2
    prune_stage1_precut: int = 0
    prune_stage1_precut_mode: str = "proxy"
    prune_stage1_precut_layers: int = 1
    prune_stage1_ctl: str = "auto"
    allow_deep_stage1: bool = False
    clip_window: int = 0
    quant: str = "none"
    topk_chunk: int = 2048
    topk_mode: str = "exact"
    topk_recall: float = 0.95
    mask_impl: str = "gather"
    scan_layers: bool = False
    mesh_data_axis: int = 1

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
        if self.attn_impl in _UNPORTED_ATTN_IMPLS:
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r} has no counterpart in "
                f"conzic_torch (one of {ATTN_IMPLS})")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        for knob in ("dtype", "param_dtype"):
            if getattr(self, knob) not in ("bfloat16", "float32"):
                raise ValueError(f"unknown {knob} {getattr(self, knob)!r}")
        if not 1 <= self.clip_len <= 77:
            raise ValueError(f"clip_len={self.clip_len} is not in [1, 77]")
        for knob, allowed in _CHOICES.items():
            if getattr(self, knob) not in allowed:
                raise ValueError(f"unknown {knob} {getattr(self, knob)!r} "
                                 f"(one of {allowed})")


_CHOICES = {
    "order": ("sequential", "shuffle", "span", "random", "parallel"),
    "run_type": ("caption", "controllable"),
    "control_type": ("sentiment", "pos"),
    "sentiment_type": ("positive", "negative"),
}


def add_reference_args(p: argparse.ArgumentParser) -> None:
    """The reference CLIs' flags, with ``--device cuda|cpu`` (the card
    unless the CPU is asked for). The flags of unported tiers parse; a
    value other than the default ends in ``config_from_args``."""
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
                   choices=ATTN_IMPLS + _UNPORTED_ATTN_IMPLS)
    # the unported tiers: parsed, refused unless at their defaults
    for knob, default in _UNPORTED.items():
        if knob == "scan_layers":  # a config field only, as in the reference
            continue
        if isinstance(default, bool):
            p.add_argument(f"--{knob}", action="store_true", default=default)
        else:
            p.add_argument(f"--{knob}", type=type(default), default=default)
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
