"""Configuration of the port.

Counterpart of ``conzic_tpu/config.py``: the ``ConzicConfig`` fields that
``Captioner`` reads for free and controlled captioning, with the reference
package's names and defaults. The knobs of paths not ported yet are held
at their defaults by :meth:`ConzicConfig.validate`, which raises
``NotImplementedError`` naming the knob for any other value.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

# knob -> the only value the port supports so far
_UNPORTED = {
    "prune_k": 0,
    "clip_window": 0,
    "quant": "none",
    "topk_mode": "exact",
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
    seed: int = 42  # default schedule RandomState of Captioner.run
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
    clip_window: int = 0
    quant: str = "none"
    topk_mode: str = "exact"
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
