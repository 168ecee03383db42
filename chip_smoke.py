#!/usr/bin/env python3
"""Drive ``conzic_torch`` on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--iters 15] [--profile [ROUTE ...]]
    python3 chip_smoke.py --trees DIR [DIR ...] [--reps 3] [--kernels]
    python3 chip_smoke.py --scale      (two or more cards)

Phases, each printing its own lines:

1. environment: versions, the card's name and power limit, the kernel build
   (``nvcc`` into ``build/conzic_torch/``) and the TF32 switches (off);
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in bf16 and fp32, at the shapes free captioning gives it, with the
   kernel's time beside the plain version's, a PyTorch library call's and
   the bound (bytes over 3.35 TB/s or operations over the peak rate); the
   same at the pruned tiers' shapes (``pruned_path_cases``); then the three
   attention kernels at ragged shapes (``edge_cases``), checked and not
   timed; masked attention's bf16 cases again on fresh draws
   (``sweep_masked_attention``); then the exact two-stage top-k against
   the one stable sort at several batches (``phase_topk_chunk``);
3. agreement: a tiny fp32 captioner run through the kernels and again with
   every tensor on the CPU must give identical caption ids, under every
   ``attn_impl`` and in the sequential, shuffle, span and parallel orders;
   then controlled runs (sentiment and POS control, in table and exact
   mode, and free captioning with the exact bridge) must give identical
   ids and equal control scores, and the control energy terms on the card
   must equal the CPU's (``exp`` at 0 .. 77 printed beside them); then the
   pruned and hybrid tiers on a tiny captioner with a 4-layer text tower
   (``PRUNED_CASES``), the card on the CPU's pruned-tier tables: identical
   ids; then the int8 tiers and the XLA attention routes (``ROUTE_CASES``:
   identical ids, no attention kernel launched under the XLA routes), a
   data mesh of two replicas on the one card (``[cuda:0, cuda:0]``, a
   ragged batch; then a 2 x 2 (data, model) mesh on the card, BERT's word
   table and MLM bias cut in two, in ``MESH_2D_CASES``: sequential and
   shuffle over 3 images x 2 samples, ``prune_k``, sentiment control and
   ``int8_all`` over 3 images; then two threads launching
   ``masked_attention`` at two sizes, every launch succeeding), two
   processes sharing the card over ``gloo`` (each ``chip_smoke.py
   --worker``), all with the CPU's ids, and ``make_mesh`` refusing more
   cards than the machine has;
4. main path: full-width ``bert-base-uncased`` + CLIP ViT-B/32 towers with
   random seeded bf16 weights caption B=32 seeded images with the settings
   of bench.py (k=200, sentence_len 10, clip_len 24, sequential order,
   prompt "Image of a", 800-row chunks, prompt-only prefix K/V), once under
   each ``attn_impl``. The launch counts of the kernels over each run are
   read and checked against what the engine's structure gives. Under
   ``pallas`` the same run follows with sentiment-positive and POS table
   control (gamma 5.0), whose launch counts must be the free run's, and
   one iteration each of the exact modes (sentiment ``ctl_mode="exact"``
   and ``bridge_mode="exact"``, the latter with full-row counts), then the
   pruned tiers at full width: the README's flagship at B=512 and its
   hybrid at B=32 (``FLAGSHIP``, ``HYBRID``), each with its tables' build
   time, caps/s and launch counts equal to the engine's structure;
   After the three runs, the full-width towers are written as two HF
   checkpoint directories (config.json, model.safetensors, tokenizer
   files) and read back by ``Captioner.from_pretrained``: every parameter
   bit-equal, equal caption ids;
5. trained checkpoint: ``trained_tiny/`` through the port's own reader
   (``Captioner.from_tiny_dir``), sentiment-positive and -negative table
   control on seeded pixels in fp32, card against CPU;
6. command line: ``api.run.main`` at full width over 32 seeded scenes of
   ``data/synthetic.py`` written as PNG (the main path's settings; the
   results tree complete, the launch counts the engine's), the same
   command in two processes sharing the card (``python -m
   conzic_torch.api.run --multihost``, gloo between them: the tree
   written once, by process 0, with the one-process command's captions;
   caps/s), then ``api.demo.main`` on ``trained_tiny/`` over examples/girl.jpg on the
   card and on the CPU (equal caption lines); then, for information, bf16
   against fp32 caption ids on trained_tiny/ and trained_mid/ over their
   own rendered scenes, sentiment control's effect on trained_mid/, and
   trained_mid/ at the flagship's settings, bf16 against fp32;
7. new paths at full width: the main path under ``--quant int8``,
   ``int8_all`` and ``--attn_impl xla`` (``NEW_MAIN_PATHS``: caps/s, s a
   step, launch counts against the engine's structure, the share of best
   ids equal to the bf16 pallas run's), the int8 product at the text MLP's
   shape against ``F.linear`` (its int32 result equal to the CPU's);
8. the fallback web server answering two POSTs of a rendered scene at the
   UI's defaults (latency), ``build_index`` over 2,048 synthetic captions
   (captions/s) and one search, and the main path on two replicas of one
   process on the card, one thread each (caps/s; the share of ids equal
   to one process's, information); then, at 2 iterations
   (``MESH_2D_ITERS``), the main path on one card, on that data mesh and
   on a 2 x 2 (data, model) mesh of the card with V = 30,522 cut in two:
   caps/s, launch counts equal to the data mesh's, the share of best ids
   equal to one card's, and each shard's bytes;
9. training (``phase_train``): the LayerNorm Function on the card (the
   kernel forward, launch counted, and the reference's plain backward)
   against the CPU at F = 128, 256 and 768, fp32 and bf16 x; one fp32
   step of a tiny CLIP and a tiny BERT, card against CPU from the same
   parameters, batch and masks (losses, gradient norms, the gradients
   below the first LayerNorm non-zero); then the trainer's command
   (``conzic_torch.train.tiny``) at trained_mid/'s widths with the data
   and the steps cut (``TRAIN_MID``, ``TRAIN_CUTS``): steps/s per tower,
   the loss falling, LayerNorm launches equal to the towers' structure
   (forward kernels only), the LayerNorm forward's and backward's device
   time a step, peak memory; and the saved directory captioning two
   scenes on the card through ``Captioner.from_tiny_dir``;
10. bench and tools (``phase_bench_tools``): ``python -m
   conzic_torch.bench`` at its defaults under the xla and the pallas
   routes, each JSON line printed and checked (``bench.py``'s keys, a
   positive value, the label of the settings that ran); then
   ``conzic_torch.tools.validate_pruning`` (one cell) and
   ``conzic_torch.tools.trained_quality_cells`` (one job, into a scratch
   record: its schema, the card as its device) on trained_tiny/ at a small
   size.

``--scale`` (a machine of two or more cards) runs only the scale-out
phase over every card: tiny fp32 ids equal to the CPU's on a data mesh
of every card, on an (n/2, 2) (data, model) mesh of the cards (an even
number of them) and in one process a card; then the main path at full
width on one card, on the data mesh and on the (n/2, 2) mesh (caps/s,
launch counts, ids equal to one card's; each card's allocated memory and
vocabulary bytes under both meshes), and phase 6's command in one process
and in ``api.run --multihost``, one process a card (the same captions;
caps/s).

The last two lines are a JSON object with one entry per kernel (its
``launches`` are those of the main-path run under the ``attn_impl`` that the
kernel carries; ``launches_by_attn_impl`` has every run's,
``launches_pruned`` the pruned reads', ``launches_new_paths`` phase 7's,
``launches_mesh_2x2`` phase 8's 2 x 2 mesh's, ``launches_train`` phase
9's full-width training command's)
and
``{"ok": true, "device": {...}}``. Without CUDA, or when a phase fails, the
script exits non-zero without them. It imports nothing of JAX.

``--trees`` is for comparing commits on one card inside one call: it runs
only the main path, under the default ``attn_impl``, in each checkout
named (``.`` is this one; unpack another commit with ``git archive``), in
the order given, one process per entry, ``--reps`` runs each, and prints
each run's caps/s; with ``--kernels`` it times each tree's kernels at the
main-path shapes instead, as phase 2 does, and prints a digest of the two
fused kernels' outputs on seeded inputs that every tree makes alike. Name the trees in turns
(parent, change, change, parent): the host's load moves the number from run
to run.
"""

from __future__ import annotations

import argparse
import base64
import copy
import dataclasses
import gc
import http.client
import io
import json
import os
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from conzic_torch import energies
from conzic_torch.api import app as app_mod
from conzic_torch.api import demo as demo_cli
from conzic_torch.api import fallback_ui, retrieval
from conzic_torch.api import run as run_cli
from conzic_torch.config import KERNEL_IMPLS, ConzicConfig
from conzic_torch.data import synthetic
from conzic_torch.engine.gibbs import row_chunk_width
from conzic_torch.engine.sampler import PRUNE_TABLES, Captioner
from conzic_torch.eval import ndiv
from conzic_torch.eval.sentiment_eval import (
    _nltk_ready,
    batch_texts_sentiment_scores,
)
from conzic_torch.kernels import build
from conzic_torch.kernels.build import card_line
from conzic_torch.kernels.attention_block import (
    attention_block,
    attention_block_plain,
)
from conzic_torch.kernels.attention_with_out import (
    attention_with_out,
    attention_with_out_plain,
)
from conzic_torch.kernels.layer_norm import (
    layer_norm,
    layer_norm_backward_plain,
    layer_norm_plain,
)
from conzic_torch.kernels.masked_attention import (
    masked_attention,
    masked_attention_plain,
)
from conzic_torch.kernels.timing import time_ms
from conzic_torch.models.checkpoint import load_tiny_checkpoint
from conzic_torch.models.configs import BertConfig, CLIPConfig
from conzic_torch.models.convert import hf_names
from conzic_torch.models.layers import Linear
from conzic_torch.ops import quant
from conzic_torch.ops.attention import XLA_IMPLS, attention_keep_mask
from conzic_torch.parallel import distributed as dist_lib
from conzic_torch.parallel.mesh import make_mesh, make_mesh_2d
from conzic_torch.parallel.vocab import VOCAB_PARAMS, VocabSplitBert
from conzic_torch.runtime.image import preprocess_pil, preprocess_torch
from conzic_torch.text.lexicons import UNIVERSAL_TAGS, _nltk_available
from conzic_torch.text.vocab import (
    make_fullsize_wordpiece_vocab,
    make_test_bpe_files,
    make_test_wordpiece_vocab,
)
from conzic_torch.train import optim as train_optim
from conzic_torch.train import tiny as train_tiny

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense tensor-core bf16
                  torch.float32: 67e12}  # fp32 outside the tensor cores
# kernel vs plain version: fp32 to 1e-4 absolute (sums in another order);
# bf16 to BF16_ULPS[kernel] bf16 ulps of max(|plain|, 1). One ulp where the
# two round at one place each. attention_block rounds q, k, v, the context
# and y = round(ctx Wo^T + bo) before the residual is added and the sum is
# rounded again: its tensor-core sums run in another order than the plain
# version's, one of those roundings flips now and then, and where |y| is
# larger than |out| the flipped step of y is more than one step of out.
# (y 1.18 against 1.1875, neighbours in bf16, plus a residual of 0.18 gives
# two sums that each lie halfway between bf16 values and round apart: 1.359
# against 1.375.) On an H100 this script reads 1.22 at worst in the text
# full-row chunk (a handful of its 9.8 million outputs) and 1.16 in the
# causal edge case; every other case stays within one. Hence two ulps for
# that kernel. masked_attention's bf16 bound follows from where the two
# sides round: each softmax weight is computed in fp32 (the kernel's logits
# summed on the tensor cores in another order) and rounded to bf16 before
# the weighted sum. A weight next to a rounding boundary can land on the
# other neighbour, one step, at most 2^-7 of the weight, and that moves the
# output by up to 2^-7 w_j |v_j|; the output's own rounding adds one step.
# So an output may lie 2^-7 (max(|plain|, 1) + sum_j w_j |v_j|) from its
# plain version (Case.spread_fn gives the sum), whatever the inputs; one
# ulp of max(|plain|, 1) alone refuses about one call in a hundred on
# fresh draws (sweep_masked_attention counts them)
BF16_ULP = 2.0 ** -7
BF16_ULPS = {"layer_norm": 1, "attention_with_out": 1, "attention_block": 2}
# fresh draws of phase 2's bf16 masked-attention cases
SWEEP_SEEDS = 400
FP32_ATOL = 1e-4
AGREE_COS_ATOL = 1e-4

KERNELS = {
    "layer_norm": dict(route="cuda", source="conzic_torch/csrc/layer_norm.cu",
                       replaces="conzic_tpu/ops/fused_ln.py:90"),
    "masked_attention": dict(
        route="cuda", source="conzic_torch/csrc/masked_attention.cu",
        replaces="conzic_tpu/ops/fused_attention.py:112"),
    "attention_with_out": dict(
        route="cuda", source="conzic_torch/csrc/attention_with_out.cu",
        replaces="conzic_tpu/ops/fused_attention.py:196"),
    "attention_block": dict(
        route="cuda", source="conzic_torch/csrc/attention_block.cu",
        replaces="conzic_tpu/ops/fused_attn_block.py:96"),
}
WRAPPERS = {"layer_norm": layer_norm, "masked_attention": masked_attention,
            "attention_with_out": attention_with_out,
            "attention_block": attention_block}
# the attn_impl whose main-path run gives a kernel's launch count
ROUTE_OF = {"layer_norm": "pallas", "masked_attention": "pallas",
            "attention_with_out": "pallas_out",
            "attention_block": "pallas_block"}
DEVICE = "cuda"
MAIN = dict(batch=32, top_k=200, sentence_len=10, clip_len=24,
            prompt="Image of a", row_chunk=800, kv_chunk=16)
GAMMA = 5.0  # the control weight of the controlled runs
# the trained-weights precision runs; their CPU reference bounds the size
PRECISION = dict(scenes=8, top_k=48, sentence_len=8, iters=2)
TRAINED_TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "trained_tiny")
# a per-call POS template: list slots, a string slot (a substring test in
# exact mode) and a bare "" slot (matches anything)
AGREE_TEMPLATE = [["DET"], ["NOUN"], "ADJ", "", ["VERB", "NOUN"]]
# the pruned tiers at full width (phase 4), with the main path's other
# settings: the README's flagship (factorized stage-1, 6 of 12 layers, behind
# a proxy pre-cut to 32, 3 survivors, approximate top-k, which is exact off
# the TPU) and its hybrid tier (the proxy keeps 5; the last iteration scores
# all k)
FLAGSHIP = dict(batch=512, cfg=dict(
    prune_k=3, prune_stage1="factorized", prune_stage1_layers=6,
    prune_stage1_precut=32, topk_mode="approx", topk_recall=0.90))
HYBRID = dict(batch=32, cfg=dict(prune_k=5, prune_final_exact=True))
# the pruned agreement runs (phase 3): a tiny captioner whose text tower is
# 4 layers deep; (label, config fields, run arguments, attn_impl)
TINY_FACT = dict(prune_k=4, prune_stage1="factorized", prune_stage1_layers=2)
TOWER_PRECUT = dict(TINY_FACT, prune_stage1_precut=8,
                    prune_stage1_precut_mode="tower",
                    prune_stage1_precut_layers=1)
PRUNED_CASES = (
    ("proxy, sequential", dict(prune_k=4), dict(order="sequential"),
     "pallas"),
    ("proxy, parallel", dict(prune_k=4), dict(order="parallel"), "pallas"),
    ("hybrid, shuffle", dict(prune_k=4, prune_final_exact=True),
     dict(order="shuffle"), "pallas"),
    ("factorized 2 of 4", TINY_FACT, dict(order="sequential"), "pallas"),
    ("factorized, proxy pre-cut", dict(TINY_FACT, prune_stage1_precut=8),
     dict(order="sequential"), "pallas"),
    ("factorized, tower pre-cut", TOWER_PRECUT, dict(order="sequential"),
     "pallas"),
    ("factorized, tower pre-cut", TOWER_PRECUT, dict(order="sequential"),
     "pallas_out"),
    ("factorized, tower pre-cut", TOWER_PRECUT, dict(order="sequential"),
     "pallas_block"),
    ("sentiment, control-aware rank, proxy pre-cut",
     dict(TINY_FACT, prune_stage1_precut=8),
     dict(order="shuffle", ctl="sentiment", gamma=GAMMA), "pallas"),
    ("clip_window 24 at clip_len 77, factorized",
     dict(TINY_FACT, clip_len=77, clip_window=24), dict(order="sequential"),
     "pallas"),
    ("mask_impl compare, proxy", dict(prune_k=4, mask_impl="compare"),
     dict(order="sequential"), "pallas"),
)
# (label, config fields, run arguments) of the controlled agreement runs
CONTROL_CASES = (
    ("sentiment table, positive, sequential", {},
     dict(ctl="sentiment", order="sequential")),
    ("sentiment table, negative, sequential", {},
     dict(ctl="sentiment", negative=True, order="sequential")),
    ("sentiment table, positive, shuffle", {},
     dict(ctl="sentiment", order="shuffle")),
    ("sentiment table, negative, shuffle", {},
     dict(ctl="sentiment", negative=True, order="shuffle")),
    ("pos table, default template", {}, dict(ctl="pos", order="sequential")),
    ("pos table, per-call template", {},
     dict(ctl="pos", order="sequential", pos_template=AGREE_TEMPLATE)),
    ("sentiment exact", dict(ctl_mode="exact"),
     dict(ctl="sentiment", order="sequential")),
    ("pos exact", dict(ctl_mode="exact"), dict(ctl="pos",
                                              order="sequential")),
    ("free, exact bridge, sequential", dict(bridge_mode="exact"),
     dict(order="sequential")),
    ("free, exact bridge, span", dict(bridge_mode="exact"),
     dict(order="span")),
)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Case:
    kernel: str
    label: str
    dtype: torch.dtype
    kernel_fn: Callable[[], torch.Tensor]
    plain_fn: Callable[[], torch.Tensor]
    library_fn: Callable[[], torch.Tensor]  # timed only, never checked
    n_bytes: int  # each input read once, each output written once
    n_ops: int  # what these inputs need
    # further yardsticks, timed and printed beside library_ms
    also: Dict[str, Callable[[], torch.Tensor]] = dataclasses.field(
        default_factory=dict)
    # masked attention: sum_j w_j |v_j| of each output in fp32, the weights'
    # term of its bf16 bound (see BF16_ULP)
    spread_fn: Optional[Callable[[], torch.Tensor]] = None

    def bound(self):
        t_bytes = self.n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.n_ops / PEAK_OPS_PER_S[self.dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")


def ln_case(label, rows, feat, eps, dtype, gen) -> Case:
    x = (torch.randn(rows, feat, device=DEVICE, generator=gen) * 3 + 1)
    x = x.to(dtype)
    # the main path stores weights in bf16 (param_dtype="bfloat16")
    scale = (torch.rand(feat, device=DEVICE, generator=gen) + 0.5).to(dtype)
    bias = torch.randn(feat, device=DEVICE, generator=gen).to(dtype)
    elem = x.element_size()
    return Case(
        "layer_norm", label, dtype,
        lambda: layer_norm(x, scale, bias, eps),
        lambda: layer_norm_plain(x, scale, bias, eps),
        lambda: F.layer_norm(x, (feat,), scale, bias, eps),
        n_bytes=2 * rows * feat * elem + 2 * feat * scale.element_size(),
        n_ops=8 * rows * feat)


def _sdpa(q, k, v, mask, D):
    """(N, S, H, D) tensors through the library's attention."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         scale=D ** -0.5)
    return out.transpose(1, 2)


def draw_lens(mode, N, lo, hi, gen, short=8):
    """Key lengths of a case: None; "reach", every row keeps its whole
    causal reach (lo .. hi); "edge", anything from 0 to hi with both ends
    present (a row of length 0 keeps no key at all); "short", 0 to
    ``short`` (inside a prefix of that length) with both ends present."""
    if mode is None:
        return None
    top = short if mode == "short" else hi
    lens = torch.randint(lo if mode == "reach" else 0, top + 1, (N,),
                         device=DEVICE, generator=gen, dtype=torch.int32)
    if mode != "reach":
        lens[0], lens[-1] = 0, top
    return lens


def attn_case(label, N, Sq, Sk, H, D, causal, lens_mode, dtype, gen, P=0,
              G=1) -> Case:
    """Masked attention over Sk keys. With P > 0 the prefix form: the first
    P keys of row n are the (N // G, P, H, D) prefix of image n // G, read
    once per image (n_bytes counts them so), and the library yardstick is
    the broadcast and concatenation the caller would otherwise make, then
    the library's attention; "sdpa_ms" times that attention alone on the
    concatenated keys."""
    def draw(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen).to(dtype)

    Ss, B = Sk - P, N // G
    q, k, v = draw(N, Sq, H, D), draw(N, Ss, H, D), draw(N, Ss, H, D)
    prefix = (draw(B, P, H, D), draw(B, P, H, D)) if P else None
    lens = draw_lens(lens_mode, N, Sk - Sq + 1, Sk, gen)
    keep = attention_keep_mask(lens, N, Sq, Sk, causal, q.device)
    kept = int(keep.sum().item()) * H
    mask = keep if (causal or lens is not None) else None
    # the library's (N, H, S, D) layout, made once outside the timing
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa(k_all, v_all):
        return F.scaled_dot_product_attention(qt, k_all, v_all,
                                              attn_mask=mask, scale=D ** -0.5)

    pkt, pvt = (t.transpose(1, 2).contiguous() for t in prefix or (q, q))

    def cat(p, own):  # each image's prefix before its rows' keys
        if not P:
            return own
        p = p[:, None].expand(B, G, H, P, D).reshape(N, H, P, D)
        return torch.cat([p, own], dim=2)

    k_all, v_all = cat(pkt, kt), cat(pvt, vt)
    also = {"sdpa_ms": lambda: sdpa(k_all, v_all)} if P else {}

    def spread():  # fp32 weights, not rounded, times |v|
        pre = (prefix[0].float(), prefix[1].float().abs()) if P else None
        return masked_attention_plain(q.float(), k.float(), v.float().abs(),
                                      lens, causal, pre)

    elem = q.element_size()
    return Case(
        "masked_attention", label, dtype,
        lambda: masked_attention(q, k, v, lens, causal, prefix),
        lambda: masked_attention_plain(q, k, v, lens, causal, prefix),
        lambda: sdpa(cat(pkt, kt), cat(pvt, vt)),
        n_bytes=(2 * N * Sq + 2 * N * Ss + 2 * B * P) * H * D * elem
        + (4 * N if lens is not None else 0),
        n_ops=4 * kept * D, also=also, spread_fn=spread)


def with_out_case(label, N, Sq, Sk, H, D, E, dtype, gen, causal=True,
                  lens_mode="reach", P=0, G=1, bias_dtype=None) -> Case:
    """Suffix-over-prefix attention (causal, with key lengths, on the main
    path), then the output projection. Weights and bias in the tensors'
    type, as the main path stores them, unless ``bias_dtype`` says
    otherwise. With P > 0 the prefix form: the first P of the Sk keys of
    row n are the (N // G, P, H, D) prefix of image n // G, read once per
    image (n_bytes counts them so), and the library yardstick is the
    broadcast and concatenation the caller would otherwise make, then the
    library's attention and ``F.linear``."""
    def draw(*shape, std=1.0):
        return (torch.randn(*shape, device=DEVICE, generator=gen)
                * std).to(dtype)

    Ss, B = Sk - P, N // G
    q, k, v = draw(N, Sq, H, D), draw(N, Ss, H, D), draw(N, Ss, H, D)
    prefix = (draw(B, P, H, D), draw(B, P, H, D)) if P else None
    wo, bo = draw(E, H * D, std=0.03), draw(E, std=0.1)
    if bias_dtype is not None:
        bo = bo.to(bias_dtype)
    lens = draw_lens(lens_mode, N, Sk - Sq + 1, Sk, gen)
    keep = attention_keep_mask(lens, N, Sq, Sk, causal, q.device)
    kept = int(keep.sum().item()) * H

    def cat(p, own):  # each image's prefix before its rows' keys
        if not P:
            return own
        p = p[:, None].expand(B, G, P, H, D).reshape(N, P, H, D)
        return torch.cat([p, own], dim=1)

    def library():
        ctx = _sdpa(q, cat(prefix[0], k) if P else k,
                    cat(prefix[1], v) if P else v, keep, D)
        return F.linear(ctx.reshape(N, Sq, H * D), wo, bo.to(dtype))

    elem = q.element_size()
    return Case(
        "attention_with_out", label, dtype,
        lambda: attention_with_out(q, k, v, wo, bo, lens, causal, prefix),
        lambda: attention_with_out_plain(q, k, v, wo, bo, lens, causal,
                                         prefix),
        library,
        n_bytes=((N * Sq + 2 * N * Ss + 2 * B * P) * H * D + N * Sq * E
                 + E * H * D) * elem + E * bo.element_size()
        + (4 * N if lens is not None else 0),
        n_ops=4 * kept * D + 2 * N * Sq * H * D * E)


def block_case(label, N, S, E, H, causal, lens_mode, dtype, gen,
               bias_dtype=None) -> Case:
    """A residual attention block; biases in the tensors' type, as the main
    path stores them, unless ``bias_dtype`` says otherwise."""
    def draw(*shape, std=1.0):
        return (torch.randn(*shape, device=DEVICE, generator=gen)
                * std).to(dtype)

    D = E // H
    x, res = draw(N, S, E), draw(N, S, E)
    params = [t for _ in range(4) for t in (draw(E, E, std=0.03),
                                            draw(E, std=0.1))]
    if bias_dtype is not None:
        params = [t.to(bias_dtype) if t.dim() == 1 else t for t in params]
    wq, bq, wk, bk, wv, bv, wo, bo = params
    lens = draw_lens(lens_mode, N, 1, S, gen)
    keep = attention_keep_mask(lens, N, S, S, causal, x.device)
    kept = int(keep.sum().item()) * H
    mask = keep if (causal or lens is not None) else None

    def library():
        q, k, v = (F.linear(x, w, b.to(dtype)).view(N, S, H, D)
                   for w, b in ((wq, bq), (wk, bk), (wv, bv)))
        ctx = _sdpa(q, k, v, mask, D).reshape(N, S, E)
        return F.linear(ctx, wo, bo.to(dtype)) + res

    elem = x.element_size()
    return Case(
        "attention_block", label, dtype,
        lambda: attention_block(x, res, *params, lens, heads=H,
                                causal=causal),
        lambda: attention_block_plain(x, res, *params, lens, heads=H,
                                      causal=causal),
        library,
        n_bytes=(3 * N * S * E + 4 * E * E) * elem + 4 * E * bq.element_size()
        + (4 * N if lens is not None else 0),
        n_ops=8 * N * S * E * E + 4 * kept * D)


def main_path_cases(shape, dtype, gen) -> List[Case]:
    """Every call shape free captioning gives the kernels; the first of
    each kernel is the one that dominates a Gibbs step under its
    ``attn_impl``. The last block case is the full-row text pass the engine
    makes without prefix K/V (``kv_chunk_size=0``)."""
    B, kc_rows, P, S = shape["B"], shape["rows"], shape["P"], shape["S_suf"]
    L = shape["bert_len"]
    return [
        ln_case("text suffix chunk", kc_rows * S, 512, 1e-5, dtype, gen),
        ln_case("text pooled rows", kc_rows, 512, 1e-5, dtype, gen),
        ln_case("bert rows", B * L, 768, 1e-12, dtype, gen),
        ln_case("vision rows", B * 50, 768, 1e-5, dtype, gen),
        attn_case("text suffix chunk", kc_rows, S, P + S, 8, 64, True,
                  "reach", dtype, gen, P=P, G=kc_rows // B),
        attn_case("text pooled (Sq=1)", kc_rows, 1, P + S, 8, 64, False,
                  "reach", dtype, gen, P=P, G=kc_rows // B),
        attn_case("text prompt prefix", B, P, P, 8, 64, True, None, dtype,
                  gen),
        attn_case("bert full rows", B, L, L, 12, 64, False, "reach", dtype,
                  gen),
        attn_case("bert pooled (Sq=1)", B, 1, L, 12, 64, False, "reach",
                  dtype, gen),
        attn_case("vision", B, 50, 50, 12, 64, False, None, dtype, gen),
        with_out_case("text suffix chunk, prefix form", kc_rows, S, P + S, 8,
                      64, 512, dtype, gen, P=P, G=kc_rows // B),
        with_out_case("text suffix chunk, concatenated", kc_rows, S, P + S,
                      8, 64, 512, dtype, gen),
        block_case("bert rows", B, L, 768, 12, False, None, dtype, gen),
        block_case("vision rows", B, 50, 768, 12, False, None, dtype, gen),
        block_case("text full-row chunk", kc_rows, P + S, 512, 8, True,
                   "reach", dtype, gen),
    ]


def pruned_path_cases(shape, dtype, gen) -> List[Case]:
    """The call shapes the pruned tiers add (phase 4's reads): at the
    flagship's B=512 a row chunk holds one candidate an image (G = 1), in
    the 6-layer stage-1 over the pre-cut's 32 and in the 3 survivors' full
    encode alike; the hybrid's B=32 survivors fit one chunk (G = 5); G = 3
    is the survivors' group when one chunk holds them; BERT at B=512; the
    truncated tower's LayerNorms, rows like the full tower's."""
    P, S, L = shape["P"], shape["S_suf"], shape["bert_len"]
    B = FLAGSHIP["batch"]
    return [
        ln_case("flagship stage-1 chunk (6 of 12 layers)", B * S, 512, 1e-5,
                dtype, gen),
        ln_case("flagship stage-1 pooled rows", B, 512, 1e-5, dtype, gen),
        ln_case("flagship bert rows", B * L, 768, 1e-12, dtype, gen),
        attn_case("flagship chunk, G=1", B, S, P + S, 8, 64, True, "reach",
                  dtype, gen, P=P, G=1),
        attn_case("flagship pooled (Sq=1), G=1", B, 1, P + S, 8, 64, False,
                  "reach", dtype, gen, P=P, G=1),
        attn_case("survivors, G=3", 3 * B, S, P + S, 8, 64, True, "reach",
                  dtype, gen, P=P, G=3),
        attn_case("hybrid survivors, G=5", 5 * HYBRID["batch"], S, P + S, 8,
                  64, True, "reach", dtype, gen, P=P, G=5),
        attn_case("flagship bert rows", B, L, L, 12, 64, False, "reach",
                  dtype, gen),
        with_out_case("flagship chunk, G=1", B, S, P + S, 8, 64, 512, dtype,
                      gen, P=P, G=1),
        block_case("flagship bert rows", B, L, 768, 12, False, None, dtype,
                   gen),
    ]


def time_events_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean time of one call of ``fn`` over ``reps`` calls between two CUDA
    events, after a warm-up: for work that allocates as it runs (a sort's
    scratch), which a CUDA graph may not capture."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# the batches the top-k is timed at: the main path's and the hybrid's, the
# reference's window for the two-stage form (128 <= B < 256), the flagship's
TOPK_BATCHES = (32, 64, 128, 256, 512)


def phase_topk_chunk(gen) -> dict:
    """``exact_topk_2stage`` (blocks of ``topk_chunk`` = 2048) against one
    stable sort over the whole row, which it falls back to, at the main
    path's vocabulary and k and each batch of TOPK_BATCHES: equal ids, and
    each one's time. The engine takes the two-stage form from
    ``energies.TOPK_2STAGE_MIN_ROWS`` rows up."""
    V, k = 30522, MAIN["top_k"]
    ms = {}
    for B in TOPK_BATCHES:
        logits = torch.randn(B, V, device=DEVICE, generator=gen) * 4
        probs = energies.masked_lm_probs(
            logits, torch.ones(V, device=DEVICE), 0.1)
        one = energies.top_k(probs, k)
        two = energies.exact_topk_2stage(probs, k, chunk=2048)
        same = bool(torch.equal(one[1], two[1])
                    and torch.equal(one[0], two[0]))
        ms[B] = {
            "stable sort": time_events_ms(lambda: energies.top_k(probs, k),
                                          50),
            "two-stage": time_events_ms(
                lambda: energies.exact_topk_2stage(probs, k, chunk=2048), 50),
            "torch.topk (no tie order)": time_events_ms(
                lambda: torch.topk(probs, k), 50)}
        ties = int((probs == 0).sum())
        say(f"topk_chunk [B={B} V={V} k={k}, {ties} of {B * V} "
            f"probabilities tie at 0]: ids equal={same}; "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in ms[B].items()))
        if not same:
            raise AssertionError(f"exact_topk_2stage differs from the one "
                                 f"sort at B={B}")
    return ms


def edge_cases(dtype, gen) -> List[Case]:
    """Ragged shapes of the three attention kernels, checked against the
    plain versions and not timed: a row count that the kernels' row groups
    do not divide, key lengths from 0 (no key kept: a uniform softmax) to
    all, Sk = Sq, one query row, sequences of 1, 17, 50 and 100 rows (one to
    seven 16-row tiles), causal and not, and head widths on both sides of
    the tensor-core kernels' conditions (masked attention: D a multiple of
    16; the two fused kernels: D of 16, 32 or 64 and E a multiple of 16,
    attention_with_out also at most 64 query rows). Masked attention also
    in its prefix form: rows that change image inside a block's range, an
    image per row (G = 1), heads split over several blocks, key lengths
    inside the prefix. The fused kernels also: fewer than 64 rows in all,
    E = 512 and 768, biases in fp32 and in bf16, and attention_with_out in
    its prefix form (images changing inside a group, G = 1, Sq = 1, two
    passes over the heads at E = 768, two heads a 64-column chunk at D =
    32)."""
    return [
        attn_case("prefix, N=801 G=3 (images change mid-block)", 801, 16, 24,
                  8, 64, True, "edge", dtype, gen, P=8, G=3),
        attn_case("prefix, G=1", 150, 16, 24, 8, 64, True, "edge", dtype,
                  gen, P=8, G=1),
        attn_case("prefix, N=12 G=3 (heads split over blocks)", 12, 16, 24,
                  8, 64, True, "edge", dtype, gen, P=8, G=3),
        attn_case("prefix, lens 0..P", 20, 16, 24, 8, 64, True, "short",
                  dtype, gen, P=8, G=4),
        attn_case("prefix, Sq=1", 40, 1, 24, 8, 64, False, "edge", dtype,
                  gen, P=8, G=5),
        attn_case("prefix, P=20 Sq=Ss=30 (four key tiles)", 6, 30, 50, 4,
                  64, True, "edge", dtype, gen, P=20, G=2),
        attn_case("Sk=Sq, no prefix", 9, 16, 16, 8, 64, True, None, dtype,
                  gen),
        attn_case("S=50, lens 0..S", 3, 50, 50, 4, 64, False, "edge", dtype,
                  gen),
        attn_case("S=100 causal", 2, 100, 100, 2, 64, True, "edge", dtype,
                  gen),
        attn_case("prefix, D=16 (tensor-core side)", 6, 16, 20, 2, 16, True,
                  "edge", dtype, gen, P=4, G=3),
        attn_case("prefix, D=24 (scalar side)", 6, 16, 20, 2, 24, True,
                  "edge", dtype, gen, P=4, G=3),
        attn_case("D=18 (scalar, a value a load)", 5, 5, 9, 2, 18, True,
                  "edge", dtype, gen),
        with_out_case("N=7, lens 0..Sk", 7, 16, 24, 8, 64, 512, dtype, gen,
                      lens_mode="edge"),
        with_out_case("not causal, lens 0..Sk", 6, 16, 24, 8, 64, 512, dtype,
                      gen, causal=False, lens_mode="edge"),
        with_out_case("Sk=Sq, no lens", 5, 16, 16, 8, 64, 512, dtype, gen,
                      lens_mode=None),
        with_out_case("Sq=1", 9, 1, 24, 8, 64, 512, dtype, gen, causal=False,
                      lens_mode="edge"),
        with_out_case("N=300 Sq=8 Sk=12 (8 rows n a group)", 300, 8, 12, 8,
                      64, 512, dtype, gen, lens_mode="edge"),
        with_out_case("Sq=40 Sk=77", 3, 40, 77, 2, 32, 64, dtype, gen,
                      lens_mode="edge"),
        with_out_case("Sq=100 Sk=128 (scalar side: over 64 query rows)", 2,
                      100, 128, 2, 16, 48, dtype, gen),
        with_out_case("D=16 (tensor-core side)", 5, 16, 24, 2, 16, 48, dtype,
                      gen, lens_mode="edge"),
        with_out_case("D=24 (scalar side)", 5, 16, 24, 2, 24, 40, dtype, gen,
                      lens_mode="edge"),
        with_out_case("prefix, N=801 G=3 (rows no multiple of 64)", 801, 16,
                      24, 8, 64, 512, dtype, gen, lens_mode="edge", P=8, G=3),
        with_out_case("prefix, N=3 (48 query rows, under 64)", 3, 16, 24, 8,
                      64, 512, dtype, gen, P=8, G=3),
        with_out_case("prefix, G=1, lens 0..P", 20, 16, 24, 8, 64, 512, dtype,
                      gen, lens_mode="short", P=8, G=1),
        with_out_case("prefix, Sq=1, not causal", 40, 1, 24, 8, 64, 512,
                      dtype, gen, causal=False, lens_mode="edge", P=8, G=5),
        with_out_case("prefix, E=768 (two passes over the heads)", 50, 16, 24,
                      8, 64, 768, dtype, gen, lens_mode="edge", P=8, G=25),
        with_out_case("prefix, bo fp32", 100, 16, 24, 8, 64, 512, dtype, gen,
                      P=8, G=25, bias_dtype=torch.float32),
        with_out_case("prefix, bo bf16", 100, 16, 24, 8, 64, 512, dtype, gen,
                      P=8, G=25, bias_dtype=torch.bfloat16),
        with_out_case("prefix, D=32 P=20 Sq=Ss=30", 6, 30, 50, 4, 32, 128,
                      dtype, gen, lens_mode="edge", P=20, G=2),
        with_out_case("prefix, D=24 (scalar side)", 6, 16, 20, 2, 24, 40,
                      dtype, gen, lens_mode="edge", P=4, G=3),
        block_case("N=7, lens 0..S", 7, 15, 768, 12, False, "edge", dtype,
                   gen),
        block_case("causal, N=7, lens 0..S", 7, 15, 768, 12, True, "edge",
                   dtype, gen),
        block_case("S=1", 5, 1, 128, 2, False, None, dtype, gen),
        block_case("S=17 causal", 5, 17, 128, 4, True, "edge", dtype, gen),
        block_case("S=17", 5, 17, 128, 4, False, None, dtype, gen),
        block_case("S=100 causal", 2, 100, 64, 2, True, "edge", dtype, gen),
        block_case("D=16 (tensor-core side)", 5, 15, 64, 4, False, "edge",
                   dtype, gen),
        block_case("D=24 (scalar side)", 5, 15, 96, 4, False, "edge", dtype,
                   gen),
        block_case("N=3 (45 rows, under 64)", 3, 15, 768, 12, False, "edge",
                   dtype, gen),
        block_case("E=512 S=24 causal, N=23", 23, 24, 512, 8, True, "edge",
                   dtype, gen),
        block_case("S=50, N=5, lens 0..S", 5, 50, 768, 12, False, "edge",
                   dtype, gen),
        block_case("biases fp32", 9, 15, 768, 12, False, None, dtype, gen,
                   bias_dtype=torch.float32),
        block_case("biases bf16", 9, 15, 768, 12, False, None, dtype, gen,
                   bias_dtype=torch.bfloat16),
    ]


def readings(case: Case):
    """One call of the kernel against one of its plain version on the same
    inputs: (largest absolute error, largest error in bf16 ulps of
    max(|plain|, 1), largest share of masked attention's bf16 bound or
    None)."""
    got = case.kernel_fn()
    want = case.plain_fn()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())  # NaN fails every comparison
    if case.dtype != torch.bfloat16:
        return err, None, None
    unit = BF16_ULP * want.float().abs().clamp(min=1.0)
    worst = float((diff / unit).max())
    if case.spread_fn is None:
        return err, worst, None
    return err, worst, float((diff / (unit + BF16_ULP * case.spread_fn()))
                             .max())


def check_case(case: Case):
    """(within tolerance, largest absolute error, the tolerance)."""
    err, worst, share = readings(case)
    if share is not None:
        return share <= 1.0, err, (
            f"a bf16 step of max(|plain|,1) and of each weight, {share:.3g}"
            f" of it; {worst:.3g} ulp")
    if worst is not None:
        ulps = BF16_ULPS[case.kernel]
        return worst <= ulps, err, (f"{ulps} bf16 ulp of max(|plain|,1), "
                                    f"worst {worst:.3g}")
    return err <= FP32_ATOL, err, f"{FP32_ATOL:g} abs"


def sweep_masked_attention(shape, n_seeds: int) -> dict:
    """Phase 2's bf16 masked-attention cases (the pruned tiers' shapes and
    the edge cases) on ``n_seeds`` fresh draws each: how many outputs lie
    more than one bf16 ulp of max(|plain|, 1) from the plain version and
    the worst readings in ulps and as a share of the bound. Fails if a draw
    exceeds the bound."""
    n = over_ulp = 0
    worst = share = 0.0
    where = ""
    for seed in range(1, n_seeds + 1):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        cases = (pruned_path_cases(shape, torch.bfloat16, gen)
                 + edge_cases(torch.bfloat16, gen))
        for case in cases:
            if case.kernel != "masked_attention":
                continue
            _, w, sh = readings(case)
            n += 1
            over_ulp += w > 1.0
            if sh > share:
                where = f"{case.label}, seed {seed}"
            worst, share = max(worst, w), max(share, sh)
    say(f"masked_attention sweep [bf16, {n_seeds} draws of each pruned-path "
        f"and edge case, {n} calls]: {over_ulp} of {n} beyond one ulp of "
        f"max(|plain|,1), worst {worst:.4f} ulp; worst share of the bound "
        f"{share:.4f} ({where})")
    if not share <= 1.0:
        raise AssertionError("masked_attention beyond its bf16 bound in the "
                             "sweep")
    return dict(calls=n, over_ulp=over_ulp, worst_ulp=worst, share=share)


# the kernels whose wrappers encode TMA maps on the host at every call
HOST_TIMED = ("attention_with_out", "attention_block")
HOST_CALLS = 200


def host_us(fn: Callable[[], object], calls: int = HOST_CALLS) -> float:
    """Mean wall time of one call of ``fn`` over ``calls`` calls made
    without a synchronisation (after a warm-up): what the host spends to
    check, encode and enqueue a launch, while the card runs the earlier
    ones."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return host


def phase_kernels(shape) -> dict:
    """Returns, per kernel, the numbers of its dominant bf16 case."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    summary = {}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).replace("torch.", "")
        for case in main_path_cases(shape, dtype, gen):
            ok, err, tol = check_case(case)
            ms = time_ms(case.kernel_fn, 50)
            plain_ms = time_ms(case.plain_fn, 20)
            lib_ms = time_ms(case.library_fn, 50)
            also = {name: time_ms(fn, 50) for name, fn in case.also.items()}
            bound_ms, bound_by = case.bound()
            say(f"kernel {case.kernel} [{case.label}, {dt}] "
                f"max_abs_err={err:.3g} (tol {tol}) {'ok' if ok else 'FAIL'}"
                f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                f"{lib_ms:.4f}"
                + "".join(f" {name}={t:.4f}" for name, t in also.items())
                + f" bound_ms={bound_ms:.4f} ({bound_by})")
            if not ok:
                failures.append(f"{case.kernel} [{case.label}, {dt}]")
            if dtype == torch.bfloat16 and case.kernel in HOST_TIMED:
                say(f"host {case.kernel} [{case.label}, {dt}]: "
                    f"{host_us(case.kernel_fn):.2f} us a call ({HOST_CALLS} "
                    f"calls, no sync) against {ms * 1e3:.2f} us of device "
                    f"time (CUDA graph)")
            if dtype == torch.bfloat16 and case.kernel not in summary:
                summary[case.kernel] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                    case=case.label, **also)
        for case in pruned_path_cases(shape, dtype, gen):
            ok, err, tol = check_case(case)
            ms = time_ms(case.kernel_fn, 20)
            plain_ms = time_ms(case.plain_fn, 10)
            bound_ms, bound_by = case.bound()
            say(f"pruned-path kernel {case.kernel} [{case.label}, {dt}] "
                f"max_abs_err={err:.3g} (tol {tol}) {'ok' if ok else 'FAIL'}"
                f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
                f"{bound_ms:.4f} ({bound_by})")
            if not ok:
                failures.append(f"{case.kernel} [pruned: {case.label}, {dt}]")
        for case in edge_cases(dtype, gen):
            ok, err, tol = check_case(case)
            say(f"edge case {case.kernel} [{case.label}, {dt}] "
                f"max_abs_err={err:.3g} (tol {tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{case.kernel} [edge: {case.label}, {dt}]")
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + ", ".join(failures))
    sweep_masked_attention(shape, SWEEP_SEEDS)
    phase_topk_chunk(gen)
    return summary


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------


def run_args(**kw):
    return dict(prompt=MAIN["prompt"], temperature=0.1, alpha=0.02, beta=2.0,
                **kw)


def seeded_pixels(cap: Captioner, n: int, seed: int = 0) -> np.ndarray:
    v = cap.clip_model.config.vision
    return np.random.RandomState(seed).rand(
        n, v.image_size, v.image_size, v.num_channels).astype(np.float32)


def same_images(cpu: Captioner, gpu: Captioner, pixels, label: str):
    """The CPU's image embeddings, after checking the card's against them;
    returns (embeddings, largest difference)."""
    emb_cpu = cpu.encode_images(pixels)
    emb_err = float((emb_cpu - gpu.encode_images(pixels).cpu()).abs().max())
    if emb_err > AGREE_COS_ATOL:
        raise AssertionError(f"image embeddings differ by {emb_err:.3g} "
                             f"({label})")
    return emb_cpu, emb_err


def tiny_pair(cfg: ConzicConfig, text_layers: int = 2):
    """A tiny captioner on the CPU (its CLIP text tower ``text_layers``
    deep), its copy on the card (one config object, read by both at run
    time), and the CPU's embeddings of three seeded images."""
    clip_cfg = CLIPConfig.tiny()
    clip_cfg = dataclasses.replace(clip_cfg, text=dataclasses.replace(
        clip_cfg.text, num_layers=text_layers))
    cpu = Captioner.from_random(config=cfg, clip_config=clip_cfg, seed=0,
                                device="cpu")
    gpu = Captioner(copy.deepcopy(cpu.bert_model),
                    copy.deepcopy(cpu.clip_model), cpu.wp, cpu.bpe, cfg,
                    device=DEVICE)
    emb, err = same_images(cpu, gpu, seeded_pixels(cpu, 3), cfg.attn_impl)
    return cpu, gpu, emb, err


def compare_runs(a, b):
    """(caption ids identical, control scores equal, largest cosine
    difference) of a CPU run and a card run."""
    same = (bool((a.iter_ids == b.iter_ids).all())
            and bool((a.best_ids == b.best_ids).all()))
    cos_err = float(np.abs(np.asarray(a.clip_score_sequence)
                           - np.asarray(b.clip_score_sequence)).max())
    return same, bool(np.array_equal(a.iter_ctl, b.iter_ctl)), cos_err


def phase_agreement() -> None:
    """A tiny fp32 captioner through the kernels == the same on the CPU,
    under every attn_impl: the four orders with prompt-prefix K/V, and the
    sequential order once more with every candidate row in full
    (kv_chunk_size=0), where the block kernel takes the causal text rows."""
    for impl in KERNEL_IMPLS:
        cfg = ConzicConfig(dtype="float32", attn_impl=impl)
        cpu, gpu, emb_cpu, emb_err = tiny_pair(cfg)
        runs = [(order, 16) for order in ("sequential", "shuffle", "span",
                                          "parallel")] + [("sequential", 0)]
        for order, kv_chunk in runs:
            cfg.kv_chunk_size = kv_chunk  # read at run time by both
            args = run_args(max_len=5, top_k=16, max_iter=2, order=order,
                            n_samples=2)
            a = cpu.run(emb_cpu, rng=np.random.RandomState(7), **args)
            b = gpu.run(emb_cpu, rng=np.random.RandomState(7), **args)
            same, _, cos_err = compare_runs(a, b)
            say(f"agreement [{impl}, {order}, kv_chunk_size={kv_chunk}]: "
                f"caption ids identical={same} max cosine diff="
                f"{cos_err:.3g} (tol {AGREE_COS_ATOL:g}) image embed diff="
                f"{emb_err:.3g}")
            if not same or cos_err > AGREE_COS_ATOL:
                raise AssertionError(f"GPU and CPU runs differ ({impl}, "
                                     f"{order}, kv_chunk_size={kv_chunk})")


def phase_control_agreement() -> None:
    """Controlled tiny fp32 runs, card against CPU: identical caption ids
    and equal control scores in every case of CONTROL_CASES."""
    cfg = ConzicConfig(dtype="float32")
    cpu, gpu, emb, _ = tiny_pair(cfg)
    for label, cfg_kw, run_kw in CONTROL_CASES:
        for knob, value in cfg_kw.items():
            setattr(cfg, knob, value)
        args = run_args(max_len=5, top_k=16, max_iter=2, n_samples=2,
                        gamma=GAMMA, **run_kw)
        try:
            a = cpu.run(emb, rng=np.random.RandomState(7), **args)
            b = gpu.run(emb, rng=np.random.RandomState(7), **args)
        finally:
            cfg.bridge_mode = cfg.ctl_mode = "table"
        same, same_ctl, cos_err = compare_runs(a, b)
        say(f"agreement [control: {label}]: caption ids identical={same} "
            f"iter_ctl equal={same_ctl} (mean {float(a.iter_ctl.mean()):.4f})"
            f" max cosine diff={cos_err:.3g} (tol {AGREE_COS_ATOL:g})")
        if not (same and same_ctl) or cos_err > AGREE_COS_ATOL:
            raise AssertionError(f"GPU and CPU controlled runs differ "
                                 f"({label})")


def own_tables_line(cpu: Captioner, gpu: Captioner) -> None:
    """The card's own pruned-tier tables against the CPU's, fp32, 2 of 4
    layers and the tower pre-cut's 1 (information: the agreement runs give
    the card the CPU's)."""
    cfg = cpu.cfg  # one config object: both read it
    saved = {k: getattr(cfg, k) for k in TOWER_PRECUT}
    for knob, value in TOWER_PRECUT.items():
        setattr(cfg, knob, value)
    for cap in (cpu, gpu):
        cap._ensure_word_embeds()
        cap._ensure_stage1_calibration()
    for knob, value in saved.items():
        setattr(cfg, knob, value)
    diff = {name: float((gpu.tables[name].cpu() - cpu.tables[name]).abs()
                        .max()) for name in PRUNE_TABLES}
    say(f"tables [card's own vs the CPU's, fp32, tiny]: max |diff| "
        + ", ".join(f"{n} {d:.3g}" for n, d in diff.items())
        + f"; held-out cosine card {gpu.stage1_calib_cos:.6f} CPU "
        f"{cpu.stage1_calib_cos:.6f}, pre-cut card "
        f"{gpu.stage1_pc_calib_cos:.6f} CPU {cpu.stage1_pc_calib_cos:.6f}")
    for cap in (cpu, gpu):
        for name in PRUNE_TABLES:
            cap.tables.pop(name)
        cap.stage1_key = None


def phase_pruned_agreement() -> None:
    """The pruned and hybrid tiers on a tiny fp32 captioner whose text
    tower is 4 layers deep, card against CPU, in every case of
    PRUNED_CASES: identical caption ids and control scores. The CPU builds
    the pruned-tier tables and the card runs on them."""
    pairs = {}
    for label, cfg_kw, run_kw, impl in PRUNED_CASES:
        if impl not in pairs:
            cfg = ConzicConfig(dtype="float32", attn_impl=impl,
                               verbose=False)
            pairs[impl] = (cfg, *tiny_pair(cfg, text_layers=4)[:3])
            if impl == "pallas":
                own_tables_line(*pairs[impl][1:3])
        cfg, cpu, gpu, emb = pairs[impl]
        saved = {k: getattr(cfg, k) for k in cfg_kw}
        for knob, value in cfg_kw.items():
            setattr(cfg, knob, value)
        args = run_args(max_len=5, top_k=16, max_iter=2, n_samples=2,
                        **run_kw)
        try:
            a = cpu.run(emb, rng=np.random.RandomState(7), **args)
            gpu.adopt_prune_tables(cpu.tables, cpu.stage1_key,
                                   cpu.stage1_calib_cos,
                                   cpu.stage1_pc_calib_cos)
            b = gpu.run(emb, rng=np.random.RandomState(7), **args)
        finally:
            for knob, value in saved.items():
                setattr(cfg, knob, value)
        same, same_ctl, cos_err = compare_runs(a, b)
        say(f"agreement [pruned: {label}, {impl}]: caption ids identical="
            f"{same} iter_ctl equal={same_ctl} max cosine diff={cos_err:.3g}"
            f" (tol {AGREE_COS_ATOL:g})")
        if not (same and same_ctl) or cos_err > AGREE_COS_ATOL:
            raise AssertionError(f"GPU and CPU pruned runs differ ({label}, "
                                 f"{impl})")


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two fp32 tensors in units in the last place."""
    a, b = a.float().contiguous(), b.float().contiguous()
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


def phase_energy_terms() -> None:
    """The control energy terms on the card against the CPU on the same
    seeded tie-heavy inputs at the main path's shape (B=32, k=200, a BERT
    row of 15). Terms whose arithmetic has one rounding per value (sums of
    table valences, a count times float32(1/T), products and sums) must be
    equal bit for bit; the softmax and exp terms print their distance.
    ``exp`` at 0 .. 77 is printed where card and CPU differ."""
    rng = np.random.RandomState(0)
    B, k, S, V, T = 32, 200, 15, 64, 12
    C = len(UNIVERSAL_TAGS) + 1
    rows = rng.randint(0, 8, size=(B, 1, S)).repeat(k, axis=1)
    ids = rng.randint(0, 8, size=(B, k))
    rows[np.arange(B), :, rng.randint(1, S - 1, size=B)] = ids
    arrays = dict(
        ids=ids, rows=rows,
        senti=rng.choice([0.0, 0.0, 0.5, 0.75, -0.5, -0.75],
                         size=V).astype(np.float32),
        pos=rng.randint(0, C - 1, size=V).astype(np.int32),
        template=(rng.rand(T, C) < 0.4).astype(np.float32),
        valid=(rng.rand(B, k, S - 2) < 0.8).astype(np.int32),
        lm=np.where(rng.rand(B, k) < 0.6, 0.0,
                    rng.rand(B, k)).astype(np.float32),
        clip=rng.rand(B, k).astype(np.float32) * 1e-2)

    def terms(dev):
        t = {n: torch.from_numpy(a).to(dev) for n, a in arrays.items()}
        out = {"sentiment_scores": energies.sentiment_scores(
            t["rows"], t["senti"], negative=False)}
        out["sentiment_scores (negative)"] = energies.sentiment_scores(
            t["rows"], t["senti"], negative=True)
        out["pos_accuracy"] = energies.pos_accuracy(
            t["rows"][:, :, 1:-1], t["pos"], t["template"], t["valid"])
        out["pos_accuracy / 0.1"] = energies._div_const(
            out["pos_accuracy"], 0.1)
        out["sentiment_probs"] = energies.sentiment_probs(
            out["sentiment_scores"])
        out["pos_probs"] = energies.pos_probs(out["pos_accuracy"])
        out["repeat_penalty"] = energies.repeat_penalty(t["ids"], t["rows"])
        if "ctl" in t:  # the combine of the CPU's control terms
            out["combine (inputs from the CPU)"] = energies.combine_scores(
                t["lm"], t["clip"], 0.02, 2.0, t["ctl"], GAMMA, t["pen"])
        return out

    first = terms("cpu")
    arrays["ctl"] = first["sentiment_probs"].numpy()
    arrays["pen"] = first["repeat_penalty"].numpy()
    cpu = terms("cpu")
    gpu = {n: v.cpu() for n, v in terms(DEVICE).items()}
    exact = ("sentiment_scores", "sentiment_scores (negative)",
             "pos_accuracy", "pos_accuracy / 0.1",
             "combine (inputs from the CPU)")
    bad = []
    for name in cpu:
        d = ulps(cpu[name], gpu[name])
        say(f"energy term [{name}]: card vs CPU {d} ulp"
            + (" (must be 0)" if name in exact else ""))
        if name in exact and d:
            bad.append(name)
    r = torch.arange(78, dtype=torch.float32)
    e_cpu, e_gpu = torch.exp(r), torch.exp(r.to(DEVICE)).cpu()
    diff = (e_cpu.view(torch.int32) != e_gpu.view(torch.int32)).nonzero()
    say(f"exp at 0..77, card vs CPU: {ulps(e_cpu, e_gpu)} ulp at most, "
        f"differing at {[int(i) for i in diff.flatten()]}")
    if bad:
        raise AssertionError(f"control terms differ on the card: {bad}")


def full_captioner(dtype: str, attn_impl: str = "pallas",
                   quant: str = "none") -> Captioner:
    cfg = ConzicConfig(dtype=dtype, param_dtype=dtype, attn_impl=attn_impl,
                       quant=quant, clip_len=MAIN["clip_len"],
                       clip_row_chunk=MAIN["row_chunk"],
                       kv_chunk_size=MAIN["kv_chunk"])
    return Captioner.from_random(
        config=cfg, bert_config=BertConfig(), clip_config=CLIPConfig(),
        seed=0, wp_vocab=make_fullsize_wordpiece_vocab(),
        clip_text_vocab_size=49408, device=DEVICE)


def main_shape(cap: Captioner) -> dict:
    """The kernels' call shapes on the main path, from the engine's spec."""
    L = MAIN["sentence_len"]
    init = cap.init_ids(MAIN["prompt"], L, 1)
    seed_len = init.shape[1] - L - 1
    chunks = cap._prefix_chunks("sequential", init, seed_len, L)
    spec = cap._spec(seed_len, L, MAIN["top_k"], chunks)
    if chunks is None or len(chunks) != 1:
        raise AssertionError(f"expected one prompt-only prefix chunk, got "
                             f"{chunks}")
    P = chunks[0][0]
    B, k = MAIN["batch"], MAIN["top_k"]
    kc = row_chunk_width(B, k, spec.clip_row_chunk)
    return dict(B=B, P=P, S_suf=spec.clip_len - P, rows=B * kc,
                n_chunks=k // kc, bert_len=spec.seq_len, seed_len=seed_len)


def check_output(cap: Captioner, res, iters: int, shape: dict,
                 B: int = MAIN["batch"]) -> None:
    L = MAIN["sentence_len"]
    ids = res.iter_ids
    if ids.shape != (iters, B, shape["bert_len"]):
        raise AssertionError(f"iter_ids shape {ids.shape}")
    init = cap.init_ids(MAIN["prompt"], L, B)
    seed = shape["seed_len"]
    if not ((ids[:, :, :seed] == init[:, :seed]).all()
            and (ids[:, :, -1] == init[:, -1]).all()):
        raise AssertionError("the prompt or [SEP] was overwritten")
    words = ids[:, :, seed:seed + L]
    if (words < 0).any() or (words >= cap.wp.vocab_size).any() or (
            words == cap.wp.mask_token_id).any():
        raise AssertionError("a slot holds an id outside the vocabulary "
                             "or is still [MASK]")
    cos = np.asarray(res.clip_score_sequence, np.float64)
    if not np.isfinite(cos).all() or np.abs(cos).max() > 1.0 + 1e-3:
        raise AssertionError("cosines are not finite values in [-1, 1]")
    if len(res.gen_texts_list) != iters + 1:
        raise AssertionError("expected one caption list per iteration "
                             "and the best list")


def n_row_chunks(B: int, k: int, row_chunk: int) -> int:
    """How many row chunks the engine cuts B x k candidate rows into."""
    return k // row_chunk_width(B, k, row_chunk)


def expected_launches(cap: Captioner, n_chunks: int, full_rows=False,
                      passes=None):
    """What the engine's structure gives for one generation of the main
    path, as (once per generation, per Gibbs step) launch counts.

    Per step: BERT (embeddings LN, 2 LN per layer, MLM head LN; one
    attention per layer, the last one pooled at the masked slot) and, per
    row chunk, the text tower over the cached prompt prefix (2 LN per layer
    and the final LN; one attention per layer, the last one pooled at the
    first EOS). Once per generation: the prompt prefix through the text
    tower, returning K/V, and the vision tower (pre-LN, 2 LN per layer,
    post-LN). A pooled layer and a pass that returns K/V always take the
    masked-attention kernel; the other passes take the kernel their
    attn_impl names. ``full_rows`` (the exact bridge): no prefix pass, and
    every chunk encodes whole candidate rows, whose attention blocks but
    the pooled last take ``attention_block`` under pallas_block and the
    masked-attention kernel otherwise. ``passes``: the step's text-tower
    passes as (depth, row chunks), in place of the full tower over
    ``n_chunks`` chunks: the pruned tiers' stage-1 runs the first layers
    (a truncated tower: its own final LN and pool, on the full tower's
    prefix K/V), stage 2 the full tower over the survivors."""
    nb = cap.bert_model.config.num_layers
    nt = cap.clip_model.config.text.num_layers
    nv = cap.clip_model.config.vision.num_layers
    impl = cap.cfg.attn_impl
    passes = passes or [(nt, n_chunks)]
    prefix = 0 if full_rows else 1
    once = {"layer_norm": prefix * (2 * nt + 1) + (2 * nv + 2),
            "masked_attention": prefix * nt + nv, "attention_with_out": 0,
            "attention_block": 0}
    step = {"layer_norm": 2 * nb + 2 + sum((2 * d + 1) * c
                                           for d, c in passes),
            "masked_attention": nb + sum(d * c for d, c in passes),
            "attention_with_out": 0, "attention_block": 0}

    def move(counts, n, to):
        counts["masked_attention"] -= n
        counts[to] += n

    if impl in XLA_IMPLS:  # the reference's einsum attention: no kernel
        once["masked_attention"] = step["masked_attention"] = 0
        return once, step

    suffix = sum((d - 1) * c for d, c in passes)  # all but the pooled last
    if impl == "pallas_out" and not full_rows:  # the suffix passes
        move(step, suffix, "attention_with_out")
    elif impl == "pallas_block":  # BERT's layers but the pooled last; vision
        move(step, nb - 1, "attention_block")
        move(once, nv, "attention_block")
        if full_rows:
            move(step, suffix, "attention_block")
    return once, step


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def phase_main(iters: int, cap: Captioner, shape: dict, pixels,
               label: Optional[str] = None) -> dict:
    """The main path once (after a one-iteration warm-up), its launch
    counts held against the engine's structure; ``label`` names the run in
    the lines (the attn_impl by default)."""
    B, L = MAIN["batch"], MAIN["sentence_len"]
    impl = label or cap.cfg.attn_impl
    args = run_args(max_len=L, top_k=MAIN["top_k"], order="sequential")
    # warm-up: cuBLAS handles, the allocator's pools
    cap.run(cap.encode_images(pixels), max_iter=1,
            rng=np.random.RandomState(42), **args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    embeds = cap.encode_images(pixels)
    res = cap.run(embeds, max_iter=iters, rng=np.random.RandomState(42),
                  **args)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = iters * L
    say(f"main path [{impl}]: B={B} k={MAIN['top_k']} sentence_len={L} "
        f"clip_len={MAIN['clip_len']} iterations={iters} "
        f"prefix P={shape['P']} suffix={shape['S_suf']} "
        f"row chunks={shape['n_chunks']}x{shape['rows']} rows")
    say(f"main path [{impl}]: {res.elapsed_s:.3f} s for {steps} Gibbs steps, "
        f"{B / res.elapsed_s:.4f} caps/s, {res.elapsed_s / steps:.5f} s "
        f"per Gibbs step, peak memory {peak_gib:.2f} GiB")
    once, per_step = expected_launches(cap, shape["n_chunks"])
    want = {n: once[n] + steps * per_step[n] for n in once}
    say(f"launches [{impl}]: {launches}; the engine's structure gives "
        f"{want}: {once} once per generation and {per_step} per Gibbs step")
    route = cap.cfg.attn_impl
    must = (["layer_norm"] if route in XLA_IMPLS else
            [n for n, r in ROUTE_OF.items() if r in ("pallas", route)])
    if any(launches[n] <= 0 for n in must):
        raise AssertionError(f"a kernel of the {impl} path never launched: "
                             f"{launches}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    check_output(cap, res, iters, shape)
    say(f"first caption [{impl}]: {res.gen_texts_list[-2][0]!r}")
    return dict(launches=launches, result=res, embeds=embeds,
                s_per_step=res.elapsed_s / steps)


def phase_controlled(iters: int, cap: Captioner, shape: dict, pixels,
                     free: dict) -> dict:
    """The main path again with sentiment-positive, then POS table control
    (gamma 5.0, the default template): caps/s, s per Gibbs step, the mean
    committed control score, and launch counts that must equal the free
    run's, since control changes no tower pass."""
    B, L = MAIN["batch"], MAIN["sentence_len"]
    steps = iters * L
    t = time.perf_counter()
    cap._ensure_ctl_tables()
    say(f"control tables built in {time.perf_counter() - t:.3f} s over "
        f"{cap.wp.vocab_size} tokens: "
        f"{'NLTK' if _nltk_available() else 'built-in'} tables, "
        f"{'NLTK' if _nltk_ready() else 'built-in'} sentence scoring "
        f"(exact mode); {int((cap.tables['senti'] != 0).sum())} tokens "
        f"carry a valence")
    args = run_args(max_len=L, top_k=MAIN["top_k"], order="sequential",
                    gamma=GAMMA)
    cap.run(free["embeds"], max_iter=1, rng=np.random.RandomState(42),
            ctl="sentiment", **args)  # warm-up
    out = {}
    for label, kw in (("sentiment positive", dict(ctl="sentiment")),
                      ("pos", dict(ctl="pos"))):
        torch.cuda.synchronize()
        reset_launches()
        res = cap.run(cap.encode_images(pixels), max_iter=iters,
                      rng=np.random.RandomState(42), **args, **kw)
        launches = read_launches()
        check_output(cap, res, iters, shape)
        say(f"controlled main path [{label} table, {cap.cfg.attn_impl}]: "
            f"{res.elapsed_s:.3f} s for {steps} Gibbs steps, "
            f"{B / res.elapsed_s:.4f} caps/s, {res.elapsed_s / steps:.5f} s "
            f"per Gibbs step (free: {free['s_per_step']:.5f}), mean "
            f"committed iter_ctl {float(res.iter_ctl.mean()):.4f}, last "
            f"iteration {float(res.iter_ctl[-1].mean()):.4f}")
        say(f"launches [{label} table]: {launches}; free captioning: "
            f"{free['launches']}")
        if launches != free["launches"]:
            raise AssertionError(f"controlled launch counts {launches} != "
                                 f"free {free['launches']}")
        say(f"first caption [{label}]: {res.gen_texts_list[-2][0]!r}")
        out[label] = dict(result=res, s_per_step=res.elapsed_s / steps)
    return out


def phase_exact(cap: Captioner, shape: dict, pixels, free: dict,
                controlled: dict) -> None:
    """One iteration of each exact mode at full width: sentiment control
    scored on the host (32 x 200 decoded candidates tagged a Gibbs step)
    and free captioning with the exact bridge (as many re-tokenizations a
    step, then full candidate rows through the text tower). s per Gibbs
    step beside the table mode's; launch counts by the engine's structure
    (full rows for the bridge)."""
    L = MAIN["sentence_len"]
    args = run_args(max_len=L, top_k=MAIN["top_k"], order="sequential",
                    gamma=GAMMA)
    runs = (("sentiment exact", "ctl_mode", dict(ctl="sentiment"),
             controlled["sentiment positive"]["s_per_step"]),
            ("exact bridge", "bridge_mode", {}, free["s_per_step"]))
    for label, knob, kw, table_s in runs:
        setattr(cap.cfg, knob, "exact")
        try:
            torch.cuda.synchronize()
            reset_launches()
            res = cap.run(cap.encode_images(pixels), max_iter=1,
                          rng=np.random.RandomState(42), **args, **kw)
            launches = read_launches()
        finally:
            setattr(cap.cfg, knob, "table")
        check_output(cap, res, 1, shape)
        once, per_step = expected_launches(cap, shape["n_chunks"],
                                           full_rows=knob == "bridge_mode")
        want = {n: once[n] + L * per_step[n] for n in once}
        say(f"exact mode [{label}, {cap.cfg.attn_impl}]: {res.elapsed_s:.3f} "
            f"s for {L} "
            f"Gibbs steps, {res.elapsed_s / L:.5f} s per Gibbs step (table "
            f"mode: {table_s:.5f}), mean committed iter_ctl "
            f"{float(res.iter_ctl.mean()):.4f}")
        say(f"launches [{label}]: {launches}; the engine's structure gives "
            f"{want}")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want} "
                                 f"({label})")
    host_breakdown(cap, res)


def pruned_passes(cap: Captioner, B: int, tier: dict):
    """The text-tower passes (depth, row chunks) of a pruned step of
    ``tier`` (config fields) at B images and the main path's k, and those
    of the hybrid's last, full sweep."""
    nt = cap.clip_model.config.text.num_layers
    k, rc = MAIN["top_k"], cap.cfg.clip_row_chunk
    passes = []
    if tier.get("prune_stage1") == "factorized":
        width = tier.get("prune_stage1_precut") or k
        if tier.get("prune_stage1_precut_mode") == "tower":
            passes.append((tier["prune_stage1_precut_layers"],
                           n_row_chunks(B, k, rc)))
        passes.append((tier["prune_stage1_layers"],
                       n_row_chunks(B, width, rc)))
    passes.append((nt, n_row_chunks(B, tier["prune_k"], rc)))
    return passes, [(nt, n_row_chunks(B, k, rc))]


def phase_pruned(iters: int, cap: Captioner, shape: dict,
                 profile: bool = False) -> dict:
    """The pruned tiers at full width, with the main path's other settings:
    the flagship at B=512 and the hybrid at B=32 over seeded images. Each
    builds its tables first, timed (the per-word embeddings of the whole
    vocabulary through the full tower; the factorized stage-1's fit, with
    its held-out cosine), runs one warm-up iteration, then ``iters``
    iterations: caps/s, s per Gibbs step, peak memory, and launch counts
    that must equal the engine's structure (the stage-1 tower over the
    pre-cut's rows at its depth, the survivors' full encode; the hybrid's
    last iteration the main path's). ``profile``: one flagship iteration
    under the profiler after the reads."""
    L, k = MAIN["sentence_len"], MAIN["top_k"]
    saved = {knob: getattr(cap.cfg, knob)
             for knob in {**FLAGSHIP["cfg"], **HYBRID["cfg"]}}
    v = cap.clip_model.config.vision
    out = {}
    try:
        for name, read in (("flagship", FLAGSHIP), ("hybrid", HYBRID)):
            B = read["batch"]
            cap.cfg.__dict__.update(saved)
            cap.cfg.__dict__.update(read["cfg"])
            pixels = np.random.RandomState(1).rand(
                B, v.image_size, v.image_size, v.num_channels).astype(
                    np.float32)
            embeds = cap.encode_images(pixels)
            built = {}
            for table, fn in (("word_embeds", cap._ensure_word_embeds),
                              ("stage1_wcal",
                               cap._ensure_stage1_calibration)):
                if table in cap.tables or (table == "stage1_wcal" and read[
                        "cfg"].get("prune_stage1") != "factorized"):
                    continue  # built by an earlier read, or not read
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                built[table] = time.perf_counter() - t
            calib = (f", held-out cosine {cap.stage1_calib_cos:.4f} at "
                     f"{cap.cfg.prune_stage1_layers} of "
                     f"{cap.clip_model.config.text.num_layers} layers"
                     if "stage1_wcal" in built else "")
            say(f"pruned tables [{name}]: built " + (", ".join(
                f"{t} in {sec:.3f} s" for t, sec in built.items())
                or "nothing (an earlier read did)")
                + f" ({cap.wp.vocab_size} tokens; 2048 calibration "
                f"captions){calib}")
            args = run_args(max_len=L, top_k=k, order="sequential")
            cap.run(embeds, max_iter=1, rng=np.random.RandomState(42),
                    **args)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            embeds = cap.encode_images(pixels)  # the vision pass counts
            res = cap.run(embeds, max_iter=iters,
                          rng=np.random.RandomState(42), **args)
            launches = read_launches()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            check_output(cap, res, iters, shape, B=B)
            passes, full = pruned_passes(cap, B, read["cfg"])
            once, per_step = expected_launches(cap, 0, passes=passes)
            _, per_full = expected_launches(cap, 0, passes=full)
            n_full = L if read["cfg"].get("prune_final_exact") else 0
            n_pruned = iters * L - n_full
            want = {n: once[n] + n_pruned * per_step[n]
                    + n_full * per_full[n] for n in once}
            steps = iters * L
            say(f"pruned [{name}]: B={B} k={k} {read['cfg']} sentence_len="
                f"{L} clip_len={MAIN['clip_len']} iterations={iters}; text "
                f"passes a pruned step (depth, row chunks) {passes}"
                + (f", the last iteration {full}" if n_full else ""))
            say(f"pruned [{name}]: {res.elapsed_s:.3f} s for {steps} Gibbs "
                f"steps, {B / res.elapsed_s:.4f} caps/s, "
                f"{res.elapsed_s / steps:.5f} s per Gibbs step, peak memory "
                f"{peak_gib:.2f} GiB; card {card_line()}")
            say(f"launches [pruned {name}]: {launches}; the engine's "
                f"structure gives {want}")
            if launches != want:
                raise AssertionError(f"pruned launch counts {launches} != "
                                     f"{want} ({name})")
            say(f"first caption [pruned {name}]: {res.gen_texts_list[-2][0]!r}")
            out[name] = dict(launches=launches, caps_s=B / res.elapsed_s,
                             s_per_step=res.elapsed_s / steps)
            if profile and name == "flagship":
                phase_profile(cap, embeds, "flagship")
    finally:
        cap.cfg.__dict__.update(saved)
    return out


def host_breakdown(cap: Captioner, res) -> None:
    """The host work of one exact-mode step, timed piece by piece on
    32 x 200 candidate rows made like a step's (the last iteration's rows,
    a seeded vocabulary id at one sentence slot)."""
    B, k, L = MAIN["batch"], MAIN["top_k"], MAIN["sentence_len"]
    rng = np.random.RandomState(0)
    rows = np.repeat(res.iter_ids[-1][:, None, 1:-1], k, axis=1)
    slot = rng.randint(0, L, size=B)
    rows[np.arange(B), :, res.iter_ids.shape[2] - L - 2 + slot] = \
        rng.randint(0, cap.wp.vocab_size, size=(B, k))
    rows = rows.reshape(B * k, -1)
    timed = {}

    def clock(name, fn):
        t = time.perf_counter()
        out = fn()
        timed[name] = time.perf_counter() - t
        return out

    texts = clock("decode", lambda: cap.wp.batch_decode(
        rows, skip_special_tokens=True))
    clock("word_tokenize", lambda: [ndiv.word_tokenize(x) for x in texts])
    clock("regex alone", lambda: [ndiv._WORD_RE.findall(x.lower())
                                  for x in texts])
    clock("sentiment scoring", lambda: batch_texts_sentiment_scores(texts))
    clock("BPE encode", lambda: cap.bpe.batch_encode(
        texts, max_length=MAIN["clip_len"], pad_to_max=True))
    say(f"exact mode host work on {B * k} candidates (s): "
        + ", ".join(f"{n} {t:.4f}" for n, t in timed.items()))


def phase_fp32(pixels, bf16_result, shape) -> None:
    """The same generation at fp32, one iteration: the share of caption
    ids equal to the bf16 run's first iteration (information only)."""
    cap = full_captioner("float32")
    L = MAIN["sentence_len"]
    res = cap.run(cap.encode_images(pixels), max_iter=1,
                  rng=np.random.RandomState(42),
                  **run_args(max_len=L, top_k=MAIN["top_k"],
                             order="sequential"))
    check_output(cap, res, 1, shape)
    seed = shape["seed_len"]
    a = bf16_result.iter_ids[0, :, seed:seed + L]
    b = res.iter_ids[0, :, seed:seed + L]
    say(f"fp32 vs bf16, first iteration: {float((a == b).mean()):.4f} of "
        f"caption ids agree ({res.elapsed_s:.3f} s at fp32)")


def phase_trained() -> None:
    """trained_tiny/ through the port's own checkpoint reader, on the card
    and on the CPU, fp32: sentiment-positive and -negative table control on
    four seeded images give identical ids and control scores."""
    cfg = ConzicConfig(dtype="float32")
    gpu = Captioner.from_tiny_dir(cfg, TRAINED_TINY, device=DEVICE)
    cpu = Captioner.from_tiny_dir(cfg, TRAINED_TINY, device="cpu")
    emb, emb_err = same_images(cpu, gpu, seeded_pixels(cpu, 4, seed=1),
                               "trained_tiny")
    for negative in (False, True):
        label = "negative" if negative else "positive"
        args = run_args(max_len=8, top_k=64, max_iter=2, gamma=GAMMA,
                        ctl="sentiment", negative=negative,
                        order="sequential")
        a = cpu.run(emb, rng=np.random.RandomState(7), **args)
        b = gpu.run(emb, rng=np.random.RandomState(7), **args)
        same, same_ctl, cos_err = compare_runs(a, b)
        say(f"trained_tiny [sentiment {label} table, fp32]: caption ids "
            f"identical={same} iter_ctl equal={same_ctl} max cosine diff="
            f"{cos_err:.3g} image embed diff={emb_err:.3g}; mean iter_ctl "
            f"{float(b.iter_ctl.mean()):.4f} (information); first caption "
            f"{b.gen_texts_list[-2][0]!r}")
        if not (same and same_ctl) or cos_err > AGREE_COS_ATOL:
            raise AssertionError(f"trained_tiny runs differ on the card "
                                 f"({label})")


# ---------------------------------------------------------------------------
# phase 6: the command-line path
# ---------------------------------------------------------------------------


def scratch_dir(name: str) -> str:
    """An empty directory under the git-ignored build/ of this checkout."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def cli_call(fn, argv, cwd: str):
    """``fn(argv)`` with ``cwd`` as the working directory (the CLIs write
    ``logger/`` and ``results/`` there); returns the wall time."""
    old = os.getcwd()
    os.chdir(cwd)
    try:
        t = time.perf_counter()
        fn(argv)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return time.perf_counter() - t
    finally:
        os.chdir(old)


def log_lines(cwd: str) -> List[str]:
    (name,) = os.listdir(os.path.join(cwd, "logger"))
    with open(os.path.join(cwd, "logger", name), encoding="utf-8") as f:
        return f.read().splitlines()


def check_results_tree(work: str, iters: int, B: int) -> str:
    """The sample's results tree: iter_0 .. iter_{iters-1} and
    best_clipscore, each with B captions; returns its path."""
    (tree,) = [d for d, _, files in os.walk(os.path.join(work, "results"))
               if "best_clipscore.json" in files]
    names = sorted(os.listdir(tree))
    expect = sorted([f"iter_{i}.json" for i in range(iters)]
                    + ["best_clipscore.json"])
    if names != expect:
        raise AssertionError(f"results tree {names} != {expect}")
    for name in names:
        with open(os.path.join(tree, name)) as f:
            res = json.load(f)
        if len(res) != B or not all(isinstance(v, str) and v
                                    for v in res.values()):
            raise AssertionError(f"{name}: {len(res)} captions, expected "
                                 f"{B} strings")
    return tree


def phase_cli_run(iters: int, want: Dict[str, int]) -> dict:
    """``api.run.main`` at full width over 32 seeded scenes rendered by
    ``data/synthetic.py`` at 224 px and written as PNG: decode, preprocess
    and generation with the main path's settings (bf16 weights, the same
    seeded towers). The results tree must be complete and the launch
    counts must be ``want``, the engine's structure for one generation.
    The images stay in the returned ``work`` for
    :func:`phase_cli_multihost`, which removes them."""
    B = MAIN["batch"]
    work = scratch_dir("cli_run")
    img_dir = os.path.join(work, "images")
    out = os.path.join(work, "out")
    os.makedirs(img_dir)
    os.makedirs(out)
    images = synthetic.build_dataset(B, seed=0, image_size=224)[0]
    for i, arr in enumerate(images):
        Image.fromarray(arr).save(os.path.join(img_dir, f"scene_{i:02d}.png"))
    argv = ["--random_models", "--batch_size", str(B),
            "--candidate_k", str(MAIN["top_k"]),
            "--sentence_len", str(MAIN["sentence_len"]),
            "--num_iterations", str(iters), "--order", "sequential",
            "--clip_len", str(MAIN["clip_len"]), "--samples_num", "1",
            "--seed", "0", "--device", DEVICE, "--param_dtype", "bfloat16",
            "--caption_img_path", img_dir]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    wall = cli_call(run_cli.main, argv, out)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tree = check_results_tree(out, iters, B)
    (generation_s,) = [float(x.split()[2].rstrip("s"))
                       for x in log_lines(out) if x.startswith("Finished in")]
    say(f"cli run: api.run.main over {B} PNG scenes (224 px, rendered by "
        f"data/synthetic.py), full width, k={MAIN['top_k']} "
        f"sentence_len={MAIN['sentence_len']} iterations={iters}: tree "
        f"{os.path.relpath(tree, out)} complete, {iters + 1} files of {B} "
        f"captions")
    say(f"cli run: {wall:.3f} s wall for the whole command (captioner "
        f"build, decode, preprocess, generation), {B / wall:.4f} caps/s; "
        f"generation with its iteration log lines (generate_caption's "
        f"'Finished in') {generation_s:.3f} s, {B / generation_s:.4f} "
        f"caps/s; peak memory {peak_gib:.2f} GiB; card {card_line()}")
    say(f"launches [cli run]: {launches}; the engine's structure gives "
        f"{want}")
    if launches != want:
        raise AssertionError(f"cli launch counts {launches} != {want}")
    return dict(launches=launches, wall_s=wall, generation_s=generation_s,
                peak_gib=peak_gib, work=work, argv=argv,
                captions=read_tree(tree))


def read_tree(tree: str) -> Dict[str, dict]:
    """Every file of a results tree's sample directory, by name."""
    out = {}
    for name in sorted(os.listdir(tree)):
        with open(os.path.join(tree, name)) as f:
            out[name] = json.load(f)
    return out


def phase_cli_demo() -> Dict[str, int]:
    """``api.demo.main`` on trained_tiny/ (both towers through
    ``--lm_model`` / ``--match_model``, the trained-directory route of
    ``from_pretrained``) over examples/girl.jpg, fp32, two fused samples,
    on the card and on the CPU: the "final caption:" and "best caption:"
    lines must be equal. Returns the card run's launch counts."""
    girl = os.path.join(os.path.dirname(TRAINED_TINY), "examples",
                        "girl.jpg")
    argv = ["--lm_model", TRAINED_TINY, "--match_model", TRAINED_TINY,
            "--dtype", "float32", "--order", "sequential", "--samples_num",
            "2", "--caption_img_path", girl]
    # the resize on the card against PIL's, at full and trained widths
    arr = np.asarray(Image.open(girl).convert("RGB"))
    for side in (224, 64):
        ref = preprocess_pil(Image.fromarray(arr), side)
        got = preprocess_torch(arr, side, device=DEVICE).cpu().numpy()
        err = float(np.abs(got - ref).mean())
        say(f"preprocess_torch on the card, {arr.shape[1]}x{arr.shape[0]} "
            f"-> {side}: mean |diff| against PIL {err:.4f} (limit 0.12)")
        if got.shape != ref.shape or err >= 0.12:
            raise AssertionError("preprocess_torch strays from PIL")
    lines, walls, launches = {}, {}, {}
    for device in (DEVICE, "cpu"):
        work = scratch_dir(f"cli_demo_{device}")
        reset_launches()
        walls[device] = cli_call(demo_cli.main, argv + ["--device", device],
                                 work)
        launches[device] = read_launches()
        lines[device] = [x for x in log_lines(work) if x.startswith(
            ("final caption:", "best caption:"))]
        shutil.rmtree(work)
    say(f"cli demo [trained_tiny, fp32, 2 fused samples]: card "
        f"{walls[DEVICE]:.3f} s, CPU {walls['cpu']:.3f} s; launches on the "
        f"card {launches[DEVICE]}, on the CPU {launches['cpu']}; lines equal="
        f"{lines[DEVICE] == lines['cpu']}: {lines[DEVICE]}")
    if len(lines[DEVICE]) != 4 or lines[DEVICE] != lines["cpu"]:
        raise AssertionError("the demo's caption lines differ between the "
                             "card and the CPU")
    if (launches[DEVICE]["layer_norm"] <= 0
            or launches[DEVICE]["masked_attention"] <= 0
            or any(launches["cpu"].values())):
        raise AssertionError(f"the demo on the card did not run the kernels, "
                             f"or the CPU run did: {launches}")
    return launches[DEVICE]


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """The safetensors layout: an 8-byte little-endian header length, the
    JSON header, then each tensor's raw bytes."""
    names = {torch.float32: "F32", torch.bfloat16: "BF16",
             torch.float16: "F16"}
    header, blobs, at = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16
               else t).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + len(raw)]}
        blobs.append(raw)
        at += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def hf_config(cap: Captioner) -> tuple:
    """HF config.json dicts of the captioner's BERT and CLIP."""
    b, c = cap.bert_model.config, cap.clip_model.config
    bert = {"model_type": "bert", "architectures": ["BertForMaskedLM"],
            "vocab_size": b.vocab_size, "hidden_size": b.hidden_size,
            "num_hidden_layers": b.num_layers,
            "num_attention_heads": b.num_heads,
            "intermediate_size": b.intermediate_size,
            "max_position_embeddings": b.max_position_embeddings,
            "type_vocab_size": b.type_vocab_size,
            "layer_norm_eps": b.layer_norm_eps, "hidden_act": b.hidden_act,
            "pad_token_id": b.pad_token_id}
    t, v = c.text, c.vision
    clip = {"model_type": "clip", "architectures": ["CLIPModel"],
            "projection_dim": c.projection_dim,
            "logit_scale_init_value": c.logit_scale_init,
            "text_config": {
                "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
                "num_hidden_layers": t.num_layers,
                "num_attention_heads": t.num_heads,
                "intermediate_size": t.intermediate_size,
                "max_position_embeddings": t.max_position_embeddings,
                "layer_norm_eps": t.layer_norm_eps,
                "hidden_act": t.hidden_act, "eos_token_id": t.eos_token_id},
            "vision_config": {
                "hidden_size": v.hidden_size, "num_hidden_layers": v.num_layers,
                "num_attention_heads": v.num_heads,
                "intermediate_size": v.intermediate_size,
                "image_size": v.image_size, "patch_size": v.patch_size,
                "layer_norm_eps": v.layer_norm_eps,
                "hidden_act": v.hidden_act}}
    return bert, clip


def phase_hf_dir(cap: Captioner, pixels) -> None:
    """The full-width captioner written as two HF checkpoint directories
    (config.json in HF's keys, model.safetensors through the inverse of the
    port's name table, vocab.txt and the CLIP vocab.json / merges.txt),
    read back by ``Captioner.from_pretrained`` on the card: every parameter
    bit-equal to its source, and one short generation with equal ids."""
    work = scratch_dir("hf")
    lm_dir, match_dir = os.path.join(work, "bert"), os.path.join(work, "clip")
    t = time.perf_counter()
    n_bytes = 0
    for d, module, config in zip((lm_dir, match_dir),
                                 (cap.bert_model, cap.clip_model),
                                 hf_config(cap)):
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(config, f)
        tensors = {hf_names(module, name)[0]: p
                   for name, p in module.named_parameters()}
        write_safetensors(os.path.join(d, "model.safetensors"), tensors)
        n_bytes += os.path.getsize(os.path.join(d, "model.safetensors"))
    with open(os.path.join(lm_dir, "vocab.txt"), "w", encoding="utf-8") as f:
        for tok in sorted(cap.wp.vocab, key=cap.wp.vocab.get):
            f.write(tok + "\n")
    vocab_json, merges_txt = make_test_bpe_files(match_dir)
    os.replace(vocab_json, os.path.join(match_dir, "vocab.json"))
    os.replace(merges_txt, os.path.join(match_dir, "merges.txt"))
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    cfg = dataclasses.replace(cap.cfg, lm_model=lm_dir, match_model=match_dir)
    loaded = Captioner.from_pretrained(cfg, device=DEVICE)
    load_s = time.perf_counter() - t
    n_params = 0
    for ours, theirs in ((loaded.bert_model, cap.bert_model),
                         (loaded.clip_model, cap.clip_model)):
        a, b = ours.state_dict(), theirs.state_dict()
        if list(a) != list(b):
            raise AssertionError("the loaded towers have other parameters")
        for key in a:
            if a[key].dtype != b[key].dtype or not torch.equal(a[key], b[key]):
                raise AssertionError(f"{key} differs after the HF round trip")
            n_params += a[key].numel()
    if loaded.wp.vocab != cap.wp.vocab or loaded.bpe.encoder != cap.bpe.encoder:
        raise AssertionError("the loaded tokenizers differ")
    args = run_args(max_len=MAIN["sentence_len"], top_k=16, max_iter=2,
                    order="sequential")
    a = cap.run(cap.encode_images(pixels[:2]), rng=np.random.RandomState(3),
                **args)
    b = loaded.run(loaded.encode_images(pixels[:2]),
                   rng=np.random.RandomState(3), **args)
    same, _, cos_err = compare_runs(a, b)
    say(f"hf directory [{cap.cfg.attn_impl}, {cap.cfg.param_dtype}]: "
        f"{n_bytes / 2 ** 20:.1f} MiB of safetensors written in {write_s:.2f} "
        f"s, read by from_pretrained in {load_s:.2f} s; {n_params} "
        f"parameters bit-equal; B=2 k=16 2 iterations: caption ids "
        f"identical={same} max cosine diff={cos_err:.3g}")
    if not same or cos_err != 0.0:
        raise AssertionError("the HF round trip changed a caption")
    del loaded
    shutil.rmtree(work)


def phase_trained_precision() -> None:
    """bf16 against fp32 on trained weights (information): trained_tiny/
    and trained_mid/ through ``from_pretrained`` caption 16 seeded scenes of
    their own world (64 px), on the card in fp32 and in bf16 and on the CPU
    in fp32: the share of the sentence's caption ids equal to the CPU's
    (the card's fp32 ids must equal the CPU's on trained_tiny/, as in
    phase 5). Then sentiment
    table control on trained_mid/, positive and negative, on the card in
    fp32: the mean committed control score."""
    images = synthetic.build_dataset(PRECISION["scenes"], seed=11,
                                     image_size=64)[0]
    pil = [Image.fromarray(a) for a in images]
    repo = os.path.dirname(TRAINED_TINY)
    args = run_args(max_len=PRECISION["sentence_len"],
                    top_k=PRECISION["top_k"], max_iter=PRECISION["iters"],
                    order="sequential")
    for world in ("trained_tiny", "trained_mid"):
        path = os.path.join(repo, world)
        ids = {}
        for label, device, dtype in (("CPU fp32", "cpu", "float32"),
                                     ("card fp32", DEVICE, "float32"),
                                     ("card bf16", DEVICE, "bfloat16")):
            cfg = ConzicConfig(dtype=dtype, param_dtype=dtype,
                               lm_model=path, match_model=path)
            cap = Captioner.from_pretrained(cfg, device=device)
            res = cap.run(cap.encode_images(pil), rng=np.random.RandomState(5),
                          **args)
            ids[label] = res.iter_ids[:, :, -args["max_len"] - 1:-1]
            if world == "trained_mid" and label == "card fp32":
                for negative in (False, True):
                    ctl = cap.run(cap.encode_images(pil),
                                  rng=np.random.RandomState(5), gamma=GAMMA,
                                  ctl="sentiment", negative=negative, **args)
                    say(f"trained precision [{world}, sentiment "
                        f"{'negative' if negative else 'positive'} table, "
                        f"card fp32]: mean committed iter_ctl "
                        f"{float(ctl.iter_ctl.mean()):.4f}, last iteration "
                        f"{float(ctl.iter_ctl[-1].mean()):.4f}; first caption "
                        f"{ctl.gen_texts_list[-2][0]!r}")
            del cap
        ref = ids["CPU fp32"]
        say(f"trained precision [{world}, {PRECISION}]: caption ids equal to "
            f"the CPU's fp32 run: card fp32 "
            f"{float((ids['card fp32'] == ref).mean()):.4f}, card bf16 "
            f"{float((ids['card bf16'] == ref).mean()):.4f} (information)")
        if world == "trained_tiny" and (ids["card fp32"] != ref).any():
            raise AssertionError("trained_tiny fp32 ids differ on the card")
    torch.cuda.empty_cache()


def phase_trained_pruned() -> None:
    """trained_mid/ (12-layer text tower) at the flagship's settings over
    its own rendered scenes (phase 5's sizes): the card in bf16 against the
    CPU in fp32, each with its own tables: the share of equal caption ids
    and each calibration's held-out cosine (information, not a gate)."""
    images = synthetic.build_dataset(PRECISION["scenes"], seed=11,
                                     image_size=64)[0]
    pil = [Image.fromarray(a) for a in images]
    path = os.path.join(os.path.dirname(TRAINED_TINY), "trained_mid")
    args = run_args(max_len=PRECISION["sentence_len"],
                    top_k=PRECISION["top_k"], max_iter=PRECISION["iters"],
                    order="sequential")
    ids, calib, secs = {}, {}, {}
    for label, device, dtype in (("CPU fp32", "cpu", "float32"),
                                 ("card bf16", DEVICE, "bfloat16")):
        cfg = ConzicConfig(dtype=dtype, param_dtype=dtype, lm_model=path,
                           match_model=path, verbose=False,
                           **FLAGSHIP["cfg"])
        cap = Captioner.from_pretrained(cfg, device=device)
        t = time.perf_counter()
        res = cap.run(cap.encode_images(pil), rng=np.random.RandomState(5),
                      **args)
        secs[label] = time.perf_counter() - t
        ids[label] = res.iter_ids[:, :, -args["max_len"] - 1:-1]
        calib[label] = cap.stage1_calib_cos
        del cap
    share = float((ids["card bf16"] == ids["CPU fp32"]).mean())
    say(f"trained pruned [trained_mid, {FLAGSHIP['cfg']}, {PRECISION}]: "
        f"card bf16 caption ids equal to the CPU's fp32: {share:.4f}; "
        f"held-out cosine CPU {calib['CPU fp32']:.4f} card "
        f"{calib['card bf16']:.4f}; run with its tables CPU "
        f"{secs['CPU fp32']:.1f} s, card {secs['card bf16']:.1f} s "
        f"(information)")
    torch.cuda.empty_cache()


# kernel-name fragments -> the part of a Gibbs step they belong to
# ---------------------------------------------------------------------------
# phases 7 and 8: the int8 tier, the XLA attention routes, the web app,
# retrieval and scale-out
# ---------------------------------------------------------------------------

# (label, config fields, run arguments) of the tiny card-against-CPU runs
ROUTE_CASES = (
    ("int8, pallas", dict(quant="int8"), dict(order="sequential")),
    ("int8_all, pallas", dict(quant="int8_all"), dict(order="shuffle")),
    ("int8, pallas_out", dict(quant="int8", attn_impl="pallas_out"),
     dict(order="sequential")),
    ("int8_all, pallas_block", dict(quant="int8_all",
                                    attn_impl="pallas_block"),
     dict(order="sequential")),
    ("xla", dict(attn_impl="xla"), dict(order="sequential")),
    ("xla, full rows", dict(attn_impl="xla", kv_chunk_size=0),
     dict(order="sequential")),
    ("xla_bhsd", dict(attn_impl="xla_bhsd"), dict(order="shuffle")),
    ("twoblock", dict(attn_impl="twoblock"), dict(order="sequential")),
    ("twoblock, span", dict(attn_impl="twoblock"), dict(order="span")),
    ("twoblock, int8", dict(attn_impl="twoblock", quant="int8"),
     dict(order="sequential")),
)
# the full-width reads of the new paths: (label, attn_impl, quant)
NEW_MAIN_PATHS = (("int8", "pallas", "int8"),
                  ("int8_all", "pallas", "int8_all"),
                  ("xla", "xla", "none"))
INDEX_CAPTIONS = 2048
# the full-width 2 x 2 mesh's iterations on the one card (time-bound)
MESH_2D_ITERS = 2
# the two-process runs: (images, prompt rows) of the tiny one
TINY_PROCS = dict(images=4, max_len=5, top_k=16, iters=2)


def phase_route_agreement() -> None:
    """Tiny fp32 captioners under the int8 tiers and the XLA routes: the
    card's caption ids must be the CPU's. The XLA routes launch no
    attention kernel, and int8 under pallas_out no attention_with_out."""
    for label, cfg_kw, run_kw in ROUTE_CASES:
        cfg = ConzicConfig(dtype="float32", **cfg_kw)
        cpu, gpu, emb, emb_err = tiny_pair(cfg)
        args = run_args(max_len=5, top_k=16, max_iter=2, n_samples=2,
                        **run_kw)
        a = cpu.run(emb, rng=np.random.RandomState(7), **args)
        reset_launches()
        b = gpu.run(emb, rng=np.random.RandomState(7), **args)
        launches = read_launches()
        same, _, cos_err = compare_runs(a, b)
        say(f"agreement [route: {label}]: caption ids identical={same} max "
            f"cosine diff={cos_err:.3g} (tol {AGREE_COS_ATOL:g}) image "
            f"embed diff={emb_err:.3g} launches={launches}")
        if not same or cos_err > AGREE_COS_ATOL:
            raise AssertionError(f"GPU and CPU runs differ (route: {label})")
        banned = (["masked_attention", "attention_with_out",
                   "attention_block"] if cfg.attn_impl in XLA_IMPLS else
                  ["attention_with_out"] if cfg.attn_impl == "pallas_out"
                  else [])
        if any(launches[n] for n in banned) or launches["layer_norm"] <= 0:
            raise AssertionError(f"route {label}: launches {launches}")


def thread_launch_race(reps: int = 4000) -> None:
    """Two host threads launch ``masked_attention`` on one card at two
    shapes that take the same tensor-core kernel with different shared
    memory (N=800 and N=4 rows, Sq=16, Sk=24, H=8, D=64, bf16, causal),
    as two replicas of a mesh do. The kernel's shared-memory limit is an
    attribute of the function; set to each launch's own size it raced and
    a launch failed now and then (``csrc/attention_mma.cuh``
    ``allow_shared``). Every launch must succeed."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    shapes = {}
    for N in (800, 4):
        q, k, v = [torch.randn(N, 24, 8, 64, device=DEVICE, generator=gen)
                   .bfloat16() for _ in range(3)]
        shapes[N] = (q[:, :16].contiguous(), k, v)
    failures: List[str] = []

    def loop(N: int) -> None:
        q, k, v = shapes[N]
        with torch.inference_mode():
            for _ in range(reps):
                try:
                    masked_attention(q, k, v, causal=True)
                except RuntimeError as e:
                    failures.append(str(e))

    threads = [threading.Thread(target=loop, args=(N,)) for N in shapes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    say(f"thread race [masked_attention, two threads on one card, N=800 "
        f"and N=4]: {len(failures)} failed launches of {2 * reps}"
        + (f" ({failures[0]})" if failures else ""))
    if failures:
        raise AssertionError("concurrent launches failed")


def phase_mesh_agreement() -> None:
    """A data mesh of two replicas on the one card ([cuda:0, cuda:0], one
    thread each) captions a ragged batch (3 images x 2 samples, padded to
    the mesh): ids equal to one CPU's; then a 2 x 2 (data, model) mesh
    on the card, its vocabulary cut in two (``MESH_2D_CASES``). A mesh of
    more cards than the machine has is refused."""
    cfg = ConzicConfig(dtype="float32")
    cpu = Captioner.from_random(config=cfg, seed=0, device="cpu")
    mesh = make_mesh(2, devices=["cuda:0", "cuda:0"])
    gpu = Captioner(copy.deepcopy(cpu.bert_model),
                    copy.deepcopy(cpu.clip_model), cpu.wp, cpu.bpe, cfg,
                    mesh=mesh)
    emb = cpu.encode_images(seeded_pixels(cpu, 3))
    for order in ("sequential", "shuffle"):
        args = run_args(max_len=5, top_k=16, max_iter=2, order=order,
                        n_samples=2)
        a = cpu.run(emb, rng=np.random.RandomState(7), **args)
        b = gpu.run(emb, rng=np.random.RandomState(7), **args)
        same, _, cos_err = compare_runs(a, b)
        say(f"agreement [mesh cuda:0 x 2, {order}]: caption ids identical="
            f"{same} max cosine diff={cos_err:.3g}")
        if not same or cos_err > AGREE_COS_ATOL:
            raise AssertionError(f"the mesh run differs from the CPU's "
                                 f"({order})")
    phase_mesh_2d_agreement(make_mesh_2d(2, 2, devices=["cuda:0"] * 4),
                            "2 x 2 mesh on cuda:0")
    thread_launch_race()
    n = torch.cuda.device_count() + 1
    try:
        make_mesh(n)
    except ValueError as e:
        say(f"mesh refusal: make_mesh({n}) on {n - 1} card(s): {e}")
    else:
        raise AssertionError(f"make_mesh({n}) was not refused")


# the (data, model) mesh's tiny cases, the kinds of the reference's
# multichip dry run: (label, quant tier, run arguments); 3 images, so one
# sample a row is a ragged batch over two data rows
MESH_2D_CASES = (
    ("sequential, 2 samples", "none", dict(order="sequential", n_samples=2)),
    ("shuffle, 2 samples", "none", dict(order="shuffle", n_samples=2)),
    ("prune_k=4", "none", dict(order="sequential", prune_k=4)),
    ("sentiment", "none", dict(order="sequential", ctl="sentiment",
                               gamma=GAMMA)),
    ("int8_all", "int8_all", dict(order="sequential")),
)


def even_vocab() -> dict:
    """The synthetic word-piece vocabulary with a pad token when its size
    is odd: the model axis of two must divide it to be cut."""
    vocab = make_test_wordpiece_vocab()
    if len(vocab) % 2:
        vocab["zzpad"] = len(vocab)
    return vocab


def mesh_2d_pair(quant: str, mesh) -> tuple:
    """A tiny fp32 captioner on the CPU over an even vocabulary, quantized
    by ``quant``, and its copy on the (data, model) mesh ``mesh``; fails
    unless the copy's vocabulary was cut."""
    cfg = ConzicConfig(dtype="float32", quant=quant, verbose=False)
    cpu = Captioner.from_random(config=cfg, seed=0, wp_vocab=even_vocab(),
                                device="cpu")
    gpu = Captioner(copy.deepcopy(cpu.bert_model),
                    copy.deepcopy(cpu.clip_model), cpu.wp, cpu.bpe, cfg,
                    mesh=mesh)
    if not isinstance(gpu.bert_model, VocabSplitBert):
        raise AssertionError("the vocabulary was not cut over the model "
                             "axis")
    return cpu, gpu


def phase_mesh_2d_agreement(mesh, label: str) -> None:
    """Every case of MESH_2D_CASES on ``mesh``, a (data, model) mesh (one
    replica and one thread a data row, BERT's word table and MLM bias cut
    over the row): caption ids and control scores equal to the CPU's."""
    pairs = {}
    for case, quant, kw in MESH_2D_CASES:
        if quant not in pairs:
            pairs[quant] = mesh_2d_pair(quant, mesh)
        cpu, gpu = pairs[quant]
        emb = cpu.encode_images(seeded_pixels(cpu, 3))
        args = run_args(max_len=5, top_k=16, max_iter=2, **kw)
        a = cpu.run(emb, rng=np.random.RandomState(7), **args)
        if "prune_k" in kw:  # the card on the CPU's pruned-tier tables
            gpu.adopt_prune_tables(cpu.tables, cpu.stage1_key,
                                   cpu.stage1_calib_cos,
                                   cpu.stage1_pc_calib_cos)
        b = gpu.run(emb, rng=np.random.RandomState(7), **args)
        same, same_ctl, cos_err = compare_runs(a, b)
        say(f"agreement [{label}, {case}]: caption ids identical={same} "
            f"iter_ctl equal={same_ctl} max cosine diff={cos_err:.3g} "
            f"(tol {AGREE_COS_ATOL:g})")
        if not (same and same_ctl) or cos_err > AGREE_COS_ATOL:
            raise AssertionError(f"the {label} run differs from the CPU's "
                                 f"({case})")


def process_group(cmd_of: Callable[[int, int], List[str]], n: int,
                  cwd: str, timeout: int, what: str) -> List[str]:
    """``n`` processes, ``cmd_of(port, rank)`` each, that join one gloo
    group at ``tcp://localhost:port``, on this machine's cards (rank %
    cards); returns their output. Each writes it to a file: read from
    pipes one process at a time, a process whose pipe is full would stop
    while the others wait for it at the group's barrier. A failed or
    stuck process fails the phase, and every process is ended."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "CONZIC_MULTIHOST")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH")) if p)
    out_dir = scratch_dir("process_group")
    files = [open(os.path.join(out_dir, f"rank{rank}.log"), "w+")
             for rank in range(n)]
    procs = [subprocess.Popen(
        cmd_of(port, rank), cwd=cwd, env=env, stdout=f,
        stderr=subprocess.STDOUT, text=True)
        for rank, f in enumerate(files)]
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        logs = []
        for f in files:
            f.seek(0)
            logs.append(f.read())
            f.close()
        shutil.rmtree(out_dir)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"process {rank} ({what}) failed:\n"
                                 f"{log[-4000:]}")
    return logs


def phase_two_process_tiny(n: int = 2) -> None:
    """``n`` processes on the cards (two share the one card), gloo between
    them: each computes its block of the CPU's image embeddings, all are
    gathered, each captions its block of rows on its card and the results
    are gathered. The ids must be one CPU process's."""
    cfg = ConzicConfig(dtype="float32")
    cpu = Captioner.from_random(config=cfg, seed=0, device="cpu")
    t = TINY_PROCS
    emb = cpu.encode_images(seeded_pixels(cpu, t["images"]))
    a = cpu.run(emb, rng=np.random.RandomState(7), **run_args(
        max_len=t["max_len"], top_k=t["top_k"], max_iter=t["iters"],
        order="shuffle", n_samples=2))
    work = scratch_dir("two_process_tiny")
    out = os.path.join(work, "rank0.json")
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    process_group(lambda port, rank: [
        sys.executable, os.path.join(here, "chip_smoke.py"), "--worker",
        "tiny", str(port), str(rank), str(n), out], n, here, timeout=300,
        what="chip_smoke.py --worker tiny")
    with open(out) as f:
        got = json.load(f)
    same = (np.array_equal(np.asarray(got["iter_ids"]), a.iter_ids)
            and np.array_equal(np.asarray(got["best_ids"]), a.best_ids))
    where = ("two processes on the card" if n == 2 else
             f"{n} processes on {torch.cuda.device_count()} cards")
    say(f"agreement [{where}, gloo]: caption ids identical={same} to one "
        f"CPU process ({time.perf_counter() - t0:.1f} s with the "
        f"processes' start)")
    shutil.rmtree(work)
    if not same:
        raise AssertionError("the two-process run differs from the CPU's")


def run_worker(kind: str, port: str, rank: int, world: int,
               out: str) -> int:
    """One process of the tiny multi-process run (``--worker tiny``)."""
    if kind != "tiny":
        raise ValueError(f"unknown worker kind {kind!r}")
    dist_lib.initialize(f"localhost:{port}", world, rank)
    dev = dist_lib.local_device()
    torch.cuda.set_device(dev)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = TINY_PROCS
    cfg = ConzicConfig(dtype="float32")
    cpu = Captioner.from_random(config=cfg, seed=0, device="cpu")
    gpu = Captioner(copy.deepcopy(cpu.bert_model),
                    copy.deepcopy(cpu.clip_model), cpu.wp, cpu.bpe, cfg,
                    device=dev)
    pixels = seeded_pixels(cpu, t["images"])
    local = cpu.encode_images(pixels[dist_lib.local_slice(t["images"])])
    emb = dist_lib.put_local_shard(local, t["images"], dev)
    res = gpu.run(emb, rng=np.random.RandomState(7), **run_args(
        max_len=t["max_len"], top_k=t["top_k"], max_iter=t["iters"],
        order="shuffle", n_samples=2))
    if dist_lib.is_primary():
        with open(out, "w") as f:
            json.dump(dict(iter_ids=res.iter_ids.tolist(),
                           best_ids=res.best_ids.tolist()), f)
    dist_lib.shutdown()
    return 0


def phase_cli_multihost(cli: dict, iters: int, n: int = 2) -> dict:
    """``python -m conzic_torch.api.run --multihost`` in ``n`` processes
    (two share the one card; on several cards, one a card), with phase
    6's arguments over its PNG scenes: each process decodes its block of
    the batch and captions its rows, gloo gathers the results and process
    0 alone writes the tree. The tree must be complete, written once, and
    hold the one-process command's captions (``cli``, phase 6). caps/s of
    the whole batch over the slowest process's generation (its
    ``Finished in`` line) and over the command's wall time (the
    processes' start, the towers' build, decode and generation)."""
    B = MAIN["batch"]
    work = scratch_dir("cli_multihost")
    t0 = time.perf_counter()
    process_group(lambda port, rank: [
        sys.executable, "-m", "conzic_torch.api.run", *cli["argv"],
        "--multihost", "--coordinator_address", f"localhost:{port}",
        "--num_processes", str(n), "--process_id", str(rank)],
        n, work, timeout=600, what="api.run --multihost")
    wall = time.perf_counter() - t0
    tree = check_results_tree(work, iters, B)
    lines = []
    for name in sorted(os.listdir(os.path.join(work, "logger"))):
        with open(os.path.join(work, "logger", name),
                  encoding="utf-8") as f:
            lines += f.read().splitlines()
    saved = sum("saved results to" in x for x in lines)
    gen = [float(x.split()[2].rstrip("s")) for x in lines
           if x.startswith("Finished in")]
    got = read_tree(tree)
    same = sum(got[name][img] == cap
               for name, caps in cli["captions"].items()
               for img, cap in caps.items())
    total = sum(len(caps) for caps in cli["captions"].values())
    where = ("two processes on one card" if n == 2 else
             f"{n} processes on {torch.cuda.device_count()} cards")
    gen_s = max(gen) if gen else float("nan")
    say(f"cli multihost [{where}, gloo]: api.run --multihost over the "
        f"{B} PNG scenes, {B // n} a process: tree written {saved} time(s), "
        f"{same} of {total} captions equal the one-process command's; "
        f"generation (slowest 'Finished in' of {len(gen)}) {gen_s:.3f} s, "
        f"{B / gen_s:.4f} caps/s against one process's "
        f"{B / cli['generation_s']:.4f}; {wall:.3f} s wall for the "
        f"command, {B / wall:.4f} caps/s against one process's "
        f"{B / cli['wall_s']:.4f}; card {card_line()}")
    shutil.rmtree(work)
    shutil.rmtree(cli["work"])
    if saved != 1 or len(gen) != n:
        raise AssertionError(f"api.run --multihost: tree saved {saved} "
                             f"times, {len(gen)} generations logged")
    if same != total:
        raise AssertionError(f"api.run --multihost: {total - same} "
                             f"captions differ from one process's")
    return dict(caps_s=B / gen_s, wall_caps_s=B / wall, share=same / total)


def phase_int8_matmul(shape: dict) -> dict:
    """The int8 product at the main path's text MLP shape (the suffix
    chunk's rows x 512 -> 2048): the card's int32 product equal to the
    CPU's, then the times of the quantized ``Linear`` (row quantization,
    ``torch._int_mm``, rescale, bias), of ``torch._int_mm`` alone and of
    ``F.linear`` in bf16."""
    t_cfg = CLIPConfig().text
    rows = shape["rows"] * shape["S_suf"]
    E, F_ = t_cfg.hidden_size, t_cfg.intermediate_size
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn(rows, E, device=DEVICE, generator=gen).to(torch.bfloat16)
    lin = Linear(E, F_, dtype=torch.bfloat16, quant="int8").to(DEVICE)
    with torch.no_grad():
        lin.weight.copy_(0.02 * torch.randn(F_, E, device=DEVICE,
                                            generator=gen))
        lin.bias.copy_(0.02 * torch.randn(F_, device=DEVICE, generator=gen))
    qw = lin.quantized_weight()
    xq, _ = quant._quantize_rows(x)
    card = quant.int_mm(xq, qw.q)
    cpu = quant.int_mm(xq[:256].cpu(), qw.q.cpu())
    if card.dtype != torch.int32 or not torch.equal(card[:256].cpu(), cpu):
        raise AssertionError("the card's int32 product differs from the "
                             "CPU's")
    small = quant.int_mm(xq[:3], qw.q)  # padded to cuBLASLt's 17 rows
    if not torch.equal(small.cpu(), quant.int_mm(xq[:3].cpu(),
                                                 qw.q.cpu())):
        raise AssertionError("the padded int32 product differs")
    w16, b16 = lin.weight.to(torch.bfloat16), lin.bias.to(torch.bfloat16)
    _, sx = quant._quantize_rows(x)
    bias = lin.bias.float()

    def epilogue():  # the int32 product rescaled, biased and cast
        return ((card.float() * sx * qw.scale) + bias).to(torch.bfloat16)

    with torch.inference_mode():
        int8_ms = time_ms(lambda: lin(x), 20)
        quantize_ms = time_ms(lambda: quant._quantize_rows(x), 20)
        mm_ms = time_ms(lambda: quant.int_mm(xq, qw.q), 20)
        epilogue_ms = time_ms(epilogue, 20)
        bf16_ms = time_ms(lambda: F.linear(x, w16, b16), 20)
    flops = 2.0 * rows * E * F_
    say(f"int8_matmul [{rows}x{E} @ {E}x{F_}]: int32 product equal to the "
        f"CPU's; quantized Linear {int8_ms:.4f} ms = row quantization "
        f"{quantize_ms:.4f} + torch._int_mm {mm_ms:.4f} "
        f"({flops / mm_ms / 1e9:.1f} TOP/s) + fp32 rescale, bias and cast "
        f"{epilogue_ms:.4f}, against F.linear bf16 {bf16_ms:.4f} ms "
        f"({flops / bf16_ms / 1e9:.1f} TFLOP/s); card {card_line()}")
    return dict(int8_ms=int8_ms, quantize_ms=quantize_ms, int_mm_ms=mm_ms,
                epilogue_ms=epilogue_ms, bf16_ms=bf16_ms)


def _scene_png(seed: int = 0) -> bytes:
    img = synthetic.build_dataset(1, seed=seed, image_size=224)[0][0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def phase_app(cap: Captioner) -> dict:
    """The web app's fallback server on the full-width captioner: a GET of
    the page, then two POSTs of a rendered scene at the UI's defaults
    (caption, shuffle, 10 words, 10 iterations, 2 samples); each answer
    must hold two final and two best captions, and the two answers are
    equal (Submit reseeds)."""
    cfg = ConzicConfig(clip_len=MAIN["clip_len"])
    cap.cfg.verbose = False
    server = fallback_ui.make_server(cap, cfg, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=300)
        conn.request("GET", "/")
        page = conn.getresponse().read().decode("utf-8")
        if "Upload Picture" not in page or "Best Caption" not in page:
            raise AssertionError("the fallback page lacks its widgets")
        values = dict(zip(
            ("run_type", "control_type", "sentiment_type", "order",
             "prompt", "sentence_len", "num_iterations", "samples_num",
             "alpha", "beta", "gamma"), app_mod.reset_values()))
        payload = json.dumps(dict(values, image="data:image/png;base64,"
                                  + base64.b64encode(_scene_png()).decode()))
        answers, latencies = [], []
        for _ in range(2):
            t = time.perf_counter()
            conn.request("POST", "/submit", body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            latencies.append(time.perf_counter() - t)
            if resp.status != 200 or "error" in body:
                raise AssertionError(f"POST failed: {resp.status} {body}")
            if (len(body["final"].splitlines()) != 2
                    or len(body["best"].splitlines()) != 2):
                raise AssertionError(f"expected two samples: {body}")
            answers.append(body)
    finally:
        server.shutdown()
        server.server_close()
    if answers[0] != answers[1]:
        raise AssertionError("two POSTs of one request differ")
    say(f"app [fallback server, full width, k={cfg.candidate_k}, UI "
        f"defaults]: POST latency {latencies[0]:.3f} s then "
        f"{latencies[1]:.3f} s (2 samples x 10 iterations x 10 words, B=1); "
        f"final captions {answers[0]['final'].splitlines()!r}; card "
        f"{card_line()}")
    return dict(latency_s=latencies)


def phase_index(cap: Captioner) -> dict:
    """``build_index`` over 2,048 captions of the synthetic world at full
    width (chunks of 128 at CLIP's 77 tokens): captions/s of the whole
    call (encode and writing the text files); then the index read back
    and one search for a rendered scene."""
    rng = np.random.RandomState(0)
    corpus = [synthetic.caption_scene(synthetic.sample_scene(rng), rng)
              for _ in range(INDEX_CAPTIONS)]
    work = scratch_dir("index")
    with open(os.path.join(work, "corpus.json"), "w") as f:
        json.dump(corpus, f)
    torch.cuda.synchronize()
    t = time.perf_counter()
    emb = retrieval.build_index(cap, os.path.join(work, "corpus.json"),
                                os.path.join(work, "index"))
    build_s = time.perf_counter() - t
    if emb.shape[0] != INDEX_CAPTIONS or not np.isfinite(emb).all():
        raise AssertionError(f"index of shape {emb.shape}, finite="
                             f"{np.isfinite(emb).all()}")
    index = retrieval.CLIPIndex(os.path.join(work, "index",
                                             "index_matrix.txt"),
                                os.path.join(work, "index",
                                             "mapping_dict.json"), cap)
    scene = os.path.join(work, "scene.png")
    with open(scene, "wb") as f:
        f.write(_scene_png(seed=1))
    t = time.perf_counter()
    pred = index.search_text(scene)
    search_s = time.perf_counter() - t
    if pred not in corpus or index.matrix.shape != emb.shape:
        raise AssertionError(f"search gave {pred!r}")
    say(f"index [build_index, full width]: {INDEX_CAPTIONS} captions in "
        f"{build_s:.3f} s, {INDEX_CAPTIONS / build_s:.1f} captions/s; one "
        f"search {search_s * 1e3:.1f} ms -> {pred!r}; card {card_line()}")
    shutil.rmtree(work)
    return dict(captions_s=INDEX_CAPTIONS / build_s, search_s=search_s)


def _mesh_launches(cap: Captioner, iters: int) -> Dict[str, int]:
    """What the engine's structure gives for one main-path generation on
    ``cap``'s mesh: the image tower once (on the first card), the prompt
    prefix and every Gibbs step once per data row, each row with its
    block of the batch."""
    rows = len(cap.mesh)
    steps = iters * MAIN["sentence_len"]
    once, step = expected_launches(cap, n_row_chunks(
        MAIN["batch"] // rows, MAIN["top_k"], MAIN["row_chunk"]))
    nt = cap.clip_model.config.text.num_layers
    prefix = {"layer_norm": 2 * nt + 1, "masked_attention": nt}
    return {k: once[k] + (rows - 1) * prefix.get(k, 0) + rows * steps * v
            for k, v in step.items()}


def phase_mesh_main(iters: int, cap: Captioner, pixels, one: dict,
                    label: str) -> dict:
    """The main path on ``cap``'s mesh (one replica and one thread a data
    row): caps/s against one card's, launch counts against the engine's
    structure, and the share of best ids equal to one card's."""
    L = MAIN["sentence_len"]
    args = run_args(max_len=L, top_k=MAIN["top_k"], order="sequential")
    cap.run(cap.encode_images(pixels), max_iter=1,
            rng=np.random.RandomState(42), **args)  # warm-up
    reset_launches()
    res = cap.run(cap.encode_images(pixels), max_iter=iters,
                  rng=np.random.RandomState(42), **args)
    launches = read_launches()
    want = _mesh_launches(cap, iters)
    check_output(cap, res, iters, main_shape(cap))
    seed = main_shape(cap)["seed_len"]
    want_ids = one["result"].best_ids[:, seed:seed + L]
    share = float((res.best_ids[:, seed:seed + L] == want_ids).mean())
    B = MAIN["batch"]
    say(f"scale [{label}, main path]: {res.elapsed_s:.3f} s, "
        f"{B / res.elapsed_s:.4f} caps/s against one card's "
        f"{B / one['result'].elapsed_s:.4f}; launches {launches}, the "
        f"engine's structure gives {want}; {share:.4f} of the best caption "
        f"ids equal one card's")
    if launches != want:
        raise AssertionError(f"mesh launch counts {launches} != {want}")
    return dict(caps_s=B / res.elapsed_s, share=share, launches=launches)


def vocab_bytes(cap: Captioner) -> Dict[str, int]:
    """Bytes of BERT's word table and MLM bias on each card, over every
    replica of ``cap``."""
    out: Dict[str, int] = {}
    for bert, _ in cap._replicas.values():
        if isinstance(bert, VocabSplitBert):
            parts = [*bert.shards.words, *bert.shards.biases]
        else:
            parts = [bert.get_parameter(name) for name in VOCAB_PARAMS]
        for t in parts:
            out[str(t.device)] = out.get(str(t.device), 0) + t.nbytes
    return out


def phase_mesh_2d_main(iters: int, cap: Captioner, pixels) -> dict:
    """The main path at full width (V = 30,522 cut in two) on a 2 x 2 mesh
    of the one card, against one card and a data mesh of two replicas
    there, all at ``iters`` iterations: caps/s, launch counts (equal to
    the data mesh's), the share of best ids equal to one card's, and the
    bytes of each shard of the word table and the MLM bias."""
    cards = [DEVICE] * 4
    one = phase_main(iters, cap, main_shape(cap), pixels,
                     label=f"one card, {iters} iterations")
    data = phase_mesh_main(iters, Captioner(
        cap.bert_model, cap.clip_model, cap.wp, cap.bpe, cap.cfg,
        mesh=make_mesh(2, devices=cards[:2])), pixels, one,
        "data mesh of two replicas on cuda:0")
    split = Captioner(cap.bert_model, cap.clip_model, cap.wp, cap.bpe,
                      cap.cfg, mesh=make_mesh_2d(2, 2, devices=cards))
    out = phase_mesh_main(iters, split, pixels, one, "2 x 2 mesh on cuda:0")
    if out["launches"] != data["launches"]:
        raise AssertionError(f"2 x 2 mesh launches {out['launches']} != "
                             f"the data mesh's {data['launches']}")
    bert = split.bert_model
    V, E = bert.config.vocab_size, bert.config.hidden_size
    whole = V * E * bert.shards.words[0].element_size()
    shards = [(w.nbytes, b.nbytes, str(w.device))
              for w, b in zip(bert.shards.words, bert.shards.biases)]
    say(f"2 x 2 mesh [vocabulary]: V={V} E={E}, word table whole "
        f"{whole} B ({whole / 1e6:.1f} MB); shards (word B, bias B, "
        f"device) {shards}; card {card_line()}")
    if any(w * 2 != whole for w, _, _ in shards):
        raise AssertionError("a shard does not hold half the word table")
    return dict(out, one_caps_s=MAIN["batch"] / one["result"].elapsed_s,
                data_caps_s=data["caps_s"], shard_bytes=shards)


def card_memory(n: int) -> List[int]:
    """``torch.cuda.memory_allocated`` of each of the first ``n`` cards,
    after a collection."""
    gc.collect()
    for i in range(n):
        torch.cuda.synchronize(i)
    return [torch.cuda.memory_allocated(i) for i in range(n)]


def phase_scale(iters: int, cards: Optional[List[str]] = None) -> None:
    """``--scale``: scale-out over every card of the machine (two or
    more). Tiny fp32 towers on a data mesh of every card and in one
    process a card, and on a (n/2, 2) mesh of the cards (``MESH_2D_CASES``,
    BERT's vocabulary cut over each row's two cards): ids equal to the
    CPU's. Then the main path at full width on one card, on the data mesh
    and on the (n/2, 2) mesh (caps/s, launch counts, the share of best ids
    equal to one card's; each card's allocated memory and vocabulary
    bytes under both meshes), and the command line over phase 6's scenes
    in one process and in ``api.run --multihost``, one process a card (the
    same captions)."""
    cards = cards or [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    n = len(cards)
    if n < 2:
        raise AssertionError(f"--scale needs two or more cards; {n} "
                             f"visible")
    build_s = build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"scale: {n} cards, kernels built in {build_s:.2f} s")
    label, mesh = f"data mesh of {n} cards", make_mesh(n, cards)
    cfg = ConzicConfig(dtype="float32")
    cpu = Captioner.from_random(config=cfg, seed=0, device="cpu")
    emb = cpu.encode_images(seeded_pixels(cpu, 2 * n + 1))  # ragged
    args = run_args(max_len=5, top_k=16, max_iter=2, order="shuffle",
                    n_samples=2)
    a = cpu.run(emb, rng=np.random.RandomState(7), **args)
    gpu = Captioner(copy.deepcopy(cpu.bert_model),
                    copy.deepcopy(cpu.clip_model), cpu.wp, cpu.bpe, cfg,
                    mesh=mesh)
    b = gpu.run(emb, rng=np.random.RandomState(7), **args)
    same, _, cos_err = compare_runs(a, b)
    say(f"scale [{label}, tiny]: caption ids identical={same} to the "
        f"CPU's, max cosine diff {cos_err:.3g}; replicas on "
        f"{[' '.join(map(str, row)) for row in gpu._replicas]}")
    if not same or cos_err > AGREE_COS_ATOL:
        raise AssertionError(f"{label}: the card differs from the CPU")
    label_2d = mesh_2d = None
    if n % 2 == 0:
        label_2d = f"{n // 2} x 2 mesh of {n} cards"
        mesh_2d = make_mesh_2d(n // 2, 2, cards)
        phase_mesh_2d_agreement(mesh_2d, label_2d)
    phase_two_process_tiny(n)
    cap = full_captioner("bfloat16")
    v = cap.clip_model.config.vision
    pixels = np.random.RandomState(0).rand(
        MAIN["batch"], v.image_size, v.image_size,
        v.num_channels).astype(np.float32)
    one = phase_main(iters, cap, main_shape(cap), pixels, label="one card")
    meshed = Captioner(cap.bert_model, cap.clip_model, cap.wp, cap.bpe,
                       cap.cfg, mesh=mesh)
    phase_mesh_main(iters, meshed, pixels, one, label)
    if mesh_2d is not None:
        mem = {label: (card_memory(n), vocab_bytes(meshed))}
        split = Captioner(cap.bert_model, cap.clip_model, cap.wp, cap.bpe,
                          cap.cfg, mesh=mesh_2d)
        del meshed, cap  # the whole word table goes with them
        phase_mesh_main(iters, split, pixels, one, label_2d)
        mem[label_2d] = (card_memory(n), vocab_bytes(split))
        for what, (allocated, vocab) in mem.items():
            say(f"scale [{what}, memory]: allocated per card (MB) "
                f"{[round(b / 1e6, 1) for b in allocated]}; word table and "
                f"MLM bias per card (B) {vocab}; card {card_line()}")
        del split
    else:
        del meshed, cap
    torch.cuda.empty_cache()
    cli = phase_cli_run(iters, one["launches"])
    phase_cli_multihost(cli, iters, n)


# ---------------------------------------------------------------------------
# phase 9: the training path
# ---------------------------------------------------------------------------

# the LayerNorm Function, card against CPU: (F, rows) per type, the rows no
# multiple of a block of the kernel
TRAIN_LN_SHAPES = ((128, 999), (256, 1201), (768, 333))
# backward tolerances, card (kernel forward, plain backward) against the
# CPU: dx within 2^-7 of |dx| (one bf16 step; fp32: 1e-5) plus 1e-5 of
# max|dx| (sums over a row in another order); dscale and dbias, fp32 sums
# over every row in another order, within 1e-4 of their largest entry
TRAIN_DX_REL = {torch.float32: 1e-5, torch.bfloat16: BF16_ULP}
TRAIN_SUM_REL = 1e-4
# the tiny fp32 step, card against CPU: loss to 1e-5 relative, the global
# gradient norm to 1e-3 relative (CUDA's scatter-add in the embeddings'
# backward sums in another order each run), each parameter's gradient norm
# to 1e-3 of itself plus 1e-3 of the global norm's 1e-3: the key bias's
# gradient is zero but for rounding (a constant added to a row's logits),
# so its norm is noise, while a missing gradient misses by its whole norm
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-3
# the full-width read: trained_mid/'s arguments, only the data and the
# steps cut (trained_mid: train_n 16,384, val_n 512, 6,000 CLIP and 4,000
# BERT steps)
TRAIN_MID = ["--world", "rich", "--vocab_size", "16384", "--hidden", "256",
             "--heads", "8", "--clip_text_layers", "12", "--bert_layers",
             "4", "--batch", "256", "--seed", "0"]
TRAIN_CUTS = ["--train_n", "2048", "--val_n", "256", "--clip_steps", "50",
              "--bert_steps", "50"]


def phase_train_layer_norm(gen) -> None:
    """The LayerNorm Function on the card (the kernel forward, launch
    counted, then the reference's backward) against the same on the CPU
    (the plain forward and backward), fp32 and bf16 x, fp32 scale and
    bias."""
    for dtype in (torch.float32, torch.bfloat16):
        for feat, rows in TRAIN_LN_SHAPES:
            x = (torch.randn(rows, feat, device=DEVICE, generator=gen) * 3
                 + 1).to(dtype)
            scale = torch.rand(feat, device=DEVICE, generator=gen) + 0.5
            bias = torch.randn(feat, device=DEVICE, generator=gen)
            dy = torch.randn(rows, feat, device=DEVICE,
                             generator=gen).to(dtype)
            out = {}
            for dev in (DEVICE, "cpu"):
                xs = [t.detach().to(dev).requires_grad_()
                      for t in (x, scale, bias)]
                reset_launches()
                y = layer_norm(*xs, 1e-5)
                launches = layer_norm.launches
                y.backward(dy.to(dev))
                out[dev] = [y.detach().cpu()] + [t.grad.cpu() for t in xs]
                want = 1 if dev == DEVICE else 0
                if (type(y.grad_fn).__name__ != "LayerNormFunctionBackward"
                        or launches != want):
                    raise AssertionError(
                        f"layer_norm under grad on {dev}: grad_fn "
                        f"{type(y.grad_fn).__name__}, {launches} launches")
            (y, dx, ds, db), (y0, dx0, ds0, db0) = out[DEVICE], out["cpu"]
            y_err = float((y.float() - y0.float()).abs().max())
            y_ulp = float(((y.float() - y0.float()).abs() / (
                BF16_ULP * y0.float().abs().clamp(min=1.0))).max())
            dx_err = (dx.float() - dx0.float()).abs()
            dx_tol = (TRAIN_DX_REL[dtype] * dx0.float().abs()
                      + 1e-5 * float(dx0.float().abs().max()))
            sums = [float((a - b).abs().max() / b.abs().max())
                    for a, b in ((ds, ds0), (db, db0))]
            say(f"train layer_norm [{str(dtype)[6:]}, F={feat}, rows={rows}]"
                f": y max |diff| {y_err:.3g} ({y_ulp:.3g} bf16 ulp); dx "
                f"max |diff| {float(dx_err.max()):.3g}, worst share of its "
                f"tolerance {float((dx_err / dx_tol).max()):.3g}; dscale, "
                f"dbias max |diff| / max {sums[0]:.3g}, {sums[1]:.3g} "
                f"(limit {TRAIN_SUM_REL:g})")
            y_ok = (y_ulp <= BF16_ULPS["layer_norm"]
                    if dtype == torch.bfloat16 else y_err <= FP32_ATOL)
            if (not y_ok or bool((dx_err > dx_tol).any())
                    or max(sums) > TRAIN_SUM_REL):
                raise AssertionError("the LayerNorm Function on the card "
                                     "strays from the CPU's")


def phase_train_step() -> None:
    """One fp32 step of a tiny CLIP and a tiny BERT on the card and on the
    CPU from the same parameters, batch and masks: losses, the global
    gradient norm and every parameter's gradient norm within their
    tolerances; the word table's, the token table's and the patch
    embedding's gradients (below the first LayerNorm) non-zero."""
    with tempfile.TemporaryDirectory() as staging:
        world = train_tiny.build_world(64, 0, 256, False, staging)
    args = train_tiny.parse_args(["--hidden", "64", "--heads", "2",
                                  "--bert_layers", "2",
                                  "--clip_text_layers", "2"])
    bert_cfg, clip_cfg = train_tiny.tower_configs(args, world)
    bert, clip = train_tiny.build_towers(bert_cfg, clip_cfg,
                                         torch.device("cpu"), torch.float32,
                                         seed=0)
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(rng.randint(0, 64, size=16).astype(np.int32))
    special = torch.tensor(world.special_ids, dtype=torch.int32)
    data = train_tiny.DeviceData(world, 64, torch.device("cpu"))
    m = train_tiny.mlm_mask(data.wp_ids[idx], data.wp_mask[idx], special,
                            torch.Generator().manual_seed(0))
    below = {"clip": ("text_model.token_embedding",
                      "vision_model.patch_embedding"),
             "bert": ("embeddings.word",)}
    for name, model in (("clip", clip), ("bert", bert)):
        got = {}
        for dev in ("cpu", DEVICE):
            mod = copy.deepcopy(model).to(dev)
            d = train_tiny.DeviceData(world, 64, torch.device(dev))
            i = idx.to(dev)
            reset_launches()
            if name == "clip":
                loss = train_tiny.clip_loss(mod, d.pixels_of(i),
                                            d.clip_ids[i], d.clip_mask[i])
            else:
                loss = train_tiny.bert_loss(mod, d.wp_ids[i], d.wp_mask[i],
                                            m.to(dev),
                                            world.wp.mask_token_id)
            names, params = zip(*mod.named_parameters())
            grads = torch.autograd.grad(loss, params)
            got[dev] = dict(loss=float(loss.detach()),
                            launches=layer_norm.launches,
                            norm=float(train_optim.global_norm(grads)),
                            each={n: float(g.norm())
                                  for n, g in zip(names, grads)})
        a, b = got[DEVICE], got["cpu"]
        share = {n: abs(a["each"][n] - b["each"][n]) / (TRAIN_GRAD_REL * (
            b["each"][n] + 1e-3 * b["norm"])) for n in b["each"]}
        worst_name = max(share, key=share.get)
        worst = share[worst_name]
        say(f"train step [tiny {name}, fp32, card against CPU]: loss "
            f"{a['loss']:.7g} / {b['loss']:.7g}, global gradient norm "
            f"{a['norm']:.7g} / {b['norm']:.7g}; parameter gradient norms: "
            f"worst share of the tolerance {worst:.3g} ({worst_name}: "
            f"{a['each'][worst_name]:.4g} / {b['each'][worst_name]:.4g}); "
            f"gradient norms below the first LayerNorm "
            f"{ {n: round(a['each'][n], 6) for n in below[name]} }; "
            f"layer_norm launches {a['launches']}")
        if (abs(a["loss"] / b["loss"] - 1) > TRAIN_LOSS_REL
                or abs(a["norm"] / b["norm"] - 1) > TRAIN_GRAD_REL
                or worst > 1.0 or a["launches"] <= 0
                or any(a["each"][n] <= 0 for n in below[name])):
            raise AssertionError(f"the tiny {name} step on the card strays "
                                 f"from the CPU's")


def train_ln_shapes(clip_cfg, bert_cfg, B: int, S_wp: int
                    ) -> Dict[str, List[tuple]]:
    """(rows, features) of every LayerNorm call of one forward of a CLIP
    step and of a BERT step: the vision tower (pre, two a block, post on
    the class row), the text tower (two a block, the last block's second
    and the final one on the pooled row) and BERT (embeddings, two a
    block, the MLM head's)."""
    v, t = clip_cfg.vision, clip_cfg.text
    clip = ([(B * v.seq_len, v.hidden_size)] * (2 * v.num_layers + 1)
            + [(B, v.hidden_size)]
            + [(B * train_tiny.CLIP_LEN, t.hidden_size)]
            * (2 * t.num_layers - 1) + [(B, t.hidden_size)] * 2)
    bert = [(B * S_wp, bert_cfg.hidden_size)] * (2 * bert_cfg.num_layers + 2)
    return dict(clip=clip, bert=bert)


def train_ln_ms(shapes: List[tuple], gen) -> tuple:
    """Device ms of one step's LayerNorm forward kernels and of their
    plain backward (bf16 x, fp32 scale and bias, as the trainer's), each
    call timed at its shape."""
    fwd = bwd = 0.0
    with torch.no_grad():
        for rows, feat in shapes:
            x = torch.randn(rows, feat, device=DEVICE, generator=gen).to(
                torch.bfloat16)
            dy = torch.randn_like(x)
            scale = torch.rand(feat, device=DEVICE, generator=gen) + 0.5
            bias = torch.randn(feat, device=DEVICE, generator=gen)
            fwd += time_ms(lambda: layer_norm(x, scale, bias, 1e-5), 20)
            bwd += time_ms(lambda: layer_norm_backward_plain(x, scale, dy,
                                                             1e-5), 20)
    return fwd, bwd


def check_train_ln(shapes: List[tuple], gen) -> None:
    """The LayerNorm kernel against its plain version on the same card
    tensors at each (rows, features) a training step gives it (bf16 x, fp32
    scale and bias), to phase 2's bound: BF16_ULPS['layer_norm'] bf16 ulps
    of max(|plain|, 1)."""
    with torch.no_grad():
        for rows, feat in sorted(set(shapes)):
            x = (torch.randn(rows, feat, device=DEVICE, generator=gen) * 3
                 + 1).to(torch.bfloat16)
            scale = torch.rand(feat, device=DEVICE, generator=gen) + 0.5
            bias = torch.randn(feat, device=DEVICE, generator=gen)
            y = layer_norm(x, scale, bias, 1e-5).float()
            y0 = layer_norm_plain(x, scale, bias, 1e-5).float()
            diff = (y - y0).abs()
            ulp = float((diff / (BF16_ULP * y0.abs().clamp(min=1.0))).max())
            say(f"train layer_norm [kernel against plain, bf16, rows={rows},"
                f" F={feat}]: max |diff| {float(diff.max()):.3g}, {ulp:.3g} "
                f"bf16 ulp (limit {BF16_ULPS['layer_norm']})")
            if ulp > BF16_ULPS["layer_norm"]:
                raise AssertionError(f"layer_norm at ({rows}, {feat}) "
                                     f"strays from its plain version")


def trained_tiny_ln_shapes() -> Dict[str, List[tuple]]:
    """train_ln_shapes at trained_tiny/'s recorded arguments (the trainer's
    default widths, B and the WordPiece row length from its meta)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "trained_tiny", "conzic_tiny.json")) as f:
        meta = json.load(f)["meta"]
    args = train_tiny.parse_args([])
    bert_cfg = train_tiny.small_bert_config(
        meta["dataset"]["wp_vocab"], hidden=args.hidden, heads=args.heads,
        layers=args.bert_layers)
    clip_cfg = train_tiny.small_clip_config(  # eos id: no shape reads it
        meta["dataset"]["bpe_vocab"], 0, text_layers=args.clip_text_layers,
        hidden=args.hidden, heads=args.heads)
    return train_ln_shapes(clip_cfg, bert_cfg, meta["args"]["batch"],
                           meta["dataset"]["wp_seq"])


def phase_train_full() -> dict:
    """The trainer's command (``conzic_torch.train.tiny.main``) at
    trained_mid/'s arguments with the data and the steps cut: steps/s per
    tower, the mean loss of its first and last chunk (it must fall),
    LayerNorm launches (the towers' structure: forward kernel only, the
    backward is plain) and peak memory; then the saved directory through
    ``Captioner.from_tiny_dir`` on the card, two rendered scenes
    captioned at k=16."""
    out = scratch_dir("train_mid")
    argv = TRAIN_MID + TRAIN_CUTS + ["--out", out, "--device", DEVICE]
    say(f"train [trained_mid's arguments]: {' '.join(TRAIN_MID)}; cut: "
        f"{' '.join(TRAIN_CUTS)} (trained_mid: train_n 16384, val_n 512, "
        f"clip_steps 6000, bert_steps 4000)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    res = train_tiny.main(argv)
    wall = time.perf_counter() - t
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    bert_cfg, _, clip_cfg, _, doc = load_tiny_checkpoint(out)
    shapes = train_ln_shapes(clip_cfg, bert_cfg,
                             doc["meta"]["args"]["batch"],
                             doc["meta"]["dataset"]["wp_seq"])
    per_step = {t: len(shapes[t]) for t in shapes}
    steps = {t: res[t]["steps"] for t in ("clip", "bert")}
    train_want = sum(steps[t] * per_step[t] for t in steps)
    # validation: the vision and text towers once each, the text tower
    # again on the shuffled captions, BERT once
    n_vision = 2 * clip_cfg.vision.num_layers + 2
    val_want = (per_step["clip"] + per_step["clip"] - n_vision
                + per_step["bert"])
    want = dict.fromkeys(WRAPPERS, 0)
    want["layer_norm"] = train_want + val_want
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    tiny_shapes = trained_tiny_ln_shapes()
    check_train_ln(shapes["clip"] + shapes["bert"] + tiny_shapes["clip"]
                   + tiny_shapes["bert"], gen)
    for tower in ("clip", "bert"):
        r = res[tower]
        step_ms = 1e3 * r["seconds"] / r["steps"]
        fwd, bwd = train_ln_ms(shapes[tower], gen)
        say(f"train [{tower}]: {r['steps']} steps in {r['seconds']:.3f} s, "
            f"{r['steps'] / r['seconds']:.4f} steps/s ({step_ms:.3f} ms a "
            f"step); chunk mean loss first {r['losses'][0]:.4f}, last "
            f"{r['losses'][-1]:.4f}; layer_norm launches a step "
            f"{per_step[tower]}; their device time a step: forward kernels "
            f"{fwd:.4f} ms, the plain backward {bwd:.4f} ms "
            f"({bwd / step_ms:.4f} of the step's wall time)")
    say(f"train: {wall:.3f} s of command, peak memory {peak_gib:.2f} GiB; "
        f"launches {launches}, the structure gives {want} ({train_want} in "
        f"training, {val_want} in validation); validation "
        f"{json.dumps(res['validation'])}; card {card_line()}")
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    if any(not r["losses"][-1] < r["losses"][0]
           for r in (res["clip"], res["bert"])):
        raise AssertionError("the training loss did not fall")
    cap = Captioner.from_tiny_dir(ConzicConfig(), out, device=DEVICE)
    images, _, _ = synthetic.build_dataset(2, seed=50, rich=True)
    res_cap = cap.run(cap.encode_images([Image.fromarray(a) for a in images]),
                      rng=np.random.RandomState(0),
                      **run_args(max_len=8, top_k=16, max_iter=2,
                                 order="sequential"))
    texts = res_cap.gen_texts_list[-2]
    say(f"train [saved, from_tiny_dir on the card, k=16]: {texts}")
    if len(texts) != 2 or not all(t.startswith("image of a ")
                                  for t in texts):
        raise AssertionError(f"the saved checkpoint's captions: {texts}")
    shutil.rmtree(out)
    return dict(launches=launches, per_step=per_step)


def phase_train() -> dict:
    phase_train_layer_norm(torch.Generator(device=DEVICE).manual_seed(10))
    phase_train_step()
    return phase_train_full()


# the keys of bench.py's JSON line, which conzic_torch.bench keeps
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_baseline_basis",
              "quality_bounded"}
# the label of the bench at its defaults (both routes: the label does not
# name the attention route, as in bench.py)
BENCH_LABEL = "captions/sec/chip len=10 iters=15 k=200 B=32"
# the studies' small size on the card: (flag, value) pairs
STUDY_SIZE = ["--n_images", "4", "--iters", "2", "--sentence_len", "5",
              "--k", "32"]
TRAINED_CELL_KEYS = {"caption_exact", "token_agreement", "best_cosine_delta",
                     "speedup", "session", "checkpoint", "tower_layers",
                     "best_cos_full", "best_cos_pruned", "attr_recall_full",
                     "attr_recall_pruned"}


def run_module(module: str, args: List[str], env: Optional[dict] = None,
               timeout: int = 600) -> str:
    """``python -m module args`` from this checkout, with the
    ``CONZIC_BENCH_*`` knobs of ``env`` only; its stdout, or an
    AssertionError with the tail of its output when it fails."""
    here = os.path.dirname(os.path.abspath(__file__))
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("CONZIC_BENCH_")}
    full.update(env or {})
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=here,
                       env=full, capture_output=True, text=True,
                       timeout=timeout)
    if p.returncode != 0:
        raise AssertionError(f"python -m {module} {' '.join(args)} exited "
                             f"{p.returncode}:\n{(p.stdout + p.stderr)[-4000:]}")
    return p.stdout


def phase_bench_tools() -> None:
    """``python -m conzic_torch.bench`` at its defaults under the xla and
    the pallas routes (the JSON line's keys, a positive value, the label
    of the settings that ran), then two studies on trained_tiny/ at a
    small size on the card: ``validate_pruning`` (one cell, its printed
    metrics) and ``trained_quality_cells`` (one job, into a scratch
    record: its schema and device)."""
    for attn in ("xla", "pallas"):
        t = time.perf_counter()
        out = run_module("conzic_torch.bench", [],
                         {"CONZIC_BENCH_ATTN": attn})
        line = json.loads(out.strip().splitlines()[-1])
        say(f"bench [{attn}]: {json.dumps(line)} "
            f"({time.perf_counter() - t:.1f} s)")
        assert set(line) == BENCH_KEYS, sorted(line)
        assert line["value"] > 0 and line["unit"] == "captions/sec", line
        assert line["metric"] == BENCH_LABEL, line["metric"]
    t = time.perf_counter()
    tiny = ["--lm_model", "trained_tiny", "--match_model", "trained_tiny"]
    out = run_module("conzic_torch.tools.validate_pruning",
                     [*tiny, "--prune_k", "5", *STUDY_SIZE])
    metrics = {}
    for row in out.splitlines():
        name, _, value = row.partition(":")
        if name in ("caption exact-match", "token agreement",
                    "best-cosine delta (full - pruned)", "speedup"):
            metrics[name] = float(value.strip().rstrip("%x"))
    assert len(metrics) == 4, out[-2000:]
    say(f"study validate_pruning [trained_tiny, prune_k 5, one cell]: "
        f"{metrics} ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    out_path = os.path.join(scratch_dir("studies"), "PRUNING_MATRIX.json")
    run_module("conzic_torch.tools.trained_quality_cells",
               ["--checkpoint", "trained_tiny", "--prune_k", "3",
                "--topk_mode", "exact", *STUDY_SIZE, "--out", out_path])
    with open(out_path) as f:
        matrix = json.load(f)
    (key, cell), = matrix["trained"]["cells"].items()
    assert key == "sequential/free/prune3", key
    assert set(cell) == TRAINED_CELL_KEYS, sorted(cell)
    assert matrix["trained"]["device"] == card_line(), matrix["trained"]
    say(f"study trained_quality_cells [trained_tiny, {key}]: "
        f"best_cosine_delta {cell['best_cosine_delta']:+.5f}, attr_recall "
        f"{cell['attr_recall_full']:.3f} -> {cell['attr_recall_pruned']:.3f}"
        f" ({time.perf_counter() - t:.1f} s)")
    shutil.rmtree(os.path.dirname(out_path))


PROFILE_GROUPS = (
    ("layer_norm kernel", ("layer_norm_kernel",)),
    ("masked_attention kernel", ("masked_attention_",)),
    ("attention_with_out kernel", ("attention_with_out_",)),
    ("attention_block kernels", ("attention_block_",)),
    ("matrix products", ("nvjet", "gemm", "sm90_", "cutlass", "xmma",
                         "Gemm", "imma")),
    ("concatenation", ("CatArray",)),
    ("sort (top-k)", ("sort", "Sort", "radix")),
    ("gather / index", ("gather", "index", "Index", "scatter")),
    ("reductions / softmax", ("reduce", "softmax", "Softmax")),
)


def phase_profile(cap: Captioner, embeds, label: str = "") -> None:
    """One iteration of the main path (or of ``cap.cfg``'s pruned tier)
    under torch.profiler: device time by kind of kernel, per Gibbs step,
    and the share of the window in which the device ran no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    L = MAIN["sentence_len"]
    args = run_args(max_len=L, top_k=MAIN["top_k"], order="sequential")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = cap.run(embeds, max_iter=1, rng=np.random.RandomState(42),
                      **args)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        say("profile: the profiler recorded no device time")
        return
    busy, reach = 0.0, spans[0][0]
    for start, end, _ in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    window = reach - spans[0][0]
    by_group, by_name = {}, {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in name for k in keys)), "other elementwise")
        by_group[group] = by_group.get(group, 0.0) + (end - start)
    total = sum(by_group.values())
    label = f"{label}, " if label else ""
    say(f"profile [{label}{cap.cfg.attn_impl}]: one iteration ({L} Gibbs "
        f"steps, B={embeds.shape[0]}) took "
        f"{res.elapsed_s:.3f} s under the profiler; device busy {busy / 1e3:.3f} ms of a "
        f"{window / 1e3:.3f} ms window, idle share {1 - busy / window:.4f}; "
        f"{len(spans)} kernels")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        say(f"profile: {label}{group}: {us / 1e3 / L:.3f} ms per Gibbs step "
            f"({us / total:.4f} of device time)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        say(f"profile kernel: {label}{us / 1e3 / L:.3f} ms/step "
            f"{name[:110]}")


# run with a checkout as the working directory: that checkout's own
# chip_smoke and package are the ones imported
TREE_RUN = """
import hashlib
import sys
import numpy as np
import torch
import chip_smoke as cs
reps, iters, what = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cs.build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cap = cs.full_captioner("bfloat16")
shape = cs.main_shape(cap)
v = cap.clip_model.config.vision
pixels = np.random.RandomState(0).rand(
    cs.MAIN["batch"], v.image_size, v.image_size,
    v.num_channels).astype(np.float32)
if what == "kernels":
    import time
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for case in cs.main_path_cases(shape, dtype, gen):
            line = (f"kernel {case.kernel} [{case.label}, {dtype}] "
                    f"ms={cs.time_ms(case.kernel_fn, 50):.5f}")
            if dtype == torch.bfloat16 and case.kernel in (
                    "attention_with_out", "attention_block"):
                # the wrapper's host time a call: 200 calls, no sync
                case.kernel_fn()
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(200):
                    case.kernel_fn()
                line += f" host_us={(time.perf_counter() - t) / 200 * 1e6:.2f}"
                torch.cuda.synchronize()
            print(line, flush=True)
    # the attention kernels' outputs on inputs made alike in every tree
    # (one fresh generator a case; the constructors' signatures since the
    # two fused kernels moved to the tensor cores), to show which of them
    # are unchanged bit for bit
    for dtype in (torch.bfloat16, torch.float32):
        for make, before, after in (
                ("attn_case", ("text suffix chunk", 800, 16, 24, 8, 64, True,
                               "reach"), (8, 25)),
                ("attn_case", ("prefix, N=801 G=3", 801, 16, 24, 8, 64, True,
                               "edge"), (8, 3)),
                ("attn_case", ("bert full rows", 32, 15, 15, 12, 64, False,
                               "reach"), ()),
                ("attn_case", ("S=100 causal", 2, 100, 100, 2, 64, True,
                               "edge"), ()),
                ("with_out_case", ("text suffix chunk", 800, 16, 24, 8, 64,
                                   512), (True, "reach")),
                ("with_out_case", ("N=7, lens 0..Sk", 7, 16, 24, 8, 64, 512),
                 (True, "edge")),
                ("with_out_case", ("D=24", 5, 16, 24, 2, 24, 40),
                 (True, "edge")),
                ("block_case", ("bert rows", 32, 15, 768, 12, False, None),
                 ()),
                ("block_case", ("causal, N=7", 7, 15, 768, 12, True, "edge"),
                 ()),
                ("block_case", ("S=100 causal", 2, 100, 64, 2, True, "edge"),
                 ())):
            gen = torch.Generator(device="cuda").manual_seed(0)
            case = getattr(cs, make)(*before, dtype, gen, *after)
            out = case.kernel_fn().float().cpu().numpy().tobytes()
            print(f"kernel {case.kernel} [{case.label}, {dtype}] output "
                  f"sha256 {hashlib.sha256(out).hexdigest()[:16]}",
                  flush=True)
else:
    for _ in range(reps):
        cs.phase_main(iters, cap, shape, pixels)
"""


def compare_trees(trees: List[str], reps: int, iters: int,
                  what: str) -> None:
    for tree in trees:
        out = subprocess.run(
            [sys.executable, "-c", TREE_RUN, str(reps), str(iters), what],
            cwd=tree, capture_output=True, text=True, timeout=1100)
        if out.returncode != 0:
            raise RuntimeError(f"the main path failed in {tree}:\n"
                               f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
        for line in out.stdout.splitlines():
            if "caps/s" in line or line.startswith("kernel "):
                say(f"tree {tree}: {line}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=15,
                    help="Gibbs iterations of the main-path run")
    ap.add_argument("--profile", nargs="*", default=None,
                    choices=KERNEL_IMPLS + tuple(
                        label for label, _, _ in NEW_MAIN_PATHS),
                    metavar="ROUTE",
                    help="also profile one iteration of the main path under "
                         "each attn_impl or new path named (pallas when "
                         "none is)")
    ap.add_argument("--trees", nargs="+", metavar="DIR",
                    help="only run the main path in each of these "
                         "checkouts, in this order, and print its caps/s")
    ap.add_argument("--reps", type=int, default=3,
                    help="runs of the main path per entry of --trees")
    ap.add_argument("--kernels", action="store_true",
                    help="with --trees: time each tree's kernels at the "
                         "main-path shapes (phase 2's times) instead")
    ap.add_argument("--worker", nargs=5, metavar=("KIND", "PORT", "RANK",
                                                  "WORLD", "OUT"),
                    help="one process of the multi-process runs (started "
                         "by this script)")
    ap.add_argument("--scale", action="store_true",
                    help="only the scale-out phase, over every card of the "
                         "machine (two or more)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.worker:
        kind, port, rank, world, out = args.worker
        return run_worker(kind, port, int(rank), int(world), out)
    t_start = time.perf_counter()
    card = card_line()
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    say(f"card: {card}")
    if args.trees:
        compare_trees(args.trees, args.reps, args.iters,
                      "kernels" if args.kernels else "main")
        return 0
    if args.scale:
        phase_scale(args.iters)
        say(card_line())
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    build_s = build.build_all()
    say(f"kernels built in {build_s:.2f} s from conzic_torch/csrc "
        f"({', '.join(build.SOURCES)})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    t = time.perf_counter()
    cap = full_captioner("bfloat16")
    shape = main_shape(cap)
    say(f"full-width captioner built in {time.perf_counter() - t:.2f} s; "
        f"main-path shapes {shape}")

    t = time.perf_counter()
    summary = phase_kernels(shape)
    say(f"phase kernels ok ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase_agreement()
    say(f"phase agreement ok ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase_control_agreement()
    phase_energy_terms()
    say(f"phase control agreement ok ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase_pruned_agreement()
    say(f"phase pruned agreement ok ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase_route_agreement()
    phase_mesh_agreement()
    phase_two_process_tiny()
    say(f"phase route and scale-out agreement ok "
        f"({time.perf_counter() - t:.1f} s)")

    v = cap.clip_model.config.vision
    pixels = np.random.RandomState(0).rand(
        MAIN["batch"], v.image_size, v.image_size,
        v.num_channels).astype(np.float32)
    L, seed = MAIN["sentence_len"], shape["seed_len"]
    main = {}
    for impl in KERNEL_IMPLS:
        t = time.perf_counter()
        if impl != cap.cfg.attn_impl:
            del cap
            torch.cuda.empty_cache()
            cap = full_captioner("bfloat16", impl)  # the same seeded weights
        main[impl] = phase_main(args.iters, cap, shape, pixels)
        same = float((main[impl]["result"].best_ids[:, seed:seed + L]
                      == main["pallas"]["result"].best_ids[:, seed:seed + L]
                      ).mean())
        say(f"phase main path [{impl}] ok ({time.perf_counter() - t:.1f} s); "
            f"{same:.4f} of its best caption ids equal the pallas run's")
        if args.profile is not None and impl in (args.profile or ["pallas"]):
            phase_profile(cap, main[impl]["embeds"])
        if impl == "pallas":
            t = time.perf_counter()
            controlled = phase_controlled(args.iters, cap, shape, pixels,
                                          main[impl])
            say(f"phase controlled main path ok "
                f"({time.perf_counter() - t:.1f} s)")
            t = time.perf_counter()
            phase_exact(cap, shape, pixels, main[impl], controlled)
            say(f"phase exact modes ok ({time.perf_counter() - t:.1f} s)")
            t = time.perf_counter()
            pruned = phase_pruned(args.iters, cap, shape,
                                  profile=args.profile is not None)
            say(f"phase pruned tiers ok ({time.perf_counter() - t:.1f} s)")
            torch.cuda.empty_cache()
    t = time.perf_counter()
    phase_hf_dir(cap, pixels)
    say(f"phase hf directory ok ({time.perf_counter() - t:.1f} s)")
    del cap
    torch.cuda.empty_cache()

    new_paths = {}
    for label, impl, tier in NEW_MAIN_PATHS:
        t = time.perf_counter()
        cap = full_captioner("bfloat16", impl, tier)
        new_paths[label] = phase_main(args.iters, cap, shape, pixels,
                                      label=label)
        if args.profile and label in args.profile:
            phase_profile(cap, new_paths[label]["embeds"], label)
        same = float((new_paths[label]["result"].best_ids[:, seed:seed + L]
                      == main["pallas"]["result"].best_ids[:, seed:seed + L]
                      ).mean())
        say(f"phase main path [{label}] ok ({time.perf_counter() - t:.1f} "
            f"s); {same:.4f} of its best caption ids equal the bf16 pallas "
            f"run's; {new_paths[label]['s_per_step']:.5f} s per Gibbs step "
            f"against pallas's {main['pallas']['s_per_step']:.5f}")
        del cap
        torch.cuda.empty_cache()
    t = time.perf_counter()
    phase_int8_matmul(shape)
    cap = full_captioner("bfloat16")
    phase_app(cap)
    phase_index(cap)
    del cap
    torch.cuda.empty_cache()
    # the split of phase 6's two processes, on threads of one process: two
    # replicas on the card
    cap = full_captioner("bfloat16")
    phase_mesh_main(args.iters, Captioner(
        cap.bert_model, cap.clip_model, cap.wp, cap.bpe, cap.cfg,
        mesh=make_mesh(2, devices=["cuda:0", "cuda:0"])), pixels,
        main["pallas"], "two replicas on cuda:0, one thread each")
    mesh_2d = phase_mesh_2d_main(MESH_2D_ITERS, cap, pixels)
    del cap
    torch.cuda.empty_cache()
    say(f"phase int8 product, app, index, two threads and the 2 x 2 mesh ok "
        f"({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase_fp32(pixels, main["pallas"]["result"], shape)
    say(f"phase fp32 ok ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    phase_trained()
    say(f"phase trained checkpoint ok ({time.perf_counter() - t:.1f} s)")

    # one generation of the main path's settings: phase_main checked that
    # pallas's counts are what the engine's structure gives
    t = time.perf_counter()
    cli = phase_cli_run(args.iters, main["pallas"]["launches"])
    phase_cli_multihost(cli, args.iters)
    phase_cli_demo()
    say(f"phase cli ok ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase_trained_precision()
    phase_trained_pruned()
    say(f"phase trained precision ok ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    train = phase_train()
    say(f"phase train ok ({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    phase_bench_tools()
    say(f"phase bench and tools ok ({time.perf_counter() - t:.1f} s); "
        f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, meta in KERNELS.items():
        s = summary[name]
        kernels.append(dict(
            name=name, **meta,
            launches=main[ROUTE_OF[name]]["launches"][name],
            launches_by_attn_impl={impl: run["launches"][name]
                                   for impl, run in main.items()},
            launches_cli_run=cli["launches"][name],
            launches_new_paths={label: run["launches"][name]
                                for label, run in new_paths.items()},
            launches_pruned={read: run["launches"][name]
                             for read, run in pruned.items()},
            launches_mesh_2x2=mesh_2d["launches"][name],
            launches_train=train["launches"][name],
            max_abs_err=s["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"],
            library_ms=s["library_ms"],
            **{k: v for k, v in s.items() if k.endswith("_ms")
               and k not in ("ms", "plain_ms", "bound_ms", "library_ms")}))
    say(card_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
