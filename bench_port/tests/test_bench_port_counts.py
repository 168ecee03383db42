"""Operations and bytes of the kernels and of a request, against values
worked out by hand at the cells' shapes."""

import json
from pathlib import Path

import pytest
import torch

from bench_port import run
from bench_port.counts import layer_norm, masked_attention
from bench_port.flops import request_flops as flops_of

PKG = Path(__file__).resolve().parents[1]


def request_flops(config, traffic):
    return flops_of(config, traffic, run.families(PKG.parent, config))


def load(sub, name):
    return json.loads((PKG / sub / f"{name}.json").read_text())


def attention_record(N, Sq, Ss, H, D, lens=None, causal=False, B=0, P=0):
    q = torch.empty(N, Sq, H, D, dtype=torch.bfloat16)
    kv = torch.empty(N, Ss, H, D, dtype=torch.bfloat16)
    prefix = (torch.empty(B, P, H, D, dtype=torch.bfloat16),) * 2 if P else None
    return masked_attention.record((q, kv, kv, lens, causal, prefix), {})


def test_text_suffix_chunk_full_rows():
    # 32 images x 25 candidates, 24 suffix positions over an 8-piece
    # prefix, causal: query i keeps i + 9 keys; sum over 24 queries = 492
    rec = attention_record(800, 24, 24, 8, 64, causal=True, B=32, P=8,
                           lens=torch.full((800,), 32, dtype=torch.int32))
    flops, n_bytes = masked_attention.cost(rec)
    assert flops == 4 * 492 * 800 * 8 * 64 == 806_092_800
    # q and out, k and v, the prefix once per image, the lengths
    assert n_bytes == (2 * 800 * 24 + 2 * 800 * 24 + 2 * 32 * 8) * 8 * 64 * 2 \
        + 4 * 800 == 79_170_688


def test_text_suffix_chunk_short_rows():
    # lens 20: queries 0..11 keep i + 9 (174 in all), 12..23 keep 20 (240)
    rec = attention_record(800, 24, 24, 8, 64, causal=True, B=32, P=8,
                           lens=torch.full((800,), 20, dtype=torch.int32))
    assert masked_attention.cost(rec)[0] == 4 * 414 * 800 * 8 * 64


def test_bert_self_attention():
    # 32 sentences of 15 tokens, 12 heads of 64, every pair kept
    rec = attention_record(32, 15, 15, 12, 64)
    flops, n_bytes = masked_attention.cost(rec)
    assert flops == 4 * 225 * 32 * 12 * 64 == 22_118_400
    assert n_bytes == (2 * 32 * 15 + 2 * 32 * 15) * 12 * 64 * 2 == 2_949_120


def test_layer_norm_text_chunk():
    x = torch.empty(800, 24, 512, dtype=torch.bfloat16)
    rec = layer_norm.record((x, torch.empty(512), torch.empty(512), 1e-5), {})
    flops, n_bytes = layer_norm.cost(rec)
    assert n_bytes == 2 * 800 * 24 * 512 * 2 + 2 * 512 * 4 == 39_325_696
    assert flops == 8 * 800 * 24 * 512


def test_request_flops_b32_batch32():
    # per step: BERT 83,340,656,640 (12 layers x 32 x 15 tokens, and the
    # MLM head at one slot); the text tower 13,613,976,780,800 (6,400 rows
    # x 28 suffix positions over the 4-piece prefix "Image of a", and the
    # projection); per request: the prefix 9,671,540,736 once and the
    # vision tower 282,163,937,280 (32 images x 50 tokens)
    got = request_flops(load("configs", "conzic-b32"), load("traffic",
                                                           "batch32"))
    want = 100 * (83_340_656_640 + 13_613_976_780_800) + 9_671_540_736 \
        + 282_163_937_280
    assert got == pytest.approx(want, rel=1e-12)
    assert got / 100 / 1e12 == pytest.approx(13.7002, abs=1e-4)


def test_request_flops_of_one_image_and_two_samples():
    cfg = load("configs", "conzic-b32")
    big = load("traffic", "batch32")
    one = dict(big, images_per_request=1, samples=2)
    # two samples of one image: the steps and prefix twice, the vision
    # tower once, each of them for 1 image in place of 32
    vision = 282_163_937_280
    assert request_flops(cfg, one) == pytest.approx(
        2 * (request_flops(cfg, big) - vision) / 32 + vision / 32,
        rel=1e-12)
