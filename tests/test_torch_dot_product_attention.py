"""The library route's attention kernel (``csrc/dot_product_attention.cu``)
on the CPU: its plain version against the reference's formula bit for bit
at the cells' shapes, the dispatcher's rule at its edges, every attention
of the ``"xla"`` routes' BERT, CLIP and SigLIP towers through the
dispatcher (caption ids unchanged with the plain version in the kernel's
place in every call), and the two counters of a Gibbs step."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import one_torch_thread  # noqa: F401
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.sampler import Captioner
from conzic_torch.kernels.dot_product_attention import (
    fused_dot_product_attention,
)
from conzic_torch.models import layers
from conzic_torch.models.configs import SiglipConfig
from conzic_torch.ops import attention
from conzic_torch.ops.attention import fused_dot_product_attention_plain
from conzic_torch.runtime import profiling
from conzic_torch.text.unigram import SiglipTokenizer

SEED = 2 ** 31 + 23

# (N, Sq, Sk, H, D, causal, lens) at the cells' widths, few rows
SHAPES = {
    "siglip text layer": (3, 64, 64, 16, 72, False, None),
    "siglip pooled final layer": (3, 1, 64, 16, 72, False, None),
    # 8 prompt keys concatenated before 16 suffix keys
    "clip text, prefix concatenated": (6, 16, 24, 12, 64, True, "reach"),
    "clip pooled final layer": (6, 1, 24, 12, 64, False, "reach"),
    "bert with lens": (4, 15, 15, 12, 64, False, "reach"),
    "lens of 1": (5, 9, 33, 2, 40, False, "one"),
    "lens 0 to Sk, causal": (5, 7, 20, 2, 8, True, "edge"),
}


def draw(shape, dtype, gen):
    N, Sq, Sk, H, D, causal, mode = shape
    q, k, v = (torch.randn(N, S, H, D, generator=gen).to(dtype)
               for S in (Sq, Sk, Sk))
    lens = None
    if mode == "one":
        lens = torch.ones(N, dtype=torch.int32)
    elif mode is not None:
        lo = Sk - Sq + 1 if mode == "reach" else 0
        lens = torch.randint(lo, Sk + 1, (N,), generator=gen,
                             dtype=torch.int32)
        if mode == "edge":
            lens[0], lens[-1] = 0, Sk
    return q, k, v, lens, causal


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_twin_equals_the_library_formula(name, dtype):
    gen = torch.Generator().manual_seed(len(name))
    q, k, v, lens, causal = draw(SHAPES[name], dtype, gen)
    N, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    mask = attention.AttnMask(lens=lens, causal=causal)
    want = attention.dot_product_attention(
        q, k, v, attention.additive_bias(mask, N, Sq, Sk, q.device))
    got = fused_dot_product_attention_plain(q, k, v, lens, causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    # a tensor on the CPU takes the library formula
    assert torch.equal(attention.xla_attention(q, k, v, mask), want)


def qkv(Sq=4, Sk=8, D=72, dtype=torch.bfloat16, grad=False):
    q, k, v = (torch.zeros(2, S, 2, D, dtype=dtype, requires_grad=grad)
               for S in (Sq, Sk, Sk))
    return q, k, v


@pytest.mark.parametrize("change, fits", [
    ({}, True),
    (dict(Sk=128), True),
    (dict(Sk=129), False),
    (dict(D=72), True),
    (dict(D=70), False),
    (dict(D=128), True),
    (dict(D=136), False),
    (dict(Sq=8, Sk=8), True),
    (dict(Sq=9, Sk=8), False),
    (dict(dtype=torch.float32), False),
    (dict(grad=True), False),
])
def test_the_rule_at_its_edges(change, fits):
    q, k, v = qkv(**change)
    assert attention.fits_kernel(q, k, v) is fits
    # a tensor on the CPU never takes the kernel
    assert attention.kernel_takes(q, k, v) is False


def test_grad_mode_keeps_the_library_formula():
    q, k, v = qkv(grad=True)
    with torch.no_grad():
        assert attention.fits_kernel(q, k, v)
    with torch.inference_mode():
        assert attention.fits_kernel(*qkv())
    assert not attention.fits_kernel(q, k, v)
    assert attention.fits_kernel(q.detach(), k.detach(), v.detach())


def test_the_wrapper_refuses_a_tensor_on_the_cpu():
    # the dispatcher sends the kernel CUDA tensors only
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fused_dot_product_attention(*qkv())


# so400m's matcher at tiny widths: two layers of two heads of 72, the
# published head size; 12 x 12 patches, over the kernel's 128 keys, as
# so400m's 729
TINY_SIGLIP = dataclasses.replace(
    SiglipConfig.tiny(), vision=dataclasses.replace(
        SiglipConfig.tiny().vision, image_size=168))
ROW_CHUNK = 8  # two chunks of 2 images x 4 candidates a step


def siglip_captioner(dtype):
    cfg = ConzicConfig(dtype=dtype, attn_impl="xla", clip_len=64)
    cfg.clip_row_chunk = ROW_CHUNK
    cap = Captioner.from_random(cfg, clip_config=TINY_SIGLIP, seed=SEED,
                                device="cpu")
    gen = torch.Generator().manual_seed(5)
    return cap, 2 * torch.rand(2, 168, 168, 3, generator=gen) - 1


def clip_captioner(impl):
    cfg = ConzicConfig(attn_impl=impl)
    cfg.clip_row_chunk, cfg.clip_len = 16, 24
    cap = Captioner.from_random(cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    return cap, torch.rand(2, 64, 64, 3, generator=gen)


def generate(cap, pixels):
    emb = cap.encode_images(pixels)
    return cap.run(emb, prompt="Image of a", max_len=3, top_k=8,
                   temperature=0.1, max_iter=1, alpha=0.02, beta=2.0,
                   order="shuffle", rng=np.random.RandomState(3))


class Tally:
    """Counts the twin's calls in the kernel's place, the towers' attention
    passes (``MultiHeadAttention`` calls) and the two-block prefix form's,
    which the dispatcher never sees."""

    def __init__(self, monkeypatch):
        self.n = {"kernel": 0, "blocks": 0, "two_block": 0}
        n = self.n

        def kernel(*a, **kw):
            n["kernel"] += 1
            return fused_dot_product_attention_plain(*a, **kw)

        def counted(fn, key):
            def call(*a, **kw):
                n[key] += 1
                return fn(*a, **kw)
            return call

        monkeypatch.setattr(attention, "fused_dot_product_attention", kernel)
        monkeypatch.setattr(layers.MultiHeadAttention, "forward", counted(
            layers.MultiHeadAttention.forward, "blocks"))
        monkeypatch.setattr(layers, "two_block_prefix_attention", counted(
            layers.two_block_prefix_attention, "two_block"))


def ids_of(res):
    return np.asarray(res.iter_ids), np.asarray(res.best_ids)


@pytest.mark.parametrize("impl", ["xla", "xla_bhsd", "twoblock"])
def test_every_clip_and_bert_attention_reaches_the_dispatcher(impl,
                                                              monkeypatch):
    cap, px = clip_captioner(impl)
    want = ids_of(generate(cap, px))
    tally = Tally(monkeypatch)
    monkeypatch.setattr(attention, "kernel_takes", lambda q, k, v: True)
    got = ids_of(generate(cap, px))
    n = tally.n
    assert n["blocks"] > 0 and (n["two_block"] > 0) == (impl == "twoblock")
    assert n["kernel"] == n["blocks"] - n["two_block"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_every_siglip_attention_reaches_the_dispatcher(monkeypatch):
    cap, px = siglip_captioner("float32")
    assert isinstance(cap.bpe, SiglipTokenizer)
    want = ids_of(generate(cap, px))
    tally = Tally(monkeypatch)
    monkeypatch.setattr(attention, "kernel_takes", lambda q, k, v: True)
    got = ids_of(generate(cap, px))
    # every block, and the vision tower's pooling head once
    assert tally.n["kernel"] == tally.n["blocks"] + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_the_counters_of_a_gibbs_step(monkeypatch):
    """bf16 towers with the rule as on a card (the device aside, the plain
    version in the kernel's place): every attention of a Gibbs step (BERT's
    layers, SigLIP's text layers in each of two chunks) takes the kernel;
    the vision tower (144 keys) and the pooling head take the library
    formula, once a request. Caption ids as with the library formula
    everywhere."""
    cap, px = siglip_captioner("bfloat16")
    want = ids_of(generate(cap, px))
    tally = Tally(monkeypatch)
    monkeypatch.setattr(attention, "kernel_takes", attention.fits_kernel)
    profiling.take_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        got = ids_of(generate(cap, px))
    counts = profiling.take_counts()
    steps, chunks = 3, 2
    bert = cap.bert_model.config.num_layers
    text = cap.clip_model.config.text.num_layers
    vision = cap.clip_model.config.vision.num_layers
    assert counts[profiling.ATTENTION_KERNEL_CALLS] == tally.n["kernel"] == (
        steps * (bert + chunks * text))
    assert counts[profiling.ATTENTION_LIBRARY_CALLS] == vision + 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_the_counters_are_silent_without_a_profiler():
    cap, px = siglip_captioner("float32")
    profiling.take_counts()
    generate(cap, px)
    assert profiling.take_counts() == {}
