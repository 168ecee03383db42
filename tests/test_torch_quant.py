"""The int8 tier of the port (``conzic_torch/ops/quant.py``, ``--quant``)
against ``conzic_tpu``'s, on the CPU.

``int8_matmul`` on seeded inputs, against the reference's functions as its
engine runs them, compiled (XLA folds ``/ 127.0`` into a product with the
fp32 reciprocal there; op by op JAX divides): the int8 values and scales
of both quantizations and the int32 products are equal to the reference's; the
fp32 outputs lie within one fp32 ulp of them (``y * sx * sw`` in the same
order; the tolerance allows XLA another rounding). Captioning under
``int8`` and ``int8_all`` gives the reference's caption ids byte for byte
(the same fp32 towers, the reference's attention route). The tests of
``tests/test_quant.py`` are carried over, and one test states which
products each ``attn_impl`` quantizes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import port_captioner
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_tpu.models.bert import BertForMaskedLM as JaxBert
from conzic_tpu.models.clip import CLIPModel as JaxClip
from conzic_tpu.ops import quant as jax_quant
from conzic_torch.config import ATTN_IMPLS, ConzicConfig
from conzic_torch.engine.sampler import Captioner, tower_quants
from conzic_torch.models import layers
from conzic_torch.models.clip import CLIPTextTower
from conzic_torch.models.configs import CLIPConfig
from conzic_torch.ops import quant
from conzic_torch.ops.attention import AttnMask
from test_torch_engine import _base_pair, _embeds

# fp32 outputs: one ulp of the reference's (relative 2^-23, doubled)
FP32_RTOL = 2.0 ** -22


def _xw(seed, M=37, K=72, N=40):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    x[3] = 0.0  # a zero row: the 1e-8 floor of the scale
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    return x, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_matmul_matches_reference(seed):
    x, w = _xw(seed)
    xq_j, sx_j = jax.jit(jax_quant._quantize_rows)(jnp.asarray(x))
    wq_j, sw_j = jax.jit(jax_quant._quantize_cols)(jnp.asarray(w))
    xq, sx = quant._quantize_rows(torch.from_numpy(x))
    wq, sw = quant._quantize_cols(torch.from_numpy(w))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_j))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(sw_j))
    acc_j = jax.lax.dot_general(
        xq_j, wq_j, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    acc = quant.int_mm(xq, wq.t().contiguous())
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    want = np.asarray(jax.jit(jax_quant.int8_matmul)(jnp.asarray(x),
                                                      jnp.asarray(w)))
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FP32_RTOL, atol=0)


def test_int8_matmul_keeps_leading_axes():
    x, w = _xw(4, M=24)
    got = quant.int8_matmul(torch.from_numpy(x).reshape(2, 3, 4, 72),
                            torch.from_numpy(w))
    flat = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, 3, 4, 40)
    np.testing.assert_array_equal(got.reshape(24, 40).numpy(), flat.numpy())


def test_int8_matmul_error_bound():
    """tests/test_quant.py's bound, on the port."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
    w = torch.from_numpy((rng.randn(128, 256) * 0.05).astype(np.float32))
    ref = x @ w
    rel = float(torch.linalg.norm(quant.int8_matmul(x, w) - ref)
                / torch.linalg.norm(ref))
    assert rel < 0.02, rel


def test_tower_quants_mapping():
    assert tower_quants("none") == ("none", "none")
    assert tower_quants("int8") == ("none", "int8")
    assert tower_quants("int8_all") == ("int8", "int8")
    with pytest.raises(ValueError, match="unknown quant tier"):
        tower_quants("int8all")
    with pytest.raises(ValueError, match="quant"):
        ConzicConfig(quant="int4").validate()


def _quant_pair(tier):
    """(reference, port) captioners on test_torch_engine's tiny fp32
    towers, both quantized by ``tier``."""
    jc, _ = _base_pair("random")
    bq, cq = tower_quants(tier)
    jq = JaxCaptioner(
        JaxBert(jc.bert_model.config, dtype=jnp.float32, quant=bq),
        jc.params["bert"],
        JaxClip(jc.clip_model.config, dtype=jnp.float32, quant=cq),
        jc.params["clip"], jc.wp, jc.bpe, jc.cfg)
    return jq, port_captioner(jc, dtype="float32", quant=tier)


_QUANT_PAIRS = {}


def _cached_pair(tier):
    if tier not in _QUANT_PAIRS:
        _QUANT_PAIRS[tier] = _quant_pair(tier)
    return _QUANT_PAIRS[tier]


@pytest.mark.parametrize("order", ["sequential", "shuffle"])
@pytest.mark.parametrize("tier", ["int8", "int8_all"])
def test_quantized_run_matches_reference(tier, order):
    jq, pq = _cached_pair(tier)
    embeds = _embeds("random", 2)
    args = dict(prompt="Image of a", temperature=0.1, alpha=0.02, beta=2.0,
                max_len=5, top_k=12, max_iter=2, order=order)
    want = jq.run(jnp.asarray(embeds), rng=np.random.RandomState(7), **args)
    got = pq.run(embeds, rng=np.random.RandomState(7), **args)
    np.testing.assert_array_equal(got.iter_ids, np.asarray(want.iter_ids))
    np.testing.assert_array_equal(got.best_ids, np.asarray(want.best_ids))
    assert got.gen_texts_list == want.gen_texts_list
    np.testing.assert_allclose(np.asarray(got.clip_score_sequence),
                               np.asarray(want.clip_score_sequence),
                               rtol=0, atol=1e-4)


def test_int8_generation_runs_and_is_actually_quantized():
    """tests/test_quant.py's wiring guard: the quantized captioners run,
    commit in-vocabulary tokens, keep cosines in [-1, 1], and differ from
    full precision."""
    runs = {}
    for tier in ("none", "int8", "int8_all"):
        cap = Captioner.from_random(
            ConzicConfig(dtype="float32", quant=tier, verbose=False), seed=5,
            device="cpu")
        embeds = np.random.RandomState(1).randn(
            2, cap.clip_model.config.projection_dim).astype(np.float32)
        runs[tier] = cap.run(
            embeds, prompt="Image of a", max_len=4, top_k=8, temperature=0.1,
            max_iter=2, alpha=0.02, beta=2.0, order="sequential",
            rng=np.random.RandomState(3))
        sent = runs[tier].iter_ids[-1][0][cap.seed_len("Image of a"):-1]
        assert all(0 <= t < cap.wp.vocab_size for t in sent.tolist())
    for tier in ("int8", "int8_all"):
        assert np.all(np.isfinite(runs[tier].best_cos)), tier
        assert np.all(np.abs(runs[tier].best_cos) <= 1.0 + 1e-5), tier
    assert not np.array_equal(
        np.asarray(runs["none"].clip_score_sequence),
        np.asarray(runs["int8"].clip_score_sequence))


def test_quant_tiers_change_the_right_towers():
    """int8 changes the CLIP text embeddings and leaves BERT as it is;
    int8_all changes both; the image tower is never quantized."""
    caps = {tier: Captioner.from_random(
        ConzicConfig(dtype="float32", quant=tier), seed=5, device="cpu")
        for tier in ("none", "int8", "int8_all")}
    ids = torch.arange(8)[None] + 3
    side = caps["none"].clip_model.config.vision.image_size
    pixels = torch.from_numpy(np.random.RandomState(2).rand(
        1, side, side, 3).astype(np.float32))

    def outs(cap):
        with torch.inference_mode():
            return (cap.bert_model(ids), cap.clip_model.encode_text(ids),
                    cap.clip_model.encode_image(pixels))

    none, int8, int8_all = (outs(caps[t]) for t in ("none", "int8",
                                                      "int8_all"))
    assert torch.equal(none[0], int8[0])
    assert not torch.equal(none[1], int8[1])
    assert not torch.equal(none[0], int8_all[0])
    assert not torch.equal(none[1], int8_all[1])
    assert torch.equal(none[2], int8[2]) and torch.equal(none[2], int8_all[2])


def test_quant_param_trees_identical_to_fp():
    """Quantization happens at run time: the parameters of every tier are
    the same, so full-precision checkpoints load as they are."""
    sds = [Captioner.from_random(ConzicConfig(dtype="float32", quant=tier),
                                 seed=5, device="cpu")
           for tier in ("none", "int8_all")]
    a = {**sds[0].bert_model.state_dict(), **{
        "clip." + k: v for k, v in sds[0].clip_model.state_dict().items()}}
    b = {**sds[1].bert_model.state_dict(), **{
        "clip." + k: v for k, v in sds[1].clip_model.state_dict().items()}}
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_weight_quantization_is_kept_until_the_weight_changes():
    lin = layers.Linear(16, 8, quant="int8")
    torch.nn.init.normal_(lin.weight)
    torch.nn.init.normal_(lin.bias)
    first = lin.quantized_weight()
    assert lin.quantized_weight() is first
    with torch.no_grad():
        lin.weight.mul_(2.0)  # in place: a new version
    assert lin.quantized_weight() is not first
    lin.weight.data = lin.weight.data.clone()  # another storage
    second = lin.quantized_weight()
    assert second is not first and lin.quantized_weight() is second


class _Record:
    """Counts, per call site, the products and attention forms a forward
    takes: which ``Linear``s multiply in int8 and which in float, and how
    often each attention function runs."""

    def __init__(self, monkeypatch):
        self.int8, self.float = set(), set()
        self.calls = {}
        rec = self
        orig = layers.Linear.forward

        def forward(lin, x):
            (rec.int8 if lin.quant == "int8" else rec.float).add(id(lin))
            return orig(lin, x)

        monkeypatch.setattr(layers.Linear, "forward", forward)
        for name in ("attention_block", "attention_with_out",
                     "masked_attention", "xla_attention",
                     "two_block_prefix_attention"):
            fn = getattr(layers, name)

            def counted(*a, _fn=fn, _name=name, **kw):
                rec.calls[_name] = rec.calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(layers, name, counted)


def _names(module, ids):
    return sorted(n for n, m in module.named_modules() if id(m) in ids)


@pytest.mark.parametrize("attn_impl", ATTN_IMPLS)
def test_which_products_each_route_quantizes(attn_impl, monkeypatch):
    """A quantized text tower over a suffix with prefix K/V (the engine's
    candidate pass) and over full rows. Every route multiplies every
    projection and MLP in int8, but ``pallas_block``'s full-row blocks,
    which take the block kernel on the unquantized weights (the
    reference's ``use_block`` has no quant condition); ``pallas_out`` and
    ``twoblock`` leave their fused and two-block forms to the full-precision
    towers, so the masked-attention kernel (``pallas_out``) and the einsum
    form (``twoblock``) carry the quantized passes."""
    cfg = CLIPConfig.tiny().text
    torch.manual_seed(0)
    tower = CLIPTextTower(cfg, attn_impl=attn_impl, quant="int8")
    for p in tower.parameters():
        torch.nn.init.normal_(p, std=0.02)
    rec = _Record(monkeypatch)
    B, G, P, S = 2, 3, 4, 6
    ids = torch.randint(1, cfg.vocab_size - 1, (B * G, S))
    ids[:, -1] = cfg.eos_token_id
    mask = torch.ones(B * G, S, dtype=torch.int32)
    with torch.inference_mode():
        _, kvs = tower(ids[::G, :P], return_kvs=True)
        tower(ids, mask, pos_offset=P, prefix_kvs=kvs)
        suffix = dict(rec.calls)
        tower(ids, mask)
    full = {k: v - suffix.get(k, 0) for k, v in rec.calls.items()}
    n = cfg.num_layers
    mha = ("query", "key", "value", "out")
    every = sorted(f"encoder.layers.{i}.{part}" for i in range(n)
                   for part in [f"attention.{m}" for m in mha]
                   + ["mlp.fc1", "mlp.fc2"])
    assert _names(tower, rec.int8) == every
    assert rec.float == set()  # nothing in the tower multiplies in float
    assert suffix.get("attention_with_out", 0) == 0
    assert suffix.get("two_block_prefix_attention", 0) == 0
    kernel_route = attn_impl.startswith("pallas")
    # the prefix pass (n) and the suffix pass (n), each one attention a
    # layer, through the kernel or the einsum form
    assert suffix.get("masked_attention" if kernel_route
                      else "xla_attention", 0) == 2 * n
    if attn_impl == "pallas_block":
        # all full-row blocks but the pooled last take the block kernel
        assert full == {"attention_block": n - 1, "masked_attention": 1}
    else:
        assert full == {("masked_attention" if kernel_route
                         else "xla_attention"): n}


def test_pallas_block_int8_runs_the_block_kernel_unquantized(monkeypatch):
    """The block kernel gets the stored weights cast to the compute type,
    not their int8 values."""
    rec = _Record(monkeypatch)
    mha = layers.MultiHeadAttention(2, 4, attn_impl="pallas_block",
                                    quant="int8")
    for p in mha.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(3, 5, 8)
    with torch.inference_mode():
        got = mha(x, AttnMask(), residual=x)
    assert rec.calls == {"attention_block": 1} and rec.int8 == set()
    ref = layers.MultiHeadAttention(2, 4, attn_impl="pallas")
    ref.load_state_dict(mha.state_dict())
    with torch.inference_mode():
        want = ref(x, AttnMask(), residual=x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
