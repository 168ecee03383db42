"""The training path of ``conzic_torch`` against the JAX trainer's.

``conzic_torch.train`` ports ``tools/train_tiny.py``: the LayerNorm
Function's gradient against ``jax.grad`` through
``fused_layer_norm(interpret=True)``'s custom VJP; the optimizer against
optax's chain; the initialisers against flax's (distributions, not bits);
``to_jax_params`` as the inverse of ``from_jax_params``; the checkpoint
writer's files against the JAX package's own ``save_tiny_checkpoint``;
three CLIP and three BERT steps of the port's loop from the JAX trainer's
initial parameters and masks against a transcription of its loop (its
closures cannot be imported); and the command line's smoke run, whose
directory both packages' ``Captioner.from_pretrained`` caption alike.
"""

import argparse
import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import np_tree, port_bert_config, port_clip_config
from conzic_tpu.models import checkpoint as jax_checkpoint
from conzic_tpu.models.bert import BertForMaskedLM as JaxBert
from conzic_tpu.models.clip import CLIPModel as JaxCLIP
from conzic_tpu.models.configs import BertConfig as JaxBertConfig
from conzic_tpu.models.configs import CLIPConfig as JaxCLIPConfig
from conzic_tpu.models.configs import CLIPTextConfig as JaxTextConfig
from conzic_tpu.models.configs import CLIPVisionConfig as JaxVisionConfig
from conzic_tpu.ops.fused_ln import fused_layer_norm
from conzic_torch.kernels.layer_norm import layer_norm
from conzic_torch.models import checkpoint
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel
from conzic_torch.models.convert import (
    flax_ndim,
    from_jax_params,
    to_jax_params,
)
from conzic_torch.models.init import TRUNCATED_STD, init_params
from conzic_torch.models.layers import LayerNorm
from conzic_torch.train import optim, tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-5


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# ---------------------------------------------------------------------------
# the LayerNorm Function
# ---------------------------------------------------------------------------

LN_SHAPES = [(4, 3, 128), (37, 256), (2, 301, 768)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
def test_layer_norm_function_matches_the_fused_ln_vjp(shape, dtype):
    """dx, dscale and dbias of the port's Function against ``jax.vjp`` of
    the Pallas kernel in interpret mode (rows no multiple of its 256-row
    block): fp32 to 1e-5 relative, bf16 x to 2e-2 (the reference's own
    bar for its VJP, tests/test_trained_tiny.py)."""
    rng = np.random.RandomState(sum(shape))
    F_ = shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = (rng.rand(F_) + 0.5).astype(np.float32)
    bias = (rng.randn(F_) * 0.1).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jdy = jnp.asarray(x).astype(jdt), jnp.asarray(dy).astype(jdt)
    fused = functools.partial(fused_layer_norm, eps=EPS, interpret=True)
    y_ref, vjp = jax.vjp(fused, jx, jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdy)]

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y = layer_norm(tx, ts, tb, EPS)
    y.backward(torch.from_numpy(dy).to(tdt))
    got = [g.float().numpy() for g in (tx.grad, ts.grad, tb.grad)]
    assert tx.grad.dtype == tdt and ts.grad.dtype == torch.float32
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else
           dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(y_ref.astype(jnp.float32)), **tol)
    for g, w in zip(got, want):
        if dtype == "float32":
            # the sums over rows grow with the row count: relative to scale
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
        else:
            np.testing.assert_allclose(g, w, **tol)


def test_layer_norm_takes_the_function_only_under_grad():
    x = torch.randn(6, 32, requires_grad=True)
    ln = LayerNorm(32, EPS)
    y = ln(x)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    # a parameter that requires grad is enough
    y = ln(torch.randn(6, 32))
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    with torch.inference_mode():
        assert ln(x).grad_fn is None
    with torch.no_grad():
        assert ln(x).grad_fn is None
    plain = layer_norm(torch.randn(6, 32), torch.ones(32), torch.zeros(32),
                       EPS)
    assert plain.grad_fn is None


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

OPT_SHAPES = [(7, 5), (5,), (3, 4, 2), (), (16,), (9, 3)]


@pytest.mark.parametrize("lr,warmup,steps", [(0.1, 3, 10), (0.05, 20, 10)])
def test_adamw_matches_optax_chain(lr, warmup, steps):
    """10 updates from one random gradient sequence (every third step
    scaled up so that the clip acts), step 0's lr = 0 included: the
    parameters within 1e-6 relative of optax's after every step."""
    rng = np.random.RandomState(steps + warmup)
    init = [np.asarray(rng.randn(*s), np.float32) for s in OPT_SHAPES]
    grads = [[np.asarray(rng.randn(*s) * (8.0 if t % 3 == 2 else 0.1),
                         np.float32) for s in OPT_SHAPES]
             for t in range(steps)]
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=1e-4,
                                 mask=lambda p: [x.ndim >= 2 for x in p]))
    jp = [jnp.asarray(a) for a in init]
    state = tx.init(jp)
    params = [torch.from_numpy(a.copy()) for a in init]
    opt = optim.AdamW(params, [a.ndim >= 2 for a in init], lr=lr,
                      warmup=warmup, decay_steps=max(steps, warmup + 1))
    for t in range(steps):
        assert math.isclose(opt.lr_at(t), float(sched(t)), rel_tol=1e-6,
                            abs_tol=1e-12)
        g = [jnp.asarray(a) for a in grads[t]]
        norm = opt.step([torch.from_numpy(a) for a in grads[t]])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, w, a0 in zip(params, jp, init):
            np.testing.assert_allclose(p.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
            if t == 0:  # lr 0 at the first update
                np.testing.assert_array_equal(p.numpy(), a0)
    assert opt.count == steps


# ---------------------------------------------------------------------------
# initialisation, layout and the checkpoint writer
# ---------------------------------------------------------------------------


def _jax_configs():
    hidden, heads, layers, vocab, text_vocab = 64, 2, 2, 512, 600
    bert = JaxBertConfig(vocab_size=vocab, hidden_size=hidden,
                         num_layers=layers, num_heads=heads,
                         intermediate_size=4 * hidden,
                         max_position_embeddings=64)
    clip = JaxCLIPConfig(
        text=JaxTextConfig(vocab_size=text_vocab, hidden_size=hidden,
                           num_layers=layers, num_heads=heads,
                           intermediate_size=4 * hidden,
                           max_position_embeddings=77, eos_token_id=5),
        vision=JaxVisionConfig(hidden_size=hidden, num_layers=layers,
                               num_heads=heads, intermediate_size=4 * hidden,
                               image_size=32, patch_size=8),
        projection_dim=hidden // 2, logit_scale_init=2.6593)
    return bert, clip


@functools.lru_cache(maxsize=None)
def _jax_trees(seed=0):
    bert_cfg, clip_cfg = _jax_configs()
    key = jax.random.PRNGKey(seed)
    init_b = jax.jit(JaxBert(bert_cfg).init_params)
    init_c = jax.jit(JaxCLIP(clip_cfg).init_params)
    return (bert_cfg, np_tree(init_b(jax.random.fold_in(key, 0))),
            clip_cfg, np_tree(init_c(jax.random.fold_in(key, 1))))


def _port_towers(dtype=torch.float32):
    bert_cfg, _, clip_cfg, _ = _jax_trees()
    return (BertForMaskedLM(port_bert_config(bert_cfg), dtype=dtype),
            CLIPModel(port_clip_config(clip_cfg), dtype=dtype))


@pytest.mark.parametrize("tower", ["bert", "clip"])
def test_init_params_draws_flax_distributions(tower):
    """Per leaf: constants equal; drawn leaves' mean and std within five
    standard errors of the JAX draw's at the same shape, and the truncated
    leaves inside flax's cut, 2 / 0.8796 of their std."""
    bert_cfg, bert_tree, clip_cfg, clip_tree = _jax_trees()
    model = _port_towers()[0 if tower == "bert" else 1]
    want = bert_tree if tower == "bert" else clip_tree
    init_params(model, torch.Generator().manual_seed(1))
    got = to_jax_params(model)
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    for (path, g), (_, w) in pairs:
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if np.all(w == w.flat[0]):  # zeros, ones, logit_scale
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            continue
        n = w.size
        sd = w.std()
        assert abs(g.mean() - w.mean()) <= 5 * sd * math.sqrt(2 / n), path
        assert abs(g.std() / sd - 1) <= 5 / math.sqrt(n), path
        if np.abs(w).max() <= 2 / TRUNCATED_STD * sd * (1 + 5 / math.sqrt(n)):
            assert np.abs(g).max() <= (2 / TRUNCATED_STD * sd
                                       * (1 + 5 / math.sqrt(n))), path


@pytest.mark.parametrize("tower", ["bert", "clip"])
def test_to_jax_params_inverts_from_jax_params(tower):
    bert_cfg, bert_tree, clip_cfg, clip_tree = _jax_trees()
    model = _port_towers()[0 if tower == "bert" else 1]
    tree = bert_tree if tower == "bert" else clip_tree
    back = to_jax_params(from_jax_params(model, tree))
    pairs = list(zip(_leaves(back), _leaves(tree)))
    assert len(pairs) == len(_leaves(tree)) == len(_leaves(back))
    for (p, g), (q, w) in pairs:
        assert p == q and g.shape == w.shape and g.dtype == w.dtype, p
        assert g.tobytes() == w.tobytes(), p
    # the decay mask is the tree's ndim >= 2: the same elements
    decayed = sum(p.numel() for n, p in model.named_parameters()
                  if flax_ndim(n, p) >= 2)
    assert decayed == sum(w.size for _, w in _leaves(tree) if w.ndim >= 2)


@pytest.mark.parametrize("save_dtype", ["float32", "bfloat16"])
def test_save_tiny_checkpoint_is_the_reference_writer(tmp_path, save_dtype):
    """The port's directory equals the JAX package's for the same trees:
    the msgpack files byte for byte, the JSON document equal; and the JAX
    loader reads it back, leaves bit-equal, configs equal."""
    from conzic_torch.data import synthetic as syn

    bert_cfg, bert_tree, clip_cfg, clip_tree = _jax_trees()
    bert, clip = _port_towers()
    from_jax_params(bert, bert_tree)
    from_jax_params(clip, clip_tree)
    vocab = syn.make_tiny_wordpiece_vocab(bert_cfg.vocab_size)
    vp, mp = syn.make_word_bpe_files(list(vocab), str(tmp_path))
    meta = {"trainer": "test", "n": 3}
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    checkpoint.save_tiny_checkpoint(
        ours, port_bert_config(bert_cfg), bert, port_clip_config(clip_cfg),
        clip, vocab, vp, mp, meta=meta, save_dtype=save_dtype)
    jax_checkpoint.save_tiny_checkpoint(
        theirs, bert_cfg, bert_tree, clip_cfg, clip_tree, vocab, vp, mp,
        meta=meta, save_dtype=save_dtype)
    for name in ("bert.msgpack", "clip.msgpack", "vocab.txt",
                 "bpe_vocab.json", "bpe_merges.txt"):
        with open(os.path.join(ours, name), "rb") as a, open(
                os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(ours, "conzic_tiny.json")) as a, open(
            os.path.join(theirs, "conzic_tiny.json")) as b:
        assert json.load(a) == json.load(b)
    b_cfg, b_tree, c_cfg, c_tree, doc = jax_checkpoint.load_tiny_checkpoint(
        ours)
    assert b_cfg == bert_cfg and c_cfg == clip_cfg
    assert doc["save_dtype"] == save_dtype and doc["meta"] == meta
    cast = jnp.bfloat16 if save_dtype == "bfloat16" else jnp.float32
    for got, want in ((b_tree, bert_tree), (c_tree, clip_tree)):
        for (p, g), (_, w) in zip(_leaves(got), _leaves(want)):
            w = np.asarray(jnp.asarray(w).astype(cast))
            g = np.asarray(g)
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), p


# ---------------------------------------------------------------------------
# the slice: the port's loop against the JAX trainer's
# ---------------------------------------------------------------------------

# step 0's gradient, port against jax.grad, leaf by leaf (fp32 sums in
# another order)
GRAD_REL = 1e-4
SLICE = dict(train_n=24, vocab_size=256, batch=6, steps=3, lr=1e-3,
             warmup=1, hidden=32, heads=2, layers=2)


@functools.lru_cache(maxsize=None)
def _slice_world():
    import tempfile

    return tiny.build_world(SLICE["train_n"], 0, SLICE["vocab_size"], False,
                            tempfile.mkdtemp(prefix="conzic_train_test_"))


def _slice_configs(world):
    h = SLICE["hidden"]
    args = argparse.Namespace(intermediate=0, projection_dim=0, hidden=h,
                              heads=SLICE["heads"],
                              bert_layers=SLICE["layers"],
                              clip_text_layers=SLICE["layers"],
                              lr=SLICE["lr"], warmup=SLICE["warmup"])
    bert_cfg, clip_cfg = tiny.tower_configs(args, world)
    clip_cfg = dataclasses.replace(clip_cfg, vision=dataclasses.replace(
        clip_cfg.vision, num_layers=SLICE["layers"]))
    return args, bert_cfg, clip_cfg


def _jax_config(cfg):
    if hasattr(cfg, "text"):
        return JaxCLIPConfig(
            text=JaxTextConfig(**dataclasses.asdict(cfg.text)),
            vision=JaxVisionConfig(**dataclasses.asdict(cfg.vision)),
            projection_dim=cfg.projection_dim,
            logit_scale_init=cfg.logit_scale_init)
    return JaxBertConfig(**dataclasses.asdict(cfg))


def _jax_trainer(world, bert_cfg, clip_cfg, idx, masks):
    """tools/train_tiny.py:186-313 transcribed in fp32: its losses, its
    optax chain and its initial parameters; returns, for CLIP and BERT,
    (initial tree, each step's losses, final tree, step 0's gradient tree,
    the loss of step 0's batch after the last update)."""
    from conzic_tpu.runtime.image import CLIP_MEAN, CLIP_STD

    n = SLICE["train_n"]
    bert = JaxBert(_jax_config(bert_cfg), dtype=jnp.float32)
    clip = JaxCLIP(_jax_config(clip_cfg), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    bert_params = jax.jit(functools.partial(
        bert.init_params, seq_len=world.wp_ids.shape[1]))(
            jax.random.fold_in(key, 0))
    clip_params = jax.jit(clip.init_params)(jax.random.fold_in(key, 1))
    d_images = jnp.asarray(world.images[:n])
    d_cids, d_cmask = jnp.asarray(world.clip_ids[:n]), jnp.asarray(
        world.clip_mask[:n])
    d_wids, d_wmask = jnp.asarray(world.wp_ids[:n]), jnp.asarray(
        world.wp_mask[:n])
    mean, std = jnp.asarray(CLIP_MEAN), jnp.asarray(CLIP_STD)
    mask_id = world.wp.mask_token_id

    def pixels_of(i):
        return (d_images[i].astype(jnp.float32) / 255.0 - mean) / std

    def tx():
        steps, warmup = SLICE["steps"], SLICE["warmup"]
        sched = optax.warmup_cosine_decay_schedule(
            0.0, SLICE["lr"], warmup, max(steps, warmup + 1))
        return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            sched, weight_decay=1e-4,
            mask=lambda p: jax.tree.map(lambda x: x.ndim >= 2, p)))

    def clip_loss(params, i):
        img = clip.apply({"params": params}, pixels_of(i),
                         method=JaxCLIP.encode_image).astype(jnp.float32)
        txt = clip.apply({"params": params}, d_cids[i], d_cmask[i],
                         method=JaxCLIP.encode_text).astype(jnp.float32)
        img = img / jnp.linalg.norm(img, axis=-1, keepdims=True)
        txt = txt / jnp.linalg.norm(txt, axis=-1, keepdims=True)
        scale = jnp.exp(jnp.clip(params["logit_scale"], 0.0, jnp.log(100.0)))
        logits = scale * img @ txt.T
        labels = jnp.arange(logits.shape[0])
        li = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        lt = optax.softmax_cross_entropy_with_integer_labels(logits.T,
                                                             labels)
        return (li.mean() + lt.mean()) / 2

    def bert_loss(params, i, m):
        ids, att = d_wids[i], d_wmask[i]
        x = jnp.where(m, mask_id, ids)
        logits = bert.apply({"params": params}, x, att).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, ids)
        w = m.astype(jnp.float32)
        return (ce * w).sum() / jnp.maximum(w.sum(), 1.0)

    out = {}
    for name, params, loss_fn, extra in (
            ("clip", clip_params, clip_loss, [()] * SLICE["steps"]),
            ("bert", bert_params, bert_loss, [(m,) for m in masks])):
        t = tx()
        state = t.init(params)
        step = jax.jit(jax.value_and_grad(loss_fn))
        losses, p = [], params
        for s in range(SLICE["steps"]):
            loss, grads = step(p, jnp.asarray(idx[name][s]),
                               *[jnp.asarray(e) for e in extra[s]])
            if s == 0:
                grads0 = np_tree(grads)
            updates, state = t.update(grads, state, p)
            p = optax.apply_updates(p, updates)
            losses.append(float(loss))
        after = float(jax.jit(loss_fn)(p, jnp.asarray(idx[name][0]),
                                       *[jnp.asarray(e) for e in extra[0]]))
        out[name] = (np_tree(params), losses, np_tree(p), grads0, after)
    return out


def _jax_masks(world, idx):
    """The JAX trainer's mask draw (tools/train_tiny.py:281-292) for each
    BERT step's rows."""
    ids_all, att_all = world.wp_ids, world.wp_mask
    special = jnp.asarray(world.special_ids, jnp.int32)
    key = jax.random.PRNGKey(0)
    masks = []
    for s, i in enumerate(idx):
        ids, att = jnp.asarray(ids_all[i]), jnp.asarray(att_all[i])
        maskable = att.astype(bool) & ~jnp.isin(ids, special)
        k1, k2 = jax.random.split(jax.random.fold_in(key, s))
        rate = jax.random.uniform(k1, (ids.shape[0], 1), minval=0.15,
                                  maxval=1.0)
        masks.append(np.asarray(
            (jax.random.uniform(k2, ids.shape) < rate) & maskable))
    return masks


def _grad_tree(model, grads):
    """``grads`` (in ``model.parameters()`` order) in the flax layout."""
    tree = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(tree.parameters(), grads):
            p.copy_(g)
    return to_jax_params(tree)


def test_training_slice_matches_the_jax_trainer():
    """Three CLIP and three BERT steps in fp32 from the JAX trainer's
    initial parameters (carried over by from_jax_params), with its batch
    indices and its BERT masks: each step's loss and the loss after the
    last update within 1e-5 relative; step 0's gradient against jax.grad
    leaf by leaf, the norm of the difference within GRAD_REL of the leaf's
    norm plus GRAD_REL of the global norm's GRAD_REL (a leaf whose gradient
    is lost, or off by a factor, misses by a share of its own norm; the
    attention key biases' gradients are zero but for rounding); the final
    parameters within 2 Σ lr_t (Adam moves an element by at most about
    lr_t a step)."""
    world = _slice_world()
    args, bert_cfg, clip_cfg = _slice_configs(world)
    rng = np.random.RandomState(0)
    idx = {name: rng.randint(0, SLICE["train_n"],
                             size=(SLICE["steps"], SLICE["batch"]))
           for name in ("clip", "bert")}
    masks = _jax_masks(world, idx["bert"])
    assert sum(m.sum() for m in masks) > 0
    ref = _jax_trainer(world, bert_cfg, clip_cfg, idx, masks)

    data = tiny.DeviceData(world, SLICE["train_n"], torch.device("cpu"))
    bert = BertForMaskedLM(bert_cfg, dtype=torch.float32, attn_impl="xla")
    clip = CLIPModel(clip_cfg, dtype=torch.float32, attn_impl="xla")
    from_jax_params(clip, ref["clip"][0])
    from_jax_params(bert, ref["bert"][0])
    mask_id = world.wp.mask_token_id

    def loss_of(name, s):
        i = torch.from_numpy(idx[name][s])
        if name == "clip":
            return tiny.clip_loss(clip, data.pixels_of(i), data.clip_ids[i],
                                  data.clip_mask[i])
        return tiny.bert_loss(bert, data.wp_ids[i], data.wp_mask[i],
                              torch.from_numpy(masks[s].copy()), mask_id)

    losses = {"clip": [], "bert": []}
    grads0, after = {}, {}
    for name, model in (("clip", clip), ("bert", bert)):
        opt = tiny.make_optimizer(model, args, SLICE["steps"])
        for s in range(SLICE["steps"]):
            loss = loss_of(name, s)
            if s == 0:
                grads0[name] = _grad_tree(model, torch.autograd.grad(
                    loss, opt.params, retain_graph=True))
            losses[name].append(float(loss.detach()))
            tiny.train_step(opt, loss)
        with torch.no_grad():
            after[name] = float(loss_of(name, 0))
    total_lr = math.fsum(optim.warmup_cosine_decay(
        c, SLICE["lr"], SLICE["warmup"],
        max(SLICE["steps"], SLICE["warmup"] + 1))
        for c in range(SLICE["steps"]))
    assert total_lr > 0
    for name, model in (("clip", clip), ("bert", bert)):
        init_tree, want_losses, want_tree, want_grads, want_after = ref[name]
        np.testing.assert_allclose(losses[name], want_losses, rtol=1e-5)
        np.testing.assert_allclose(after[name], want_after, rtol=1e-5)
        assert after[name] != losses[name][0]
        want_norm = math.sqrt(math.fsum(
            float(np.sum(np.square(w, dtype=np.float64)))
            for _, w in _leaves(want_grads)))
        for (p, g), (_, w) in zip(_leaves(grads0[name]),
                                  _leaves(want_grads)):
            miss = float(np.linalg.norm(g - w))
            assert miss <= GRAD_REL * (np.linalg.norm(w)
                                       + GRAD_REL * want_norm), (
                name, str(p), miss, float(np.linalg.norm(w)), want_norm)
        moved = 0
        for (p, g), (_, w), (_, g0) in zip(_leaves(to_jax_params(model)),
                                           _leaves(want_tree),
                                           _leaves(init_tree)):
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * total_lr,
                                       err_msg=str(p))
            moved += int((g != g0).any())
        assert moved > 0


def test_trainer_refuses_to_overwrite_a_checkpoint(tmp_path):
    """--out naming a directory that holds a checkpoint (the default is
    the committed trained_tiny/) is refused before anything is built,
    unless --overwrite is given."""
    (tmp_path / "conzic_tiny.json").write_text("{}")
    with pytest.raises(SystemExit, match="--overwrite"):
        tiny.main(["--out", str(tmp_path), "--device", "cpu"])
    assert tiny.parse_args(["--out", str(tmp_path), "--overwrite"]).overwrite


def test_trainer_command_smoke_captions_alike_in_both_packages(tmp_path):
    """The command line's CPU smoke run writes a directory that
    ``conzic_tpu``'s and the port's ``Captioner.from_pretrained`` load to
    the same caption ids and texts, byte for byte."""
    out = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "conzic_torch.train.tiny", "--out", out,
         "--device", "cpu", "--smoke", "--train_n", "64", "--val_n", "16",
         "--batch", "8", "--clip_steps", "4", "--bert_steps", "4",
         "--chunk", "2"],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "steps/s" in r.stdout
    with open(os.path.join(out, "conzic_tiny.json")) as f:
        doc = json.load(f)
    assert doc["format"] == "conzic-flax-v1"
    assert doc["meta"]["trainer"] == "conzic_torch.train.tiny"
    assert doc["meta"]["backend"] == "cpu"
    assert doc["meta"]["validation"]["n_val"] == 16

    from conzic_tpu.config import ConzicConfig as JaxConfig
    from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
    from conzic_torch.config import ConzicConfig
    from conzic_torch.engine.sampler import Captioner

    jc = JaxCaptioner.from_pretrained(JaxConfig(
        dtype="float32", lm_model=out, match_model=out, verbose=False))
    pc = Captioner.from_pretrained(ConzicConfig(
        dtype="float32", lm_model=out, match_model=out, verbose=False),
        device="cpu")
    emb = np.random.RandomState(3).randn(
        2, jc.clip_model.config.projection_dim).astype(np.float32)
    args = dict(prompt="Image of a", max_len=4, top_k=16, temperature=0.1,
                max_iter=2, alpha=0.02, beta=2.0, order="sequential")
    want = jc.run(jnp.asarray(emb), rng=np.random.RandomState(0), **args)
    got = pc.run(emb, rng=np.random.RandomState(0), **args)
    np.testing.assert_array_equal(got.iter_ids, np.asarray(want.iter_ids))
    np.testing.assert_array_equal(got.best_ids, np.asarray(want.best_ids))
    assert got.gen_texts_list == want.gen_texts_list
