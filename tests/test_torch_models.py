"""The port's towers carry ``conzic_tpu``'s parameters and give its outputs.

Parameters go over with ``conzic_torch.models.convert.from_jax_params``.
Both tiny random towers and the ``trained_tiny/`` checkpoint are compared,
at fp32 on the CPU with tolerance 2e-4, the bar of tests/test_model_parity.py.
The port's towers are built under each ``attn_impl``; the JAX towers keep
their plain attention route, which is what their own ``pallas_out`` and
``pallas_block`` take on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import TRAINED_TINY, np_tree, port_bert_config, port_clip_config
from conzic_tpu.models import configs as jax_configs
from conzic_tpu.models.bert import BertForMaskedLM as JaxBert
from conzic_tpu.models.checkpoint import load_tiny_checkpoint
from conzic_tpu.models.clip import CLIPModel as JaxClip
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel
from conzic_torch.models.convert import from_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", params=["random", "trained_tiny"])
def towers(request):
    """(jax bert, params, port bert, jax clip, params, port clip)."""
    if request.param == "random":
        bc, cc = jax_configs.BertConfig.tiny(), jax_configs.CLIPConfig.tiny()
        bp = jax.jit(JaxBert(bc).init_params)(jax.random.PRNGKey(0))
        cp = jax.jit(JaxClip(cc).init_params)(jax.random.PRNGKey(1))
    else:
        bc, bp, cc, cp, _ = load_tiny_checkpoint(TRAINED_TINY)
        # the checkpoint is stored in bf16; compute in fp32 on both sides
        bp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), bp)
        cp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), cp)
    tb = from_jax_params(BertForMaskedLM(port_bert_config(bc)), np_tree(bp))
    tc = from_jax_params(CLIPModel(port_clip_config(cc)), np_tree(cp))
    return JaxBert(bc), bp, tb.eval(), JaxClip(cc), cp, tc.eval()


def _apply(model, params, *args, method=None, **kw):
    """``model.apply`` compiled once: eager flax runs op by op."""
    fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method,
                                            **kw))
    return fn(params, *(jnp.asarray(a) for a in args))


def _ids(rng, vocab, shape):
    return rng.randint(1, vocab, size=shape).astype(np.int32)


def _text_rows(rng, cfg, B, G, L, P):
    """(B, G, L) CLIP rows sharing their first P ids per image, each ending
    at a ragged EOS followed by padding, and their masks."""
    eos = cfg.text.eos_token_id
    ids = _ids(rng, min(cfg.text.vocab_size, 60), (B, G, L))
    ids[:, :, :P] = ids[:, :1, :P]
    mask = np.zeros((B, G, L), np.int32)
    for b in range(B):
        for g in range(G):
            e = P + 1 + (b * G + g) % (L - P - 1)
            ids[b, g, e] = eos
            ids[b, g, e + 1:] = 0
            mask[b, g, :e + 1] = 1
    return ids, mask


def test_bert_logits(towers):
    jb, bp, tb, *_ = towers
    rng = np.random.RandomState(0)
    ids = _ids(rng, jb.config.vocab_size, (3, 11))
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    want = np.asarray(_apply(jb, bp, ids, mask))
    with torch.no_grad():
        got = tb(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bert_pooled_hidden_and_lm_head(towers):
    """The final layer computed only at the masked slot (pool_idx)."""
    jb, bp, tb, *_ = towers
    rng = np.random.RandomState(1)
    ids = _ids(rng, jb.config.vocab_size, (3, 9))
    pool = np.array([[2], [5], [8]], np.int32)
    h = _apply(jb, bp, ids, pool_idx=jnp.asarray(pool),
               method=JaxBert.hidden)
    logits = _apply(jb, bp, h[:, 0], method=JaxBert.lm_head)
    with torch.no_grad():
        th = tb.hidden(torch.from_numpy(ids).long(),
                       pool_idx=torch.from_numpy(pool).long())
        tl = tb.lm_head(th[:, 0])
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), **TOL)
    assert tl.dtype == torch.float32


def test_clip_encode_text_and_shared_prefix(towers):
    *_, jc, cp, tc = towers
    B, G, L, P = 2, 3, 12, 4
    ids, mask = _text_rows(np.random.RandomState(2), jc.config, B, G, L, P)
    want = np.asarray(_apply(jc, cp, ids.reshape(B * G, L),
                             mask.reshape(B * G, L),
                             method=JaxClip.encode_text))
    with torch.no_grad():
        full = tc.encode_text(torch.from_numpy(ids.reshape(B * G, L)).long(),
                              torch.from_numpy(mask.reshape(B * G, L)))
        pref = tc.encode_text_shared_prefix(
            torch.from_numpy(ids[:, 0, :P]).long(),
            torch.from_numpy(ids[:, :, P:]).long(),
            torch.from_numpy(mask[:, :, P:]))
    np.testing.assert_allclose(full.numpy(), want, **TOL)
    # the property of tests/test_prefix_kv.py, on the port's own towers
    np.testing.assert_allclose(pref.numpy(), full.numpy(), rtol=0, atol=1e-5)


def test_clip_prefix_kvs_then_suffix_matches_jax(towers):
    *_, jc, cp, tc = towers
    B, G, L, P = 2, 2, 10, 3
    ids, mask = _text_rows(np.random.RandomState(3), jc.config, B, G, L, P)
    want = np.asarray(_apply(jc, cp, ids[:, 0, :P], ids[:, :, P:],
                             mask[:, :, P:],
                             method=JaxClip.encode_text_shared_prefix))
    with torch.no_grad():
        kvs = tc.text_prefix_kvs(torch.from_numpy(ids[:, 0, :P]).long())
        got = tc.encode_text_suffix(kvs, P, torch.from_numpy(ids[:, :, P:])
                                    .long(), torch.from_numpy(mask[:, :, P:]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_clip_encode_image_and_similarity(towers):
    *_, jc, cp, tc = towers
    rng = np.random.RandomState(4)
    v = jc.config.vision
    px = rng.rand(2, v.image_size, v.image_size, v.num_channels)
    px = px.astype(np.float32)
    img = np.array(_apply(jc, cp, px, method=JaxClip.encode_image))
    text = rng.randn(2 * 5, jc.config.projection_dim).astype(np.float32)
    probs, cos = _apply(jc, cp, img, text, method=JaxClip.similarity)
    with torch.no_grad():
        timg = tc.encode_image(torch.from_numpy(px))
        tprobs, tcos = tc.similarity(torch.from_numpy(img),
                                     torch.from_numpy(text))
    np.testing.assert_allclose(timg.numpy(), img, **TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), **TOL)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos), **TOL)


@pytest.fixture(scope="module", params=["pallas_out", "pallas_block"])
def fused_towers(request, towers):
    """``towers`` with the port's two rebuilt under a fused attn_impl on
    the same parameters."""
    jb, bp, _, jc, cp, _ = towers
    tb = from_jax_params(BertForMaskedLM(
        port_bert_config(jb.config), attn_impl=request.param), np_tree(bp))
    tc = from_jax_params(CLIPModel(
        port_clip_config(jc.config), attn_impl=request.param), np_tree(cp))
    return jb, bp, tb.eval(), jc, cp, tc.eval()


def test_fused_attn_impl_bert_logits(fused_towers):
    test_bert_logits(fused_towers)


def test_fused_attn_impl_clip_text(fused_towers):
    test_clip_encode_text_and_shared_prefix(fused_towers)
    test_clip_prefix_kvs_then_suffix_matches_jax(fused_towers)


def test_fused_attn_impl_clip_image(fused_towers):
    test_clip_encode_image_and_similarity(fused_towers)


def _check_pooled_hidden_at_several_rows(towers):
    jb, bp, tb, *_ = towers
    rng = np.random.RandomState(5)
    ids = _ids(rng, jb.config.vocab_size, (3, 10))
    pool = np.array([[2, 3, 4], [5, 6, 9], [0, 1, 7]], np.int32)
    h = _apply(jb, bp, ids, pool_idx=jnp.asarray(pool),
               method=JaxBert.hidden)
    logits = _apply(jb, bp, h, method=JaxBert.lm_head)
    tids, tpool = torch.from_numpy(ids).long(), torch.from_numpy(pool).long()
    with torch.no_grad():
        th = tb.hidden(tids, pool_idx=tpool)
        tl = tb.lm_head(th)
    assert th.shape == (3, 3, jb.config.hidden_size)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), **TOL)
    # with a padded row the pooled rows are those of the full encode: the
    # reference's own pooled path drops a padding mask on the CPU, so its
    # full encode, gathered, is the yardstick
    mask = np.ones_like(ids)
    mask[2, 8:] = 0
    full = np.asarray(_apply(jb, bp, ids, mask, method=JaxBert.hidden))
    with torch.no_grad():
        th = tb.hidden(tids, torch.from_numpy(mask), pool_idx=tpool)
    np.testing.assert_allclose(
        th.numpy(), np.take_along_axis(full, pool[:, :, None], axis=1), **TOL)


def test_bert_pooled_hidden_at_several_rows(towers):
    """The final layer computed at Q > 1 rows, as the span and parallel
    orders read it, with a padded row."""
    _check_pooled_hidden_at_several_rows(towers)


def test_fused_attn_impl_bert_pooled_hidden_at_several_rows(fused_towers):
    _check_pooled_hidden_at_several_rows(fused_towers)


def test_from_jax_params_refuses_a_wrong_tree(towers):
    jb, bp, tb, *_ = towers
    bad = np_tree(bp)
    bad["encoder"] = {k: v for k, v in bad["encoder"].items()
                      if k != "layer_0"}
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(tb, bad)
