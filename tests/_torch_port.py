"""Helpers shared by the ``tests/test_torch_*.py`` files: carry a
``conzic_tpu`` model or captioner over to ``conzic_torch`` on the CPU.

Configs are rebuilt field by field and parameters travel as numpy arrays,
so the two packages never share an object.
"""

import dataclasses
import os
import tempfile

import jax
import numpy as np
import pytest

from conzic_torch.config import ConzicConfig as PortConfig
from conzic_torch.engine.sampler import Captioner as PortCaptioner
from conzic_torch.models import configs as port_configs
from conzic_torch.text.bpe import CLIPBPETokenizer as PortBPE
from conzic_torch.text.vocab import make_test_bpe_files as port_bpe_files
from conzic_torch.text.wordpiece import WordPieceTokenizer as PortWordPiece

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch work on one CPU thread. The tests' tensors
    are small; under the suite's parallel workers every process's pool of
    one thread per core contends for the cores, and a tiny run that takes
    half a second alone took 25 to 50 times longer so. Imported into a test
    module, this fixture applies to every test there."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TRAINED_TINY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "trained_tiny")


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def port_bert_config(cfg):
    return port_configs.BertConfig(**dataclasses.asdict(cfg))


def port_clip_config(cfg):
    return port_configs.CLIPConfig(
        text=port_configs.CLIPTextConfig(**dataclasses.asdict(cfg.text)),
        vision=port_configs.CLIPVisionConfig(**dataclasses.asdict(cfg.vision)),
        projection_dim=cfg.projection_dim,
        logit_scale_init=cfg.logit_scale_init,
    )


def port_captioner(jax_cap, bpe_dir=None, mesh=None, **cfg_kw):
    """The port's Captioner on the CPU with the weights and vocabularies of
    ``jax_cap``; ``bpe_dir`` holds the BPE files (the synthetic ones when
    None); ``mesh`` a mesh of CPU devices."""
    if bpe_dir is None:
        bpe = PortBPE.from_files(*port_bpe_files(tempfile.mkdtemp()))
    else:
        bpe = PortBPE.from_files(os.path.join(bpe_dir, "bpe_vocab.json"),
                                 os.path.join(bpe_dir, "bpe_merges.txt"))
    return PortCaptioner.from_jax_params(
        port_bert_config(jax_cap.bert_model.config),
        np_tree(jax_cap.params["bert"]),
        port_clip_config(jax_cap.clip_model.config),
        np_tree(jax_cap.params["clip"]),
        PortWordPiece(dict(jax_cap.wp.vocab)), bpe,
        PortConfig(**cfg_kw), device="cpu", mesh=mesh)


def carry_prune_tables(jax_cap, port_cap):
    """Put ``jax_cap``'s pruned-tier tables (the proxy's word embeddings,
    the factorized stage-1's projections) into ``port_cap``, with the
    calibration's cache key, resolved depth and held-out cosines, so that
    the port refits nothing: the two packages' towers build these tables
    equal only to the last bits."""
    port_cap.adopt_prune_tables(
        jax_cap.tables, getattr(jax_cap, "_stage1_meta", None),
        getattr(jax_cap, "stage1_calib_cos", None),
        getattr(jax_cap, "stage1_pc_calib_cos", None))
    port_cap.cfg.prune_stage1_layers = jax_cap.cfg.prune_stage1_layers


# a tiny SDAR (conzic_torch/models/sdar.py): 2 layers of 4 query and 2
# key/value heads of 16, 8 experts of 32, top 2, 4 held
SDAR_TINY_LM = dict(vocab_size=2048, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2,
                    head_dim=16, moe_intermediate_size=32, num_experts=8,
                    num_experts_per_tok=2, experts_held=4, expert_offset=0)
SDAR_TRAFFIC = {"images_per_request": 2, "samples": 1, "candidate_k": 8,
                "sentence_len": 3, "iterations": 1, "order": "shuffle",
                "prompt": "Image of a", "lm_temperature": 0.1,
                "alpha": 0.02, "beta": 2.0}


def sdar_tiny_config(**lm):
    """The benchmark's SDAR configuration (``conzic-sdar30b-l14``) at
    ``SDAR_TINY_LM`` with ``lm``'s changes, its CLIP at the benchmark
    tests' tiny widths, in fp32."""
    import json

    from bench_port.conftest import TINY_TEXT, TINY_VISION

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "bench_port", "configs",
                           "conzic-sdar30b-l14.json")) as f:
        cfg = json.load(f)
    cfg["lm"].update(SDAR_TINY_LM, **lm)
    cfg["match"]["projection_dim"] = 32
    cfg["match"]["text_config"].update(TINY_TEXT)
    cfg["match"]["vision_config"].update(TINY_VISION)
    cfg["run"]["dtype"] = "float32"
    return cfg


def sdar_tiny_captioner(seed=2 ** 31 + 23, **lm):
    """The port's Captioner on the CPU over :func:`sdar_tiny_config`, built
    by the benchmark's harness from its seeded weights."""
    from bench_port import inputs, system
    from bench_port.families import clip as clip_family
    from bench_port.families import sdar_moe as sdar_family

    cfg = sdar_tiny_config(**lm)
    fams = {"lm": sdar_family, "match": clip_family}
    vocab = {r: f.vocab(cfg) for r, f in fams.items()}
    spec = sdar_family.spec(cfg) + clip_family.spec(cfg)
    weights = inputs.make_weights(spec, seed, "cpu", cfg["weights"])
    return system.build(cfg, SDAR_TRAFFIC, fams, vocab, weights, "cpu")


def jax_tiny_captioner(text_layers=2, seed=3, **cfg_kw):
    """A ``conzic_tpu`` fp32 captioner with the tiny towers of
    ``init_mode="proper"`` (flax's own initialisers, compiled: run eagerly
    they take seconds a tower) over the synthetic vocabularies, as
    ``Captioner.from_random`` builds it, its CLIP text tower
    ``text_layers`` deep."""
    from conzic_tpu.config import ConzicConfig as JaxConfig
    from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
    from conzic_tpu.models.bert import BertForMaskedLM
    from conzic_tpu.models.clip import CLIPModel
    from conzic_tpu.models.configs import BertConfig as JaxBertConfig
    from conzic_tpu.models.configs import CLIPConfig as JaxCLIPConfig
    from conzic_tpu.text.bpe import CLIPBPETokenizer
    from conzic_tpu.text.vocab import (
        make_test_bpe_files,
        make_test_wordpiece_vocab,
    )
    from conzic_tpu.text.wordpiece import WordPieceTokenizer

    cfg = JaxConfig(dtype="float32", verbose=False, **cfg_kw)
    tmp = tempfile.mkdtemp(prefix="conzic_vocab_")
    vocab = make_test_wordpiece_vocab()
    with open(os.path.join(tmp, "vocab.txt"), "w", encoding="utf-8") as f:
        for tok in sorted(vocab, key=vocab.get):
            f.write(tok + "\n")
    wp = WordPieceTokenizer.from_vocab_file(os.path.join(tmp, "vocab.txt"))
    bpe = CLIPBPETokenizer.from_files(*make_test_bpe_files(tmp))
    clip_cfg = JaxCLIPConfig.tiny()
    clip_cfg = dataclasses.replace(clip_cfg, text=dataclasses.replace(
        clip_cfg.text, num_layers=text_layers,
        vocab_size=max(bpe.vocab_size, clip_cfg.text.vocab_size),
        eos_token_id=bpe.eos_token_id))
    bert = BertForMaskedLM(JaxBertConfig.tiny(vocab_size=wp.vocab_size))
    clip = CLIPModel(clip_cfg)
    key = jax.random.PRNGKey(seed)
    bert_params = jax.jit(bert.init_params)(jax.random.fold_in(key, 0))
    clip_params = jax.jit(clip.init_params)(jax.random.fold_in(key, 1))
    return JaxCaptioner(bert, bert_params, clip, clip_params, wp, bpe, cfg)


class PrunedPair:
    """A ``conzic_tpu`` captioner and, per ``attn_impl``, two fp32 ports of
    it on the CPU: ``own`` builds its own pruned-tier tables, ``carried``
    runs on the reference's (:func:`carry_prune_tables`)."""

    def __init__(self, jax_cap, make_port=None):
        """``make_port(attn_impl)``: a port captioner; by default
        :func:`port_captioner` over ``jax_cap``'s weights."""
        self.jax, self._make_port = jax_cap, make_port or (
            lambda attn_impl: port_captioner(
                jax_cap, dtype="float32", verbose=False,
                attn_impl=attn_impl))
        self._ports, self._want = {}, {}

    def ports(self, attn_impl="pallas"):
        if attn_impl not in self._ports:
            self._ports[attn_impl] = tuple(
                self._make_port(attn_impl) for _ in range(2))
        return self._ports[attn_impl]

    def check(self, cfg_kw, embeds, attn_impl="pallas", **run_kw):
        """Run the reference once per case (its result does not depend on
        the port's ``attn_impl``) and both ports, with the config fields
        ``cfg_kw`` set on all three, then restored. Every iteration's
        caption ids and the best ones must be identical, the cosines
        within 1e-4, and the factorized depth the same. Returns (reference,
        carried, own) results."""
        import jax.numpy as jnp

        own, carried = self.ports(attn_impl)
        caps = (self.jax, own, carried)
        saved = [{k: getattr(c.cfg, k) for k in cfg_kw} for c in caps]
        for c in caps:
            for k, v in cfg_kw.items():
                setattr(c.cfg, k, v)
        try:
            args = dict(prompt="Image of a", temperature=0.1, alpha=0.02,
                        beta=2.0, **run_kw)
            key = repr((sorted(cfg_kw.items()), embeds.shape,
                        sorted(run_kw.items())))
            if key not in self._want:
                self._want[key] = self.jax.run(
                    jnp.asarray(embeds), rng=np.random.RandomState(7),
                    **args)
            want = self._want[key]
            got_own = own.run(embeds, rng=np.random.RandomState(7), **args)
            own_depth = own.cfg.prune_stage1_layers
            carry_prune_tables(self.jax, carried)
            got = carried.run(embeds, rng=np.random.RandomState(7), **args)
            want_depth = self.jax.cfg.prune_stage1_layers
        finally:
            for c, old in zip(caps, saved):
                for k, v in old.items():
                    setattr(c.cfg, k, v)
        assert own_depth == want_depth
        for label, res in (("carried tables", got), ("own tables", got_own)):
            np.testing.assert_array_equal(res.iter_ids,
                                          np.asarray(want.iter_ids), label)
            np.testing.assert_array_equal(res.best_ids,
                                          np.asarray(want.best_ids), label)
            assert res.gen_texts_list == want.gen_texts_list, label
            np.testing.assert_allclose(
                np.asarray(res.clip_score_sequence),
                np.asarray(want.clip_score_sequence), rtol=0, atol=1e-4,
                err_msg=label)
        return want, got, got_own
