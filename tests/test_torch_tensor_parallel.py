"""The (data, model) mesh of the port (``parallel/mesh.py``
``make_mesh_2d``, ``parallel/vocab.py``) against ``conzic_tpu``'s, on the
CPU.

The reference runs ``Captioner(mesh=make_mesh_2d(4, 2))`` on the 8
virtual devices of ``tests/conftest.py``: GSPMD cuts BERT's word table and
MLM bias along the vocabulary over the model axis. The port gets
``make_mesh_2d(4, 2, devices=["cpu"] * 8)``: one replica and one thread a
data row, each row's word table and bias cut in two. Both captioners carry
the same tiny fp32 towers over an even vocabulary (the synthetic one and a
pad token), and caption ids, best ids and texts must equal the reference's
and the one-device port's, byte for byte, in the case kinds of the
reference's multichip dry run (``__graft_entry__.py`` ``dryrun_multichip``)
and ragged batches of B-1 and B+1 rows. Also the mesh's layout and
refusals, the cutting rule against the reference's, the lookup bit for bit
and the head's logits.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import (
    carry_prune_tables,
    port_bert_config,
    port_captioner,
    port_clip_config,
)
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_tpu.models.bert import BertForMaskedLM as JaxBert
from conzic_tpu.models.clip import CLIPModel as JaxClip
from conzic_tpu.parallel import mesh as jax_mesh
from conzic_tpu.text.vocab import make_test_wordpiece_vocab
from conzic_torch.config import ConzicConfig
from conzic_torch.engine import sampler
from conzic_torch.engine.sampler import tower_quants
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel
from conzic_torch.models.configs import BertConfig
from conzic_torch.models.convert import from_jax_params
from conzic_torch.parallel import mesh as mesh_lib
from conzic_torch.parallel.vocab import VocabSplitBert, split_vocab

CPUS = ["cpu"] * 8
B = 4  # the data axis: one row a data row, as the reference's dry run
ARGS = dict(prompt="Image of a", temperature=0.1, alpha=0.02, beta=2.0,
            max_len=4, top_k=8)
# the split head's logits against the whole head's: the same fp32 products
# of a column block; the CPU's sgemm gave them bit for bit
LOGIT_ATOL = 1e-6


def _vocab(even=True):
    vocab = make_test_wordpiece_vocab()
    if (len(vocab) % 2 == 0) != even:
        vocab["zzpad"] = len(vocab)
    return vocab


_CAPS = {}


def _captioners(quant="none"):
    """(reference on one device, reference on the 4 x 2 mesh, port on one
    device, port on the 4 x 2 mesh of CPUs): the same tiny fp32 towers
    (``init_mode="proper"``, compiled) over an even vocabulary, quantized
    by ``quant``."""
    if quant not in _CAPS:
        cfg = JaxConfig(dtype="float32", verbose=False)
        fast = JaxCaptioner.from_random(config=cfg, seed=3,
                                        wp_vocab=_vocab())
        key = jax.random.PRNGKey(3)
        bp = jax.jit(fast.bert_model.init_params)(jax.random.fold_in(key, 0))
        cp = jax.jit(fast.clip_model.init_params)(jax.random.fold_in(key, 1))
        bq, cq = tower_quants(quant)

        def ref(mesh):
            return JaxCaptioner(
                JaxBert(fast.bert_model.config, dtype=jnp.float32, quant=bq),
                bp, JaxClip(fast.clip_model.config, dtype=jnp.float32,
                            quant=cq),
                cp, fast.wp, fast.bpe, JaxConfig(dtype="float32",
                                                 verbose=False), mesh=mesh)

        one = ref(None)
        _CAPS[quant] = (
            one, ref(jax_mesh.make_mesh_2d(4, 2)),
            port_captioner(one, dtype="float32", quant=quant),
            port_captioner(one, dtype="float32", quant=quant,
                           mesh=mesh_lib.make_mesh_2d(4, 2, devices=CPUS)))
    return _CAPS[quant]


def _embeds(n, seed=1):
    dim = _captioners()[0].clip_model.config.projection_dim
    return np.random.RandomState(seed).randn(n, dim).astype(np.float32)


def _same(got, want):
    np.testing.assert_array_equal(got.iter_ids, np.asarray(want.iter_ids))
    np.testing.assert_array_equal(got.best_ids, np.asarray(want.best_ids))
    assert got.gen_texts_list == want.gen_texts_list
    np.testing.assert_allclose(np.asarray(got.clip_score_sequence),
                               np.asarray(want.clip_score_sequence),
                               rtol=0, atol=1e-4)


def test_make_mesh_2d_layout_and_refusals():
    cards = [f"cuda:{i}" for i in range(8)]  # names only: nothing runs
    mesh = mesh_lib.make_mesh_2d(4, 2, devices=cards)
    ref = jax_mesh.make_mesh_2d(4, 2)
    assert ref.devices.shape == (4, 2)
    assert [[d.index for d in row] for row in mesh] == [
        [d.id for d in row] for row in ref.devices]
    assert mesh_lib.make_mesh_2d(2, 3, devices=cards) == [
        [torch.device("cuda", i) for i in (0, 1, 2)],
        [torch.device("cuda", i) for i in (3, 4, 5)]]
    assert mesh_lib.data_devices(mesh) == [torch.device("cuda", i)
                                           for i in (0, 2, 4, 6)]
    assert mesh_lib.mesh_rows([torch.device("cpu")] * 2) == [
        [torch.device("cpu")], [torch.device("cpu")]]
    assert mesh_lib.model_axis(mesh) == 2
    assert mesh_lib.model_axis(mesh_lib.make_mesh(2, devices=CPUS)) is None
    assert mesh_lib.model_axis(None) is None
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh_2d(3, 3)
    with pytest.raises(ValueError) as got:
        mesh_lib.make_mesh_2d(3, 3, devices=CPUS)
    assert str(got.value) == str(want.value)
    assert "requested a 3x3 mesh but only 8 device(s)" in str(got.value)
    with pytest.raises(ValueError, match="at least one device"):
        mesh_lib.make_mesh_2d(0, 2, devices=CPUS)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 device"):
            mesh_lib.make_mesh_2d(2, 2)


def test_helpers_work_on_the_data_axis():
    """Padding and blocks follow the data rows, not the device count, as
    the reference's ``data_axis_pad`` does."""
    cards = [f"cuda:{i}" for i in range(8)]
    mesh = mesh_lib.make_mesh_2d(4, 2, devices=cards)
    assert mesh_lib.data_axis_pad(mesh, 5) == jax_mesh.data_axis_pad(
        jax_mesh.make_mesh_2d(4, 2), 5) == 3
    assert mesh_lib.data_axis_pad(mesh, 8) == 0
    assert mesh_lib.data_axis_pad(mesh, 5, processes=2) == 3
    (padded,), orig = mesh_lib.pad_batch_to_mesh([np.arange(6)], mesh)
    assert orig == 6 and padded.tolist() == [0, 1, 2, 3, 4, 5, 5, 5]
    cpu_mesh = mesh_lib.make_mesh_2d(2, 2, devices=CPUS)
    x = torch.arange(4.0)[:, None]
    assert [b[:, 0].tolist() for b in mesh_lib.shard_batch(cpu_mesh, x)] \
        == [[0, 1], [2, 3]]
    assert len(mesh_lib.replicate(cpu_mesh, x)) == 2


@pytest.mark.parametrize("data,model,even", [
    (4, 2, True), (2, 4, True), (4, 2, False),
])
def test_param_sharding_rules_match_reference(data, model, even):
    """The same tensors are cut along the same axis as the reference's
    rules cut on the same parameter tree; an odd vocabulary (and CLIP's,
    always) stays whole in both."""
    one = _captioners()[0]
    bert_cfg = dataclasses.replace(one.bert_model.config,
                                   vocab_size=len(_vocab(even)))
    tree = {"bert": jax.jit(JaxBert(bert_cfg).init_params)(
        jax.random.PRNGKey(0)), "clip": one.params["clip"]}
    ref = jax.tree_util.tree_flatten_with_path(jax_mesh.param_sharding_rules(
        jax_mesh.make_mesh_2d(data, model), tree))[0]
    leaves = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = {}
    for path, sh in ref:
        spec = tuple(sh.spec)
        if "model" in spec:
            want[jax.tree_util.keystr(path)] = spec.index("model")
    bert = from_jax_params(BertForMaskedLM(port_bert_config(bert_cfg)),
                           jax.tree_util.tree_map(np.asarray, tree["bert"]))
    clip = from_jax_params(CLIPModel(port_clip_config(
        one.clip_model.config)), jax.tree_util.tree_map(
            np.asarray, tree["clip"]))
    mesh = mesh_lib.make_mesh_2d(data, model, devices=CPUS)
    got = {name: axis for name, axis in {
        **mesh_lib.param_sharding_rules(mesh, bert.named_parameters()),
        **{f"clip.{n}": a for n, a in mesh_lib.param_sharding_rules(
            mesh, clip.named_parameters()).items()}}.items()
        if axis is not None}
    params = {**dict(bert.named_parameters()),
              **{f"clip.{n}": p for n, p in clip.named_parameters()}}
    assert len(got) == len(want) == (2 if even else 0)
    for path, axis in want.items():
        matches = [n for n, a in got.items() if a == axis and np.array_equal(
            params[n].detach().numpy(), np.asarray(leaves[path]))]
        assert len(matches) == 1, (path, got)
    # without a model axis nothing is cut
    assert not any(a is not None for a in mesh_lib.param_sharding_rules(
        mesh_lib.make_mesh(2, devices=CPUS), bert.named_parameters())
        .values())
    assert not any(a is not None for a in mesh_lib.param_sharding_rules(
        None, bert.named_parameters()).values())


def _tiny_bert(seed=0, vocab=108, dtype=torch.float32):
    torch.manual_seed(seed)
    bert = BertForMaskedLM(BertConfig.tiny(vocab_size=vocab), dtype=dtype)
    for p in bert.parameters():
        torch.nn.init.normal_(p, std=0.5)
    return bert.eval().requires_grad_(False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_lookup_is_bit_equal_to_the_whole_table(dtype):
    bert = _tiny_bert()
    word = bert.embeddings.word
    word.data[5, 3] = -0.0  # shard 0: choosing, not adding, keeps the sign
    word.data[70, 0] = -0.0  # shard 1
    split = split_vocab(bert, [torch.device("cpu")] * 2)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 108, (6, 9)))
    ids[0, :2] = torch.tensor([5, 70])
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    got = split.shards.lookup(ids, dtype)
    want = F.embedding(ids, word.to(dtype))
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.signbit(got[0, 0, 3]) and torch.signbit(got[0, 1, 0])
    # and the whole embedding block
    bert.embeddings.dtype = split.embeddings.dtype = dtype
    assert torch.equal(split.embeddings(ids).view(bits),
                       bert.embeddings(ids).view(bits))


@pytest.mark.parametrize("model", [2, 4])
def test_split_head_logits_equal_the_whole_head(model):
    bert = _tiny_bert(seed=1)
    split = split_vocab(bert, [torch.device("cpu")] * model)
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 108, (3, 7)))
    hidden = bert.hidden(ids)
    assert torch.equal(split.hidden(ids), hidden)
    got, want = split.lm_head(hidden), bert.lm_head(hidden)
    assert got.dtype == torch.float32 and got.shape == (3, 7, 108)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(split(ids).numpy(), bert(ids).numpy(),
                               rtol=0, atol=LOGIT_ATOL)


def test_split_places_each_shard_on_its_device():
    """Shard j on row[j], the rest on row[0]; the source model keeps its
    tensors (the meta device stands in for a second card)."""
    bert = _tiny_bert()
    split = split_vocab(bert, [torch.device("cpu"), torch.device("meta")])
    assert [w.device.type for w in split.shards.words] == ["cpu", "meta"]
    assert [b.device.type for b in split.shards.biases] == ["cpu", "meta"]
    assert [tuple(w.shape) for w in split.shards.words] == [(54, 64)] * 2
    assert all(p.device.type == "cpu" for n, p in split.named_parameters()
               if "shards." not in n)
    assert bert.embeddings.word.shape == (108, 64)
    with pytest.raises(ValueError, match="does not divide"):
        split_vocab(_tiny_bert(vocab=107), [torch.device("cpu")] * 2)


def test_no_replica_holds_the_whole_table_or_bias():
    _, _, _, meshed = _captioners()
    V = meshed.wp.vocab_size
    assert V % 2 == 0 and len(meshed._replicas) == 1  # four equal rows
    berts = [bert for bert, _ in meshed._replicas.values()]
    assert meshed.bert_model is berts[0]
    for bert in berts:
        assert isinstance(bert, VocabSplitBert)
        shapes = [tuple(p.shape) for p in bert.parameters()]
        assert not [s for s in shapes if s and s[0] == V], shapes
        assert [tuple(w.shape) for w in bert.shards.words] == [
            (V // 2, bert.config.hidden_size)] * 2
        assert [tuple(b.shape) for b in bert.shards.biases] == [(V // 2,)] * 2


def test_an_odd_vocabulary_stays_whole(caplog):
    """The reference's rule: a vocabulary that does not divide the model
    axis is not cut (said once on the captioner's logger)."""
    vocab = _vocab(even=False)
    with caplog.at_level("INFO", logger=sampler.__name__):
        cap = sampler.Captioner.from_random(
            config=ConzicConfig(dtype="float32"), seed=0, wp_vocab=vocab,
            device="cpu", mesh=mesh_lib.make_mesh_2d(2, 2, devices=CPUS))
    assert len(vocab) % 2 == 1
    assert [r.message for r in caplog.records].count(
        f"a vocabulary of {len(vocab)} does not divide the model axis of "
        f"2: BERT's word table and MLM bias stay whole") == 1
    bert, _ = cap._replicas[(torch.device("cpu"),) * 2]
    assert type(bert) is BertForMaskedLM and bert is cap.bert_model


def test_a_2d_mesh_over_processes_is_refused(monkeypatch):
    _, _, one, _ = _captioners()
    monkeypatch.setattr(sampler.distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="a \\(data, model\\) mesh runs in "
                                         "one process"):
        sampler.Captioner(one.bert_model, one.clip_model, one.wp, one.bpe,
                          one.cfg, mesh=mesh_lib.make_mesh_2d(
                              2, 2, devices=CPUS))


# the case kinds of the reference's multichip dry run, and ragged batches
CASES = {
    "sequential": (B, dict(order="sequential", max_iter=2)),
    "span": (B, dict(order="span", max_iter=2)),
    "shuffle x 2 samples": (B, dict(order="shuffle", max_iter=2,
                                    n_samples=2)),
    "prune_k": (B, dict(order="sequential", max_iter=2, prune_k=4)),
    "sentiment": (B, dict(order="sequential", max_iter=2, ctl="sentiment",
                          gamma=5.0)),
    "ragged B-1": (B - 1, dict(order="sequential", max_iter=1)),
    "ragged B+1": (B + 1, dict(order="sequential", max_iter=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_2d_mesh_matches_reference_and_one_device(case):
    n, kw = CASES[case]
    ref_one, ref_mesh, one, meshed = _captioners()
    if "prune_k" in kw:
        # the reference's pruned-tier tables in both ports: two packages
        # build them equal only to the last bits
        carry_prune_tables(ref_mesh, one)
        carry_prune_tables(ref_mesh, meshed)
    embeds = _embeds(n)
    args = dict(ARGS, **kw)
    want = ref_mesh.run(jnp.asarray(embeds), rng=np.random.RandomState(7),
                        **args)
    got = meshed.run(embeds, rng=np.random.RandomState(7), **args)
    alone = one.run(embeds, rng=np.random.RandomState(7), **args)
    assert got.iter_ids.shape[1] == n * kw.get("n_samples", 1)
    _same(got, want)
    _same(got, alone)
    if case == "sequential":
        _same(got, ref_one.run(jnp.asarray(embeds),
                               rng=np.random.RandomState(7), **args))


def test_2d_mesh_int8_all_matches_reference_and_one_device():
    _, ref_mesh, one, meshed = _captioners("int8_all")
    embeds = _embeds(B)
    args = dict(ARGS, order="sequential", max_iter=1)
    want = ref_mesh.run(jnp.asarray(embeds), rng=np.random.RandomState(7),
                        **args)
    got = meshed.run(embeds, rng=np.random.RandomState(7), **args)
    _same(got, want)
    _same(got, one.run(embeds, rng=np.random.RandomState(7), **args))


def test_2d_mesh_refuses_what_any_mesh_refuses():
    _, _, _, meshed = _captioners()
    embeds = _embeds(2)
    meshed.cfg.clip_window = 8
    try:
        with pytest.raises(ValueError, match="clip_window requires a "
                                             "single chip"):
            meshed.run(embeds, rng=np.random.RandomState(1),
                       **dict(ARGS, order="sequential", max_iter=1))
    finally:
        meshed.cfg.clip_window = 0
    meshed.cfg.bridge_mode = "exact"
    try:
        with pytest.raises(NotImplementedError, match="on a mesh"):
            meshed.run(embeds, rng=np.random.RandomState(1),
                       **dict(ARGS, order="sequential", max_iter=1))
    finally:
        meshed.cfg.bridge_mode = "table"
