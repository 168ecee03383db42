"""``Captioner.from_pretrained`` on HF checkpoint directories ==
``conzic_tpu``'s, and the RoBERTa tokenizer == HF's.

Tiny ``BertForMaskedLM``, ``RobertaForMaskedLM`` and ``CLIPModel`` are
built by ``transformers`` from config (nothing is downloaded) and written
with ``save_pretrained`` to temporary directories: as safetensors, as
``pytorch_model.bin`` and as sharded safetensors. The port reads them with
its own name table and safetensors reader. Its towers must agree with HF
torch within 2e-4 and carry the JAX package's converted parameters bit
for bit; its caption ids must equal ``conzic_tpu``'s ``from_pretrained``
byte for byte, for BERT and for RoBERTa. The RoBERTa tokenizer must equal
HF's and ``conzic_tpu``'s on the same strings, and the trained-directory
``match_model`` guard must raise as the reference's does.
"""

import dataclasses
import os

import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch
import transformers

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import TRAINED_TINY
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_tpu.text.roberta_bpe import (
    RobertaBPETokenizer as JaxRobertaBPETokenizer,
)
from conzic_tpu.text.vocab import make_test_roberta_files as jax_roberta_files
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.sampler import Captioner
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel
from conzic_torch.models.convert import (
    from_jax_params,
    hf_names,
    load_state_dict,
    read_safetensors,
)
from conzic_torch.text.roberta_bpe import RobertaBPETokenizer
from conzic_torch.text.vocab import (
    make_test_bpe_files,
    make_test_roberta_files,
    make_test_wordpiece_vocab,
)

TOL = 2e-4
SENTENCES = ["image of a girl", "the dog sitting", "a big red dog playing",
             "the cat, run!", "", "image of a<mask><mask> run",
             "image of a <mask>"]
# HF keys the port does not read: tied decoder weights and position ids
_UNREAD = ("predictions.decoder.weight", "lm_head.decoder.weight",
           "position_ids")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"bert", "roberta", "clip", "bert_bin", "bert_sharded"} -> (dir, HF
    model)."""
    root = tmp_path_factory.mktemp("hf")
    vocab = make_test_wordpiece_vocab()
    with open(root / "vocab.txt", "w", encoding="utf-8") as f:
        for tok in sorted(vocab, key=vocab.get):
            f.write(tok + "\n")
    wp_tok = transformers.BertTokenizer(str(root / "vocab.txt"))
    bpe_tok = transformers.CLIPTokenizer(*make_test_bpe_files(str(root)))
    rob_files = make_test_roberta_files(str(root))
    rob_tok = transformers.RobertaTokenizer(*rob_files)
    torch.manual_seed(0)
    bert = transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64)).eval()
    roberta = transformers.RobertaForMaskedLM(transformers.RobertaConfig(
        vocab_size=len(rob_tok), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=1, layer_norm_eps=1e-5,
        pad_token_id=1)).eval()
    clip = transformers.CLIPModel(transformers.CLIPConfig(
        text_config=dict(vocab_size=len(bpe_tok.encoder), hidden_size=32,
                         num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=64,
                         eos_token_id=bpe_tok.eos_token_id,
                         bos_token_id=bpe_tok.bos_token_id),
        vision_config=dict(hidden_size=48, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=96,
                           image_size=32, patch_size=8),
        projection_dim=24)).eval()
    out = {}
    for name, model, tok, kw in (
            ("bert", bert, wp_tok, {}),
            ("bert_bin", bert, wp_tok, dict(safe_serialization=False)),
            ("bert_sharded", bert, wp_tok, dict(max_shard_size="40KB")),
            ("roberta", roberta, rob_tok, {}),
            ("clip", clip, bpe_tok, {})):
        d = str(root / name)
        model.save_pretrained(d, **kw)
        tok.save_pretrained(d)
        out[name] = (d, model)
    return out


_CAPS = {}


def _caps(dirs, lm):
    """(conzic_tpu from_pretrained, the port's), fp32 on the CPU."""
    if lm not in _CAPS:
        kw = dict(dtype="float32", lm_model=dirs[lm][0],
                  match_model=dirs["clip"][0], verbose=False)
        _CAPS[lm] = (JaxCaptioner.from_pretrained(JaxConfig(**kw)),
                     Captioner.from_pretrained(ConzicConfig(**kw),
                                               device="cpu"))
    return _CAPS[lm]


def test_checkpoint_layouts_read_alike(dirs):
    """safetensors, .bin and the sharded index give the same tensors, and
    the safetensors reader equals the safetensors package's."""
    d = dirs["bert"][0]
    assert os.path.exists(os.path.join(d, "model.safetensors"))
    assert os.path.exists(os.path.join(dirs["bert_bin"][0],
                                       "pytorch_model.bin"))
    assert os.path.exists(os.path.join(dirs["bert_sharded"][0],
                                       "model.safetensors.index.json"))
    want = safetensors.numpy.load_file(os.path.join(d, "model.safetensors"))
    got = load_state_dict(d)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].numpy().tobytes() == value.tobytes(), key
    for other in ("bert_bin", "bert_sharded"):
        sd = load_state_dict(dirs[other][0])
        for key in want:
            assert torch.equal(sd[key], got[key]), (other, key)
    with pytest.raises(FileNotFoundError):
        load_state_dict(os.path.dirname(d))


def test_safetensors_reader_keeps_every_type(tmp_path):
    rng = np.random.RandomState(0)
    tensors = {
        "f32": torch.from_numpy(rng.randn(3, 4).astype(np.float32)),
        "f16": torch.from_numpy(rng.randn(5).astype(np.float16)),
        "bf16": torch.from_numpy(rng.randn(2, 3).astype(np.float32)).to(
            torch.bfloat16),
        "i64": torch.arange(7),
        "i8": torch.tensor([-3, 4], dtype=torch.int8),
        "scalar": torch.tensor(4.6052),
        "empty": torch.zeros(0, 3),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(tensors, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for key, value in tensors.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key],
                                                             value), key


@pytest.mark.parametrize("lm", ["bert", "roberta"])
def test_name_table_reads_every_hf_tensor(dirs, lm):
    """Each port parameter has one HF tensor of its size, and every HF
    tensor but the tied decoder and the position ids is read."""
    _, pc = _caps(dirs, lm)
    for module, name in ((pc.bert_model, lm), (pc.clip_model, "clip")):
        sd = load_state_dict(dirs[name][0])
        read = set()
        for pname, p in module.named_parameters():
            key = next(n for n in hf_names(module, pname) if n in sd)
            assert sd[key].numel() == p.numel(), pname
            read.add(key)
        unread = {k for k in sd if k not in read}
        assert all(k.endswith(_UNREAD) for k in unread), unread


@pytest.mark.parametrize("lm", ["bert", "roberta"])
def test_towers_match_hf_and_the_reference(dirs, lm):
    jc, pc = _caps(dirs, lm)
    hf_lm, hf_clip = dirs[lm][1], dirs["clip"][1]
    # the reference's converted parameters, carried over bit for bit
    for ours, tree, cls in ((pc.bert_model, jc.params["bert"],
                             BertForMaskedLM),
                            (pc.clip_model, jc.params["clip"], CLIPModel)):
        with torch.device("cpu"):
            via_jax = from_jax_params(
                cls(ours.config, dtype=torch.float32),
                jax.tree_util.tree_map(np.asarray, tree))
        a, b = ours.state_dict(), via_jax.state_dict()
        assert list(a) == list(b)
        for key in a:
            assert torch.equal(a[key], b[key]), key
    rng = np.random.RandomState(0)
    ids = rng.randint(4, pc.wp.vocab_size, size=(2, 9))
    with torch.no_grad():
        want = hf_lm(torch.from_numpy(ids)).logits
        got = pc.bert_model(torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
        tids = rng.randint(1, 60, size=(3, 10))
        tids[:, -1] = pc.bpe.eos_token_id
        mask = np.ones_like(tids)
        want = hf_clip.get_text_features(torch.from_numpy(tids),
                                         attention_mask=torch.from_numpy(mask))
        got = pc.clip_model.encode_text(torch.from_numpy(tids),
                                        torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
        px = rng.rand(2, 32, 32, 3).astype(np.float32)
        want = hf_clip.get_image_features(
            torch.from_numpy(px.transpose(0, 3, 1, 2).copy()))
        got = pc.encode_images(px)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
    assert pc.wp.vocab == jc.wp.vocab and pc.bpe.encoder == jc.bpe.encoder


@pytest.mark.parametrize("lm,order", [("bert", "sequential"),
                                      ("bert", "shuffle"),
                                      ("roberta", "sequential")])
def test_from_pretrained_runs_match_reference(dirs, lm, order):
    jc, pc = _caps(dirs, lm)
    emb = np.random.RandomState(2).randn(
        2, pc.clip_model.config.projection_dim).astype(np.float32)
    args = dict(prompt="image of a", max_len=4, top_k=8, temperature=0.1,
                max_iter=2, alpha=0.02, beta=2.0, order=order)
    want = jc.run(jnp.asarray(emb), rng=np.random.RandomState(4), **args)
    got = pc.run(emb, rng=np.random.RandomState(4), **args)
    np.testing.assert_array_equal(got.iter_ids, np.asarray(want.iter_ids))
    np.testing.assert_array_equal(got.best_ids, np.asarray(want.best_ids))
    assert got.gen_texts_list == want.gen_texts_list
    np.testing.assert_allclose(np.asarray(got.clip_score_sequence),
                               np.asarray(want.clip_score_sequence), rtol=0,
                               atol=1e-4)
    assert got.gen_texts_list[-2][0].startswith("image of a")


def test_roberta_tokenizer_matches_hf_and_reference(tmp_path):
    files = make_test_roberta_files(str(tmp_path))
    (tmp_path / "ref").mkdir()
    ref_files = jax_roberta_files(str(tmp_path / "ref"))
    for a, b in zip(files, ref_files):
        assert open(a, "rb").read() == open(b, "rb").read()
    ours = RobertaBPETokenizer.from_files(*files)
    theirs = JaxRobertaBPETokenizer.from_files(*files)
    hf = transformers.RobertaTokenizer(*files)
    rows = []
    for s in SENTENCES:
        assert ours.tokenize(s) == hf.tokenize(s) == theirs.tokenize(s), s
        assert ours.encode(s) == hf.encode(s) == theirs.encode(s), s
        rows.append(hf.encode(s))
    for skip in (False, True):
        assert (ours.batch_decode(rows, skip)
                == hf.batch_decode(rows, skip_special_tokens=skip)
                == theirs.batch_decode(rows, skip))
    assert ours.encode_word_ids("girl") == theirs.encode_word_ids("girl")
    assert ours.mask_token_id == hf.mask_token_id
    assert ours.special_tokens == theirs.special_tokens


def test_match_model_guard_raises_as_the_reference(dirs):
    kw = dict(lm_model=TRAINED_TINY, match_model=dirs["clip"][0])
    with pytest.raises(ValueError) as want:
        JaxCaptioner.from_pretrained(JaxConfig(**kw))
    with pytest.raises(ValueError) as got:
        Captioner.from_pretrained(ConzicConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
    # the same directory twice, or match_model at its default, is the
    # trained directory's own pair of towers
    for match in (TRAINED_TINY, ConzicConfig().match_model):
        cap = Captioner.from_pretrained(
            dataclasses.replace(ConzicConfig(), lm_model=TRAINED_TINY,
                                match_model=match), device="cpu")
        assert cap.wp.vocab_size == 4096
