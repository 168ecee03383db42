"""The tower families of ``conzic_torch/models/families.py``, one case an
entry: Hugging Face's config dict goes to the family's config, the model
is built empty, and the family's name table reads every tensor of
Hugging Face's own model of that config, one for each parameter. A
matcher's entry gives ``Captioner.from_random`` its model and synthetic
tokenizer; a proposer's is held to its tokenizer class and its
checkpoint prefix. A ``model_type`` with no entry of the role raises and
names the known ones, and a matcher's directory never falls through to
CLIP."""

import json

import pytest
import torch
import transformers

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.sampler import Captioner
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel
from conzic_torch.models.convert import hf_names, load_checkpoint
from conzic_torch.models.families import FAMILIES, family, family_of
from conzic_torch.models.sdar import SdarMoeLM
from conzic_torch.models.siglip import SiglipModel
from conzic_torch.text.bpe import CLIPBPETokenizer
from conzic_torch.text.qwen_bpe import QwenBPETokenizer
from conzic_torch.text.roberta_bpe import RobertaBPETokenizer
from conzic_torch.text.unigram import SiglipTokenizer
from conzic_torch.text.wordpiece import WordPieceTokenizer

_ENCODER = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64)
# model_type -> (role, model class, tokenizer class, Hugging Face's model
# of a tiny config of the type)
WANT = {
    "bert": ("lm", BertForMaskedLM, WordPieceTokenizer, lambda: (
        transformers.BertForMaskedLM(transformers.BertConfig(
            vocab_size=99, max_position_embeddings=40, **_ENCODER)))),
    "roberta": ("lm", BertForMaskedLM, RobertaBPETokenizer, lambda: (
        transformers.RobertaForMaskedLM(transformers.RobertaConfig(
            vocab_size=99, max_position_embeddings=40, type_vocab_size=1,
            pad_token_id=1, **_ENCODER)))),
    "sdar_moe": ("lm", SdarMoeLM, QwenBPETokenizer, lambda: (
        transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
            vocab_size=99, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8,
            num_experts=4, num_experts_per_tok=2,
            moe_intermediate_size=16)))),
    "clip": ("match", CLIPModel, CLIPBPETokenizer, lambda: (
        transformers.CLIPModel(transformers.CLIPConfig(
            text_config=dict(vocab_size=99, **_ENCODER),
            vision_config=dict(image_size=32, patch_size=8, **_ENCODER),
            projection_dim=24)))),
    "siglip": ("match", SiglipModel, SiglipTokenizer, lambda: (
        transformers.SiglipModel(transformers.SiglipConfig(
            text_config=dict(vocab_size=99, hidden_size=144,
                             num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=176),
            vision_config=dict(hidden_size=144, num_hidden_layers=2,
                               num_attention_heads=2, intermediate_size=176,
                               image_size=56, patch_size=14))))),
}
# Hugging Face tensors no port parameter reads: the MLM decoder, tied to
# the word table and the head's bias, and the position ids
_UNREAD = ("decoder.weight", "decoder.bias", "position_ids")
# the first checkpoint name of a proposer's word table
_WORDS = {"sdar_moe": ("embed", "model.embed_tokens.weight")}


def parts(name) -> tuple:
    """The checkpoint names a candidate of ``hf_names`` reads: a stacked
    parameter's parts, or the one name."""
    return name if isinstance(name, tuple) else (name,)


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_family_entry(model_type):
    role, model_cls, tokenizer_cls, hf_model = WANT[model_type]
    fam = family(model_type)
    assert (fam.role, fam.model, fam.tokenizer) == (role, model_cls,
                                                    tokenizer_cls)
    hf = hf_model()
    config = fam.config.from_hf_dict(hf.config.to_dict())
    assert family_of(config) is fam
    model = fam.build(config, torch.float32, "xla", "none")
    assert isinstance(model, model_cls)
    sd = hf.state_dict()
    read, n_read = set(), 0
    for name, p in model.named_parameters():
        key = next(n for n in hf_names(model, name)
                   if all(k in sd for k in parts(n)))
        assert sum(sd[k].numel() for k in parts(key)) == p.numel(), name
        read.update(parts(key))
        n_read += len(parts(key))
    assert len(read) == n_read
    unread = {k for k in sd if k not in read}
    assert all(k.endswith(_UNREAD) for k in unread), unread
    if role == "lm":
        path, first = _WORDS.get(model_type, (
            "embeddings.word",
            f"{model_type}.embeddings.word_embeddings.weight"))
        assert hf_names(model, path) == (first,)
        return
    cap = Captioner.from_random(ConzicConfig(attn_impl="xla"),
                                clip_config=config, device="cpu")
    assert type(cap.clip_model) is model_cls
    assert type(cap.bpe) is tokenizer_cls
    text = cap.clip_model.config.text
    assert fam.fit_text(text, cap.bpe) == text
    assert text.vocab_size >= cap.bpe.vocab_size


@pytest.mark.parametrize("model_type, role", [
    ("gpt2", None), ("clip", "lm"), ("bert", "match"), (None, "match")])
def test_a_model_type_without_an_entry_raises(model_type, role):
    known = sorted(t for t, f in FAMILIES.items() if role in (None, f.role))
    with pytest.raises(ValueError) as err:
        family(model_type, role)
    assert repr(model_type) in str(err.value)
    assert str(known) in str(err.value)


def test_a_matcher_directory_names_its_family(tmp_path):
    """A directory whose config names no matcher family, or none at all,
    is refused before any weight is read: nothing falls through to
    CLIP."""
    clip = WANT["clip"][3]().config.to_dict()
    for model_type in ("vit", None):
        d = tmp_path / str(model_type)
        d.mkdir()
        if model_type is None:
            del clip["model_type"]
        else:
            clip["model_type"] = model_type
        (d / "config.json").write_text(json.dumps(clip))
        with pytest.raises(ValueError, match="no matcher family"):
            load_checkpoint(str(d), "match")
