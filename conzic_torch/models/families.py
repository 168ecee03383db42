"""The tower families, keyed by the Hugging Face ``model_type``, for the
two roles: ``lm``, the proposer that gives the distribution at a masked
slot (bert, roberta; sdar_moe, a block-diffusion LM with experts), and
``match``, the dual-encoder matcher (clip, siglip).

A family names its config class (``from_hf_dict``, ``tiny``), its model
class, its tokenizer class (``from_pretrained``), the checkpoint names of
its parameters, and, for a matcher, the synthetic tokenizer of
``Captioner.from_random`` and what its text config takes from a
tokenizer. What a model runs (its attention routes, quant tiers and
whether its text tower is bidirectional) is stated on its class, and
:meth:`Family.build` refuses the rest. Nothing outside a family's own
files asks which family it holds: a new proposer or matcher is its model
file, its config, its tokenizer and one entry of :data:`FAMILIES`.
"""

from __future__ import annotations

import dataclasses
import functools
import tempfile
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from conzic_torch.models import bert, clip, sdar, siglip
from conzic_torch.models.configs import (
    BertConfig,
    CLIPConfig,
    SdarMoeConfig,
    SiglipConfig,
)
from conzic_torch.text.bpe import CLIPBPETokenizer
from conzic_torch.text.qwen_bpe import QwenBPETokenizer
from conzic_torch.text.roberta_bpe import RobertaBPETokenizer
from conzic_torch.text.unigram import (
    TEST_UNK_ID,
    SiglipTokenizer,
    make_test_pieces,
)
from conzic_torch.text.vocab import make_test_bpe_files
from conzic_torch.text.wordpiece import WordPieceTokenizer

ROLES = {"lm": "proposer", "match": "matcher"}


@dataclasses.dataclass(frozen=True)
class Family:
    role: str  # "lm" or "match"
    config: type
    model: type
    tokenizer: type
    # (a module path of the model, its config) -> its checkpoint names, in
    # lookup order; a tuple among them names the parts joined into one
    # parameter
    hf_names: Callable[[str, object], Tuple]
    # (proposer's tokenizer, config) -> the matcher's synthetic tokenizer
    test_tokenizer: Optional[Callable] = None
    # (text config, tokenizer) -> the text config the tokenizer implies
    fit_text: Callable = lambda text, tokenizer: text

    def build(self, config, dtype: torch.dtype, attn_impl: str,
              quant: str) -> nn.Module:
        """The model, empty; an attention route or quant tier that its
        class does not take raises."""
        m, role = self.model, ROLES[self.role]
        if quant not in m.quants:
            raise ValueError(f"quant tier {quant!r} for the {m.label} "
                             f"{role}: its towers take {m.quants} only")
        if attn_impl not in m.attn_impls:
            raise ValueError(f"attn_impl={attn_impl!r} with the {m.label} "
                             f"{role}: the attention kernels do not take "
                             f"it; use one of {m.attn_impls}")
        return m(config, dtype=dtype, attn_impl=attn_impl, quant=quant)


def _names(fn: Callable[[str], Tuple[str, ...]]) -> Callable:
    """The names of a family whose names do not depend on its config."""
    return lambda path, config: fn(path)


def _clip_bpe(proposer_tokenizer, config: CLIPConfig) -> CLIPBPETokenizer:
    with tempfile.TemporaryDirectory(prefix="conzic_bpe_") as d:
        return CLIPBPETokenizer.from_files(*make_test_bpe_files(d))


def _clip_eos(text, tokenizer: CLIPBPETokenizer):
    """The text tower pools at the first EOS: its id is the BPE's EOS."""
    return dataclasses.replace(text, eos_token_id=tokenizer.eos_token_id)


def _siglip_pieces(proposer_tokenizer, config: SiglipConfig
                   ) -> SiglipTokenizer:
    """Unigram pieces that are the proposer's words (``make_test_pieces``),
    rows as long as the text tower's positions."""
    words = [t for t in proposer_tokenizer.vocab if not t.startswith("[")]
    return SiglipTokenizer(
        make_test_pieces(words), TEST_UNK_ID,
        model_max_length=config.text.max_position_embeddings)


FAMILIES = {
    "bert": Family("lm", BertConfig, bert.BertForMaskedLM,
                   WordPieceTokenizer,
                   _names(functools.partial(bert.hf_names, "bert"))),
    "roberta": Family("lm", BertConfig, bert.BertForMaskedLM,
                      RobertaBPETokenizer,
                      _names(functools.partial(bert.hf_names, "roberta"))),
    "sdar_moe": Family("lm", SdarMoeConfig, sdar.SdarMoeLM,
                       QwenBPETokenizer, sdar.hf_names),
    "clip": Family("match", CLIPConfig, clip.CLIPModel, CLIPBPETokenizer,
                   _names(clip.hf_names), _clip_bpe, _clip_eos),
    "siglip": Family("match", SiglipConfig, siglip.SiglipModel,
                     SiglipTokenizer, _names(siglip.hf_names),
                     _siglip_pieces),
}


def family(model_type: Optional[str], role: Optional[str] = None) -> Family:
    """The family of ``model_type``, of ``role`` ("lm" or "match") when
    given; any other raises and names the known ones."""
    found = FAMILIES.get(model_type)
    if found is None or role not in (None, found.role):
        known = sorted(t for t, f in FAMILIES.items()
                       if role in (None, f.role))
        raise ValueError(f"no {ROLES.get(role, 'tower')} family for "
                         f"model_type {model_type!r}; known: {known}")
    return found


def family_of(config) -> Family:
    """The family of a config instance (its ``model_type``)."""
    return family(config.model_type)
