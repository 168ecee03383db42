"""BERT encoder + masked-LM head.

Counterpart of ``conzic_tpu/models/bert.py``: post-LayerNorm blocks, erf
gelu, learned absolute positions, token types, and the MLM transform head
whose decoder is tied to the word embeddings plus a per-vocab bias.
``hidden`` runs the encoder (optionally computing the final layer only at
``pool_idx``), ``lm_head`` projects hidden states to fp32 vocab logits.
:func:`hf_names` is the Hugging Face checkpoint names of BERT's and
RoBERTa's masked LMs, the two families the model serves
(``models/families.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from conzic_torch.config import ATTN_IMPLS
from conzic_torch.models.configs import BertConfig
from conzic_torch.models.layers import (
    ACTIVATIONS,
    LayerNorm,
    Linear,
    TransformerStack,
    cast_param,
)
from conzic_torch.ops.attention import make_attn_mask


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.config, self.dtype = config, dtype
        E = config.hidden_size
        self.word = nn.Parameter(torch.empty(config.vocab_size, E))
        self.position = nn.Parameter(
            torch.empty(config.max_position_embeddings, E))
        self.token_type = nn.Parameter(torch.empty(config.type_vocab_size, E))
        self.ln = LayerNorm(E, config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        S = input_ids.shape[1]
        dt = self.dtype
        positions = torch.arange(S, device=input_ids.device)
        positions = positions + self.config.position_offset
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_rows(input_ids)
             + F.embedding(positions, cast_param(self.position, dt))[None]
             + F.embedding(token_type_ids,
                           cast_param(self.token_type, dt)))
        return self.ln(x)

    def word_rows(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The word table's rows of ``input_ids``, in the compute type."""
        return F.embedding(input_ids, cast_param(self.word, self.dtype))


class BertMlmHead(nn.Module):
    """Transform (dense + act + LN), then the tied vocab projection with
    fp32 output plus a free fp32 bias."""

    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.act = ACTIVATIONS[config.hidden_act]
        self.transform = Linear(config.hidden_size, config.hidden_size,
                                dtype=dtype)
        self.ln = LayerNorm(config.hidden_size, config.layer_norm_eps)
        self.bias = nn.Parameter(torch.zeros(config.vocab_size))

    def transformed(self, hidden: torch.Tensor) -> torch.Tensor:
        """dense + act + LN: the states the vocabulary projection reads."""
        return self.ln(self.act(self.transform(hidden)))

    def forward(self, hidden: torch.Tensor,
                word_embedding: torch.Tensor) -> torch.Tensor:
        h = self.transformed(hidden)
        # the product of compute-type operands leaves in fp32 (the flax
        # head's preferred_element_type=float32): rounding the logits to
        # bf16 before the T=0.1 softmax would create extra ties. The
        # operands' values are exact in fp32, so the fp32 product equals
        # a bf16 product with fp32 accumulation and output.
        w = cast_param(word_embedding, self.dtype).float()
        return F.linear(h.float(), w) + self.bias.float()


class BertForMaskedLM(nn.Module):
    """``attn_impls`` and ``quants``: the attention routes and the quant
    tiers of the encoder that the model takes, every one."""

    label = "BERT"
    attn_impls = ATTN_IMPLS
    quants = ("none", "int8")

    def __init__(self, config: BertConfig,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "pallas", quant: str = "none"):
        """``quant="int8"``: the encoder's projections and MLPs in int8 (the
        ``int8_all`` tier); the MLM head stays in the compute type."""
        super().__init__()
        self.config, self.dtype, self.quant = config, dtype, quant
        self.embeddings = BertEmbeddings(config, dtype)
        self.encoder = TransformerStack(
            num_layers=config.num_layers,
            num_heads=config.num_heads,
            head_dim=config.head_dim,
            intermediate=config.intermediate_size,
            act=config.hidden_act,
            eps=config.layer_norm_eps,
            pre_ln=False,
            dtype=dtype,
            attn_impl=attn_impl,
            quant=quant,
        )
        self.mlm = BertMlmHead(config, dtype)

    def hidden(self, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               token_type_ids: Optional[torch.Tensor] = None,
               pool_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) ids -> (B, S, H) states, or (B, Q, H) at ``pool_idx``."""
        x = self.embeddings(input_ids, token_type_ids)
        mask = make_attn_mask(attention_mask)
        return self.encoder(x, mask, pool_idx=pool_idx)

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.mlm(hidden, self.embeddings.word)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.lm_head(
            self.hidden(input_ids, attention_mask, token_type_ids))


# Hugging Face's names: the encoder layers, after "{model_type}.encoder.
# layer.{i}."; the embeddings, after "{model_type}."; the MLM head, by
# model_type ("mlm" is the head's own vocabulary bias)
_HF_LAYER = {
    "attention.query": "attention.self.query",
    "attention.key": "attention.self.key",
    "attention.value": "attention.self.value",
    "attention.out": "attention.output.dense",
    "ln1": "attention.output.LayerNorm",
    "mlp.fc1": "intermediate.dense",
    "mlp.fc2": "output.dense",
    "ln2": "output.LayerNorm",
}
_HF_EMBEDDINGS = {
    "embeddings.word": "embeddings.word_embeddings.weight",
    "embeddings.position": "embeddings.position_embeddings.weight",
    "embeddings.token_type": "embeddings.token_type_embeddings.weight",
    "embeddings.ln": "embeddings.LayerNorm",
}
_HF_HEAD = {
    "bert": {"mlm.transform": ("cls.predictions.transform.dense",),
             "mlm.ln": ("cls.predictions.transform.LayerNorm",),
             "mlm": ("cls.predictions", "cls.predictions.decoder")},
    "roberta": {"mlm.transform": ("lm_head.dense",),
                "mlm.ln": ("lm_head.layer_norm",),
                "mlm": ("lm_head", "lm_head.decoder")},
}


def hf_names(model_type: str, path: str) -> tuple:
    """The names in a ``{model_type}ForMaskedLM`` checkpoint ("bert" or
    "roberta") of the module path ``path``, in the order they are looked
    up."""
    if path in _HF_EMBEDDINGS:
        return (f"{model_type}.{_HF_EMBEDDINGS[path]}",)
    if path in _HF_HEAD[model_type]:
        return _HF_HEAD[model_type][path]
    _, _, i, rest = path.split(".", 3)  # encoder.layers.{i}.{rest}
    return (f"{model_type}.encoder.layer.{i}.{_HF_LAYER[rest]}",)
