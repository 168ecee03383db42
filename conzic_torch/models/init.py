"""Training initialisation of the port's towers: flax's initialisers.

Counterpart of ``init_params`` of the JAX package's ``BertForMaskedLM`` and
``CLIPModel``: every leaf is drawn from the distribution its flax module
declares, so a tower trained by the port starts where the JAX trainer's
does. The distributions match; the bits cannot (another generator).

  Linear (``nn.Dense``, ``DenseGeneral``)   lecun_normal over the flat
                                            fan-in, zero bias
  patch embedding (``nn.Conv``)             lecun_normal, fan-in C*kh*kw
  BERT word / position / token-type, CLIP
  text token table (``nn.Embed``)           normal, std sqrt(1 / features)
  CLIP position and class embeddings        normal(0.02)
  LayerNorm                                 scale 1, bias 0
  MLM bias                                  0
  ``logit_scale``                           ``config.logit_scale_init``

lecun_normal is flax's ``variance_scaling(1, "fan_in",
"truncated_normal")``: a standard normal truncated to (-2, 2), scaled to
std sqrt(1 / fan_in) by the truncated normal's own std, 0.8796...
"""

from __future__ import annotations

import math
from typing import Set

import torch
from torch import nn

from conzic_torch.models.bert import BertEmbeddings, BertMlmHead
from conzic_torch.models.clip import (
    CLIPModel,
    CLIPTextTower,
    CLIPVisionTower,
)
from conzic_torch.models.layers import LayerNorm, Linear

# std of a standard normal truncated to (-2, 2)
TRUNCATED_STD = 0.87962566103423978


def _lecun_normal(p: torch.Tensor, fan_in: int, gen: torch.Generator):
    torch.nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=gen)
    p.mul_(math.sqrt(1.0 / fan_in) / TRUNCATED_STD)


def _normal(p: torch.Tensor, std: float, gen: torch.Generator):
    p.normal_(0.0, std, generator=gen)


def _embed(p: torch.Tensor, gen: torch.Generator):
    """``nn.Embed``'s default: variance_scaling(1, "fan_in", "normal",
    out_axis=0) over (num_embeddings, features), whose fan-in is
    ``features``."""
    _normal(p, math.sqrt(1.0 / p.shape[1]), gen)


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` (a ``BertForMaskedLM`` or a
    ``CLIPModel``) in place from flax's initialisers, on the generator's
    device; returns the module. Every parameter must be covered."""
    done: Set[int] = set()

    def mark(*params):
        done.update(id(p) for p in params)

    gen = generator
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Linear):
                _lecun_normal(m.weight, m.weight.shape[1], gen)
                mark(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
                    mark(m.bias)
            elif isinstance(m, LayerNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
                mark(m.scale, m.bias)
            elif isinstance(m, BertEmbeddings):
                for p in (m.word, m.position, m.token_type):
                    _embed(p, gen)
                mark(m.word, m.position, m.token_type)
            elif isinstance(m, BertMlmHead):
                m.bias.zero_()
                mark(m.bias)
            elif isinstance(m, CLIPTextTower):
                _embed(m.token_embedding, gen)
                _normal(m.position_embedding, 0.02, gen)
                mark(m.token_embedding, m.position_embedding)
            elif isinstance(m, CLIPVisionTower):
                w = m.patch_embedding  # (E, C, kh, kw)
                _lecun_normal(w, w[0].numel(), gen)
                _normal(m.class_embedding, 0.02, gen)
                _normal(m.position_embedding, 0.02, gen)
                mark(w, m.class_embedding, m.position_embedding)
            elif isinstance(m, CLIPModel):
                m.logit_scale.fill_(m.config.logit_scale_init)
                mark(m.logit_scale)
    missed = [n for n, p in module.named_parameters() if id(p) not in done]
    if missed:
        raise TypeError(f"init_params: no initialiser for {missed}")
    return module
