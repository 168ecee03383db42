"""SigLIP as the matcher: a bidirectional text tower pooled at the last
position, a vision tower with an attention-pooling head, and sigmoid-loss
scores ``exp(logit_scale) * cos + logit_bias``.

Follows Hugging Face's ``modeling_siglip.py`` (Zhai et al., arXiv
2303.15343), built from the pre-LayerNorm blocks of ``layers.py``. The text
tower attends all of a row's positions, padding included, with no mask:
SigLIP was trained on rows padded to the full length, and it pools the last
position, whatever token is there. So a candidate row shares no reusable
state with the prompt and runs whole (the engine's ``bidirectional``
path); :func:`encode_full_rows` is its entry. Its attention runs on the
library route (``attn_impl`` "xla" and its variants) only.
:func:`hf_names` is the names of Hugging Face's ``SiglipModel``
checkpoints.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from conzic_torch.models import clip
from conzic_torch.models.configs import (
    SiglipConfig,
    SiglipTextConfig,
    SiglipVisionConfig,
)
from conzic_torch.models.layers import (
    LayerNorm,
    Linear,
    Mlp,
    TransformerStack,
    cast_param,
)
from conzic_torch.ops.attention import XLA_IMPLS, AttnMask, xla_attention
from conzic_torch.runtime import profiling
from conzic_torch.runtime.profiling import span


def _stack(cfg, dtype: torch.dtype, attn_impl: str) -> TransformerStack:
    return TransformerStack(
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        head_dim=cfg.head_dim, intermediate=cfg.intermediate_size,
        act=cfg.hidden_act, eps=cfg.layer_norm_eps, pre_ln=True,
        dtype=dtype, attn_impl=attn_impl)


class SiglipTextTower(nn.Module):
    """Pre-LN transformer over SentencePiece ids with no mask of any kind;
    the final LayerNorm at the last position, then the linear head."""

    def __init__(self, config: SiglipTextConfig,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla"):
        super().__init__()
        self.config, self.dtype = config, dtype
        E = config.hidden_size
        self.token_embedding = nn.Parameter(torch.empty(config.vocab_size, E))
        self.position_embedding = nn.Parameter(
            torch.empty(config.max_position_embeddings, E))
        self.encoder = _stack(config, dtype, attn_impl)
        self.final_ln = LayerNorm(E, config.layer_norm_eps)
        self.head = Linear(E, config.projection_size, dtype=dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """(N, S) ids -> (N, projection_size). The last layer computes
        the pooled position only; its keys span the row."""
        dt = self.dtype
        N, S = input_ids.shape
        x = F.embedding(input_ids, cast_param(self.token_embedding, dt))
        x = x + cast_param(self.position_embedding[:S], dt)[None]
        last = torch.full((N, 1), S - 1, dtype=torch.long,
                          device=input_ids.device)
        x = self.encoder(x, AttnMask(), pool_idx=last)
        return self.head(self.final_ln(x)[:, 0])


class SiglipPoolingHead(nn.Module):
    """``SiglipMultiheadAttentionPoolingHead``: a learned probe attends
    over the patches through ``nn.MultiheadAttention``'s packed
    ``in_proj_weight`` (q, k, v rows) and ``in_proj_bias``, then its
    ``out_proj``; then ``h + mlp(layernorm(h))``."""

    def __init__(self, config: SiglipVisionConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        E = config.hidden_size
        self.num_heads, self.dtype = config.num_heads, dtype
        self.probe = nn.Parameter(torch.empty(1, 1, E))
        self.in_proj_weight = nn.Parameter(torch.empty(3 * E, E))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * E))
        self.out_proj = Linear(E, E, dtype=dtype)
        self.layernorm = LayerNorm(E, config.layer_norm_eps)
        self.mlp = Mlp(E, config.intermediate_size, config.hidden_act,
                       dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, E) patches -> (B, E)."""
        dt = self.dtype
        B, T, E = x.shape
        H = self.num_heads
        w = cast_param(self.in_proj_weight, dt)
        b = cast_param(self.in_proj_bias, dt)
        probe = cast_param(self.probe, dt).expand(B, 1, E)
        q = F.linear(probe, w[:E], b[:E]).view(B, 1, H, E // H)
        kv = F.linear(x.to(dt), w[E:], b[E:]).view(B, T, 2, H, E // H)
        h = xla_attention(q, kv[:, :, 0], kv[:, :, 1], AttnMask())
        h = self.out_proj(h.reshape(B, 1, E))
        h = h + self.mlp(self.layernorm(h))
        return h[:, 0]


class SiglipVisionTower(nn.Module):
    """A stride-``patch_size`` convolution (with its bias) into patches,
    no class token and no pre-LayerNorm; the encoder, the post-LayerNorm,
    then the attention-pooling head."""

    def __init__(self, config: SiglipVisionConfig,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "xla"):
        super().__init__()
        self.config, self.dtype = config, dtype
        E = config.hidden_size
        self.patch_embedding = nn.Parameter(torch.empty(
            E, config.num_channels, config.patch_size, config.patch_size))
        self.patch_bias = nn.Parameter(torch.empty(E))
        self.position_embedding = nn.Parameter(
            torch.empty(config.num_patches, E))
        self.encoder = _stack(config, dtype, attn_impl)
        self.post_ln = LayerNorm(E, config.layer_norm_eps)
        self.head = SiglipPoolingHead(config, dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, H, W, C) NHWC, already preprocessed."""
        cfg, dt = self.config, self.dtype
        px = pixel_values.to(dt).permute(0, 3, 1, 2)
        x = F.conv2d(px, cast_param(self.patch_embedding, dt),
                     cast_param(self.patch_bias, dt), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, patches, E)
        x = x + cast_param(self.position_embedding, dt)[None]
        x = self.post_ln(self.encoder(x, AttnMask()))
        return self.head(x)


class SiglipModel(nn.Module):
    """The two towers and the two scalars of the scores, kept in fp32.
    Called by the engine as a ``CLIPModel`` is (``encode_image``,
    ``encode_text``, ``similarity``); ``bidirectional`` tells it that
    candidate rows run whole (no prompt K/V, no window, no pruned tier),
    and ``preprocessing`` which image statistics the tower takes. It runs
    on the library route unquantized (``attn_impls``, ``quants``)."""

    label = "SigLIP"
    bidirectional = True
    preprocessing = "siglip"
    attn_impls = XLA_IMPLS
    quants = ("none",)

    def __init__(self, config: SiglipConfig,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 quant: str = "none"):
        super().__init__()
        self.config, self.dtype, self.quant = config, dtype, quant
        self.text_model = SiglipTextTower(config.text, dtype, attn_impl)
        self.vision_model = SiglipVisionTower(config.vision, dtype,
                                              attn_impl)
        self.logit_scale = nn.Parameter(
            torch.tensor(config.logit_scale_init, dtype=torch.float32))
        self.logit_bias = nn.Parameter(
            torch.tensor(config.logit_bias_init, dtype=torch.float32))

    def encode_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, hidden): the pooling head's output."""
        with span("towers.match_image"):
            return self.vision_model(pixel_values)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask=None) -> torch.Tensor:
        """(N, S) ids -> (N, projection_size). ``attention_mask`` is not
        read: every position of a row is attended."""
        return self.text_model(input_ids)

    def similarity(self, image_embeds: torch.Tensor,
                   text_embeds: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embeds (B, D), text_embeds (B*K, D) -> (softmax over K of
        ``exp(logit_scale) * cos + logit_bias``, the cosines), both (B, K)
        fp32. The bias cancels in the softmax; it is applied all the
        same, so that the scores are SigLIP's."""
        B = image_embeds.shape[0]
        text = text_embeds.reshape(B, -1, text_embeds.shape[-1]).float()
        img = image_embeds.float()
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
        cosine = torch.einsum("bkd,bd->bk", text, img)
        logits = (cosine * torch.exp(self.logit_scale).float()
                  + self.logit_bias.float())
        return torch.softmax(logits, dim=-1), cosine


def encode_full_rows(model: SiglipModel,
                     input_ids: torch.Tensor) -> torch.Tensor:
    """(N, S) whole candidate rows -> (N, projection_size): the engine's
    entry into a bidirectional text tower, which counts the N * S
    positions it encodes as ``towers.match_text_positions``."""
    profiling.count(profiling.MATCH_TEXT_POSITIONS, input_ids.numel())
    return model.encode_text(input_ids)


# Hugging Face's names; the encoder layers are named as CLIP's
_HF_OTHER = {
    "text_model.token_embedding": (
        "text_model.embeddings.token_embedding.weight",),
    "text_model.position_embedding": (
        "text_model.embeddings.position_embedding.weight",),
    "text_model.final_ln": ("text_model.final_layer_norm",),
    "text_model.head": ("text_model.head",),
    "vision_model.patch_embedding": (
        "vision_model.embeddings.patch_embedding.weight",),
    "vision_model.patch_bias": (
        "vision_model.embeddings.patch_embedding.bias",),
    "vision_model.position_embedding": (
        "vision_model.embeddings.position_embedding.weight",),
    "vision_model.post_ln": ("vision_model.post_layernorm",),
    # the pooling head's nn.MultiheadAttention is "attention"
    "vision_model.head.probe": ("vision_model.head.probe",),
    "vision_model.head.in_proj_weight": (
        "vision_model.head.attention.in_proj_weight",),
    "vision_model.head.in_proj_bias": (
        "vision_model.head.attention.in_proj_bias",),
    "vision_model.head.out_proj": ("vision_model.head.attention.out_proj",),
    "vision_model.head.layernorm": ("vision_model.head.layernorm",),
    "vision_model.head.mlp.fc1": ("vision_model.head.mlp.fc1",),
    "vision_model.head.mlp.fc2": ("vision_model.head.mlp.fc2",),
    "logit_scale": ("logit_scale",),
    "logit_bias": ("logit_bias",),
}


def hf_names(path: str) -> tuple:
    """The checkpoint names of the module path ``path``, in the order they
    are looked up."""
    return clip.hf_names(path, _HF_OTHER)
