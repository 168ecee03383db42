"""CLIP: vision tower (ViT), text tower, joint projection space.

Counterpart of ``conzic_tpu/models/clip.py``. Pixel input stays NHWC at the
public functions; the text tower pools at the first EOS and supports the
exact prefix-K/V split of the engine (``text_prefix_kvs`` once, then
``encode_text_suffix`` for every candidate chunk). :class:`TruncatedTextTower`
runs the first layers of the text tower: the factorized stage-1 scorer.
:func:`hf_names` is the names of Hugging Face's ``CLIPModel`` checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from conzic_torch.config import ATTN_IMPLS
from conzic_torch.models.configs import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from conzic_torch.models.layers import (
    LayerNorm,
    Linear,
    TransformerStack,
    cast_param,
)
from conzic_torch.ops.attention import make_attn_mask


def _stack(cfg, dtype: torch.dtype, attn_impl: str,
           quant: str = "none") -> TransformerStack:
    return TransformerStack(
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        head_dim=cfg.head_dim,
        intermediate=cfg.intermediate_size,
        act=cfg.hidden_act,
        eps=cfg.layer_norm_eps,
        pre_ln=True,
        dtype=dtype,
        attn_impl=attn_impl,
        quant=quant,
    )


class CLIPTextTower(nn.Module):
    """Pre-LN causal transformer over BPE ids; pooled at the first EOS.
    ``quant="int8"``: its projections and MLPs in int8."""

    def __init__(self, config: CLIPTextConfig,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "pallas", quant: str = "none"):
        super().__init__()
        self.config, self.dtype, self.quant = config, dtype, quant
        E = config.hidden_size
        self.token_embedding = nn.Parameter(torch.empty(config.vocab_size, E))
        self.position_embedding = nn.Parameter(
            torch.empty(config.max_position_embeddings, E))
        self.encoder = _stack(config, dtype, attn_impl, quant)
        self.final_ln = LayerNorm(E, config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None, *,
                pos_offset: int = 0, prefix_kvs: Optional[List] = None,
                return_kvs: bool = False, depth: Optional[int] = None):
        """Full-row encode, or one side of the exact prefix-K/V split:
        ``return_kvs`` also returns every layer's K/V; ``prefix_kvs`` runs
        the rows as a suffix continuation at positions ``pos_offset``..,
        every query attending the cached prefix keys plus the causal
        suffix. ``depth``: the first ``depth`` layers only, then the final
        LayerNorm and the pool, as a tower of that many layers would."""
        cfg, dt = self.config, self.dtype
        S = input_ids.shape[1]
        x = F.embedding(input_ids, cast_param(self.token_embedding, dt))
        pos = self.position_embedding
        if pos_offset + S > cfg.max_position_embeddings:
            # rows past the table are zeros; they belong to masked-off PAD
            # columns only and never reach the first-EOS row
            pos = F.pad(pos, (0, 0, 0,
                              pos_offset + S - cfg.max_position_embeddings))
        x = x + cast_param(pos[pos_offset:pos_offset + S], dt)[None]
        P = prefix_kvs[0][0].shape[1] if prefix_kvs is not None else 0
        mask = make_attn_mask(attention_mask, causal=True, offset=P)
        is_eos = (input_ids == cfg.eos_token_id).to(torch.int32)
        eos_pos = torch.argmax(is_eos, dim=1)  # first occurrence
        if return_kvs:
            x, kvs = self.encoder(x, mask, return_kvs=True, depth=depth)
            x = torch.gather(
                x, 1, eos_pos[:, None, None].expand(-1, 1, x.shape[-1]))
            return self.final_ln(x)[:, 0], kvs
        x = self.encoder(x, mask, prefix_kvs=prefix_kvs,
                         pool_idx=eos_pos[:, None], depth=depth)
        return self.final_ln(x)[:, 0]


class TruncatedTextTower:
    """The first ``num_layers`` layers of a text tower, then its final
    LayerNorm and the pool at the first EOS: the factorized stage-1 scorer.
    Counterpart of a ``CLIPTextTower`` with ``num_layers`` applied to
    ``truncated_text_params``: a view of the same modules, no weight copied.
    Called like the tower; ``prefix_kvs`` may be the full tower's, whose
    first ``num_layers`` entries are this view's."""

    def __init__(self, tower: CLIPTextTower, num_layers: int):
        full = tower.config.num_layers
        if not 1 <= num_layers <= full:
            raise ValueError(f"a truncated tower of {num_layers} layers "
                             f"(the tower has {full})")
        self.tower, self.num_layers = tower, num_layers
        self.config = dataclasses.replace(tower.config, num_layers=num_layers)

    def __call__(self, input_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None, *,
                 pos_offset: int = 0, prefix_kvs: Optional[List] = None,
                 return_kvs: bool = False):
        if prefix_kvs is not None:
            prefix_kvs = list(prefix_kvs[:self.num_layers])
        return self.tower(input_ids, attention_mask, pos_offset=pos_offset,
                          prefix_kvs=prefix_kvs, return_kvs=return_kvs,
                          depth=self.num_layers)


class CLIPVisionTower(nn.Module):
    """ViT with a class token; pooled output = post-LN of the class token."""

    def __init__(self, config: CLIPVisionConfig,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "pallas"):
        super().__init__()
        self.config, self.dtype = config, dtype
        E = config.hidden_size
        self.patch_embedding = nn.Parameter(torch.empty(
            E, config.num_channels, config.patch_size, config.patch_size))
        self.class_embedding = nn.Parameter(torch.empty(E))
        self.position_embedding = nn.Parameter(torch.empty(config.seq_len, E))
        self.pre_ln = LayerNorm(E, config.layer_norm_eps)
        self.encoder = _stack(config, dtype, attn_impl)
        self.post_ln = LayerNorm(E, config.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, H, W, C) NHWC, already preprocessed."""
        cfg, dt = self.config, self.dtype
        B = pixel_values.shape[0]
        px = pixel_values.to(dt).permute(0, 3, 1, 2)
        patches = F.conv2d(px, cast_param(self.patch_embedding, dt),
                           stride=cfg.patch_size)  # (B, E, gh, gw)
        patches = patches.flatten(2).transpose(1, 2)  # (B, gh*gw, E)
        cls = cast_param(self.class_embedding, dt)[None, None].expand(
            B, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + cast_param(self.position_embedding, dt)[None]
        x = self.pre_ln(x)
        x = self.encoder(x, make_attn_mask(None))
        return self.post_ln(x[:, 0])


class CLIPModel(nn.Module):
    """Dual tower + projections + ``logit_scale`` (kept in its stored type,
    exponentiated there as the flax model does). ``quant`` applies to the
    text tower only (the candidate scoring), as in the reference.
    ``bidirectional``: False, its text tower is causal, so candidate rows
    may share the prompt's K/V; ``preprocessing``: CLIP's image
    statistics; ``attn_impls`` and ``quants``: every attention route and
    quant tier."""

    label = "CLIP"
    bidirectional = False
    preprocessing = "clip"
    attn_impls = ATTN_IMPLS
    quants = ("none", "int8")

    def __init__(self, config: CLIPConfig,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "pallas", quant: str = "none"):
        super().__init__()
        self.config, self.dtype, self.quant = config, dtype, quant
        self.text_model = CLIPTextTower(config.text, dtype, attn_impl, quant)
        self.vision_model = CLIPVisionTower(config.vision, dtype, attn_impl)
        self.text_projection = Linear(config.text.hidden_size,
                                      config.projection_dim, bias=False,
                                      dtype=dtype)
        self.visual_projection = Linear(config.vision.hidden_size,
                                        config.projection_dim, bias=False,
                                        dtype=dtype)
        self.logit_scale = nn.Parameter(
            torch.tensor(config.logit_scale_init, dtype=torch.float32))

    def encode_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, projection_dim)."""
        return self.visual_projection(self.vision_model(pixel_values))

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """(N, S) ids -> (N, projection_dim)."""
        return self.text_projection(self.text_model(input_ids,
                                                    attention_mask))

    def encode_text_shared_prefix(self, prefix_ids: torch.Tensor,
                                  suffix_ids: torch.Tensor,
                                  suffix_mask: torch.Tensor) -> torch.Tensor:
        """Exact prefix-K/V encode: ``prefix_ids`` (B, P) shared by the G
        candidate rows ``suffix_ids``/``suffix_mask`` (B, G, S) of each
        image. Equal to :meth:`encode_text` on the full rows.
        Returns (B*G, projection_dim)."""
        kvs = self.text_prefix_kvs(prefix_ids)
        return self.encode_text_suffix(kvs, prefix_ids.shape[1], suffix_ids,
                                       suffix_mask)

    def text_prefix_kvs(self, prefix_ids: torch.Tensor) -> List:
        """(B, P) shared prefix -> per-layer attention (K, V)."""
        _, kvs = self.text_model(prefix_ids, return_kvs=True)
        return kvs

    def encode_text_suffix(self, prefix_kvs: List, prefix_len: int,
                           suffix_ids: torch.Tensor,
                           suffix_mask: torch.Tensor) -> torch.Tensor:
        """Suffix half of :meth:`encode_text_shared_prefix` against cached
        prefix K/V; suffix_ids/suffix_mask (B, G, S)."""
        B, G, S = suffix_ids.shape
        pooled = self.text_model(
            suffix_ids.reshape(B * G, S), suffix_mask.reshape(B * G, S),
            pos_offset=prefix_len, prefix_kvs=prefix_kvs)
        return self.text_projection(pooled)

    def similarity(self, image_embeds: torch.Tensor,
                   text_embeds: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """image_embeds (B, D), text_embeds (B*K, D) -> (softmax over K of
        the scaled cosine, raw cosine), both (B, K) fp32."""
        B = image_embeds.shape[0]
        text = text_embeds.reshape(B, -1, text_embeds.shape[-1]).float()
        img = image_embeds.float()
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        text = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
        cosine = torch.einsum("bkd,bd->bk", text, img)
        scaled = cosine * torch.exp(self.logit_scale).float()
        return torch.softmax(scaled, dim=-1), cosine


# Hugging Face's names: the encoder layers of both towers, after
# "{tower}.encoder.layers.{i}."
HF_LAYER = {
    "attention.query": "self_attn.q_proj",
    "attention.key": "self_attn.k_proj",
    "attention.value": "self_attn.v_proj",
    "attention.out": "self_attn.out_proj",
    "ln1": "layer_norm1",
    "mlp.fc1": "mlp.fc1",
    "mlp.fc2": "mlp.fc2",
    "ln2": "layer_norm2",
}
_HF_OTHER = {
    "text_model.token_embedding": (
        "text_model.embeddings.token_embedding.weight",),
    "text_model.position_embedding": (
        "text_model.embeddings.position_embedding.weight",),
    "text_model.final_ln": ("text_model.final_layer_norm",),
    "vision_model.patch_embedding": (
        "vision_model.embeddings.patch_embedding.weight",),
    "vision_model.class_embedding": (
        "vision_model.embeddings.class_embedding",),
    "vision_model.position_embedding": (
        "vision_model.embeddings.position_embedding.weight",),
    # HF spells the vision pre-norm "pre_layrnorm"
    "vision_model.pre_ln": ("vision_model.pre_layrnorm",
                            "vision_model.pre_layernorm"),
    "vision_model.post_ln": ("vision_model.post_layernorm",),
    "text_projection": ("text_projection",),
    "visual_projection": ("visual_projection",),
    "logit_scale": ("logit_scale",),
}


def hf_names(path: str, other: dict = _HF_OTHER) -> tuple:
    """The checkpoint names of the module path ``path``, in the order they
    are looked up: ``other``'s, else an encoder layer's."""
    if path in other:
        return other[path]
    tower, _, _, i, rest = path.split(".", 4)
    return (f"{tower}.encoder.layers.{i}.{HF_LAYER[rest]}",)
