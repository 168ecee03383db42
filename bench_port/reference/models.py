"""BERT's masked-LM head and both CLIP towers in plain PyTorch, in the
weights' type (float32), over a Hugging Face state dict.

Written from the published architectures (``BertForMaskedLM``:
post-LayerNorm blocks, erf GELU, the decoder tied to the word embeddings;
``CLIPModel``: pre-LayerNorm blocks, the activation ``hidden_act`` names
(quick GELU in OpenAI's, erf GELU in OpenCLIP's), a causal text tower
pooled at its end token, a ViT with a class token), with no kernel, cache or
batching trick. Matrix products run with TF32 off (the caller sets the
flags; :func:`fp32_only` does). ``lowp`` makes it a control, the step
below the configuration's bf16 put in the program's place: every matrix
product takes its operands rounded to ``"fp8"`` (e4m3, each row scaled to
its absolute max) and accumulates in float32, as the H100's fp8
tensor-core products do.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


# a CLIP tower's MLP activation by its config's hidden_act, as Hugging
# Face's ACT2FN names them ("gelu": the erf form)
CLIP_ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


@contextlib.contextmanager
def fp32_only():
    """Matrix products and convolutions in true float32 (TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_rows(x: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    """``x`` with each row (last axis) rounded to ``lowp``: "fp8", e4m3
    with the row's absolute max scaled to 448; None, as it is."""
    if lowp is None:
        return x
    amax = x.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    if lowp == "fp8":
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"unknown precision {lowp!r}")


class Reference:
    """The plain forward passes. ``w``: the fp32 state dict; ``lm``,
    ``match``: the configuration's Hugging Face config dicts."""

    def __init__(self, w: Weights, lm: dict, match: dict,
                 clip_eos_id: int, lowp: Optional[str] = None):
        self.w, self.lm, self.match = w, lm, match
        self.eos = clip_eos_id
        self.lowp = lowp

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A matrix product's operand in the control's precision."""
        return round_rows(x, self.lowp)

    # --- pieces ---------------------------------------------------------
    def linear(self, x: torch.Tensor, name: str, bias: bool = True):
        weight = self.w[name + ".weight"]
        y = self.q(x) @ self.q(weight).T
        return y + self.w[name + ".bias"] if bias else y

    def ln(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".weight"],
                            self.w[name + ".bias"], eps)

    def attention(self, x: torch.Tensor, p: str, names: dict, heads: int,
                  keep: Optional[torch.Tensor]) -> torch.Tensor:
        """Multi-head self-attention; ``keep`` (N or 1, 1, S, S) bool."""
        N, S, E = x.shape
        D = E // heads

        def split(t):
            return t.view(N, S, heads, D).transpose(1, 2)

        q = split(self.linear(x, p + names["q"]))
        k = split(self.linear(x, p + names["k"]))
        v = split(self.linear(x, p + names["v"]))
        logits = (self.q(q) @ self.q(k).transpose(-1, -2)) / math.sqrt(D)
        if keep is not None:
            logits = logits.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        # v's rows run along the keys, the product's inner axis
        v = self.q(v.transpose(-1, -2)).transpose(-1, -2)
        ctx = (self.q(probs) @ v).transpose(1, 2).reshape(N, S, E)
        return self.linear(ctx, p + names["o"])

    # --- BERT -----------------------------------------------------------
    BERT = {"q": "attention.self.query", "k": "attention.self.key",
            "v": "attention.self.value", "o": "attention.output.dense"}

    def bert_logits(self, ids: torch.Tensor, slot: torch.Tensor
                    ) -> torch.Tensor:
        """(N, S) ids -> (N, V) vocabulary logits at column ``slot`` (N,)."""
        c, w = self.lm, self.w
        eps = c["layer_norm_eps"]
        N, S = ids.shape
        x = (w["bert.embeddings.word_embeddings.weight"][ids]
             + w["bert.embeddings.position_embeddings.weight"][:S][None]
             + w["bert.embeddings.token_type_embeddings.weight"][0])
        x = self.ln(x, "bert.embeddings.LayerNorm", eps)
        for i in range(c["num_hidden_layers"]):
            p = f"bert.encoder.layer.{i}."
            a = self.attention(x, p, self.BERT, c["num_attention_heads"],
                               None)
            x = self.ln(x + a, p + "attention.output.LayerNorm", eps)
            h = F.gelu(self.linear(x, p + "intermediate.dense"))
            x = self.ln(x + self.linear(h, p + "output.dense"),
                        p + "output.LayerNorm", eps)
        h = x[torch.arange(N, device=x.device), slot]
        h = F.gelu(self.linear(h, "cls.predictions.transform.dense"))
        h = self.ln(h, "cls.predictions.transform.LayerNorm", eps)
        table = w["bert.embeddings.word_embeddings.weight"]
        return self.q(h) @ self.q(table).T + w["cls.predictions.bias"]

    # --- CLIP -----------------------------------------------------------
    CLIP = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
            "v": "self_attn.v_proj", "o": "self_attn.out_proj"}

    def _clip_stack(self, x, prefix, cfg, keep):
        eps = cfg["layer_norm_eps"]
        act = CLIP_ACTIVATIONS[cfg.get("hidden_act", "quick_gelu")]
        for i in range(cfg["num_hidden_layers"]):
            p = f"{prefix}.encoder.layers.{i}."
            x = x + self.attention(self.ln(x, p + "layer_norm1", eps), p,
                                   self.CLIP, cfg["num_attention_heads"],
                                   keep)
            h = self.linear(self.ln(x, p + "layer_norm2", eps), p + "mlp.fc1")
            h = act(h)
            x = x + self.linear(h, p + "mlp.fc2")
        return x

    def text_embeds(self, ids: torch.Tensor, n_valid: torch.Tensor
                    ) -> torch.Tensor:
        """(N, L) CLIP ids with ``n_valid`` (N,) valid positions (BOS ..
        EOS) -> (N, projection_dim): causal, padding masked, pooled at the
        first end token."""
        cfg = self.match["text_config"]
        N, L = ids.shape
        dev = ids.device
        x = (self.w["text_model.embeddings.token_embedding.weight"][ids]
             + self.w["text_model.embeddings.position_embedding.weight"][:L])
        col = torch.arange(L, device=dev)
        keep = ((col[None, :] <= col[:, None])[None]
                & (col[None, None, :] < n_valid[:, None, None]))[:, None]
        x = self._clip_stack(x, "text_model", cfg, keep)
        x = self.ln(x, "text_model.final_layer_norm", cfg["layer_norm_eps"])
        eos_at = (ids == self.eos).int().argmax(dim=1)
        pooled = x[torch.arange(N, device=dev), eos_at]
        return self.linear(pooled, "text_projection", bias=False)

    def image_embeds(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) preprocessed pixels -> (B, projection_dim)."""
        cfg = self.match["vision_config"]
        eps = cfg["layer_norm_eps"]
        kernel = self.w["vision_model.embeddings.patch_embedding.weight"]
        x = pixels.to(kernel.dtype).permute(0, 3, 1, 2)
        P = cfg["patch_size"]
        if self.lowp:
            cols = F.unfold(x, P, stride=P).transpose(1, 2)  # (B, n, C*P*P)
            patches = (self.q(cols)
                       @ self.q(kernel.reshape(kernel.shape[0], -1)).T)
        else:
            patches = F.conv2d(x, kernel, stride=P).flatten(2).transpose(1, 2)
        B = x.shape[0]
        cls = self.w["vision_model.embeddings.class_embedding"]
        x = torch.cat([cls.expand(B, 1, -1), patches], dim=1)
        x = x + self.w["vision_model.embeddings.position_embedding.weight"]
        x = self.ln(x, "vision_model.pre_layrnorm", eps)
        x = self._clip_stack(x, "vision_model", cfg, None)
        pooled = self.ln(x[:, 0], "vision_model.post_layernorm", eps)
        return self.linear(pooled, "visual_projection", bias=False)

    def logit_scale(self) -> float:
        return float(torch.exp(self.w["logit_scale"].float()))
