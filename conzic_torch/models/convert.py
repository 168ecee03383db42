"""JAX parameter tree -> port modules.

The inverse direction of ``conzic_tpu/models/convert.py``: ``from_jax_params``
takes the flax parameter tree of a ``conzic_tpu`` model (nested dicts of
numpy arrays or CPU tensors, unrolled ``layer_i`` layers) and loads it into
the matching port module. Leaves keep their stored type (a checkpoint saved in bf16 stays
bf16, and the modules cast on use exactly as the flax modules do).

Layout rules:
  DenseGeneral q/k/v kernel (E, H, D)  -> Linear weight (E, E), transposed
  DenseGeneral out kernel (H, D, E)    -> Linear weight (E, E), transposed
  nn.Dense kernel (in, out)            -> Linear weight (out, in)
  flax conv kernel (kh, kw, in, out)   -> (out, in, kh, kw)
  {"ln": {scale, bias}}                -> LayerNorm scale, bias
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel, CLIPTextTower, CLIPVisionTower
from conzic_torch.models.layers import (
    LayerNorm,
    Linear,
    MultiHeadAttention,
    TransformerStack,
)


def _tensor(a) -> torch.Tensor:
    """numpy or torch leaf -> CPU tensor in the same type (bf16 numpy
    leaves, stored by ml_dtypes, go through fp32, which holds every bf16
    value exactly; the checkpoint reader gives tensors already)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _set(param: nn.Parameter, value: torch.Tensor) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit "
                         f"parameter {tuple(param.shape)}")
    param.data = value.to(param.device)


def _dense(lin: Linear, p: Mapping) -> None:
    """nn.Dense or DenseGeneral: the kernel flattened to (in, out), then
    transposed to the (out, in) weight."""
    kernel = _tensor(p["kernel"])
    if lin.weight.shape[1] * lin.weight.shape[0] != kernel.numel():
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit "
                         f"{tuple(lin.weight.shape)}")
    in_features = lin.weight.shape[1]
    _set(lin.weight, kernel.reshape(in_features, -1).T.contiguous())
    if lin.bias is not None:
        _set(lin.bias, _tensor(p["bias"]).reshape(-1))


def _ln(ln: LayerNorm, p: Mapping) -> None:
    _set(ln.scale, _tensor(p["ln"]["scale"]))
    _set(ln.bias, _tensor(p["ln"]["bias"]))


def _attention(attn: MultiHeadAttention, p: Mapping) -> None:
    for name in ("query", "key", "value", "out"):
        _dense(getattr(attn, name), p[name])


def _stack(stack: TransformerStack, p: Mapping) -> None:
    if len(p) != len(stack.layers):
        raise ValueError(f"{len(p)} layers in the tree, "
                         f"{len(stack.layers)} in the module")
    for i, block in enumerate(stack.layers):
        lp = p[f"layer_{i}"]
        _attention(block.attention, lp["attention"])
        _dense(block.mlp.fc1, lp["mlp"]["fc1"])
        _dense(block.mlp.fc2, lp["mlp"]["fc2"])
        _ln(block.ln1, lp["ln1"])
        _ln(block.ln2, lp["ln2"])


def _bert(m: BertForMaskedLM, p: Mapping) -> None:
    e = p["embeddings"]
    _set(m.embeddings.word, _tensor(e["word"]["embedding"]))
    _set(m.embeddings.position, _tensor(e["position"]["embedding"]))
    _set(m.embeddings.token_type, _tensor(e["token_type"]["embedding"]))
    _ln(m.embeddings.ln, e["ln"])
    _stack(m.encoder, p["encoder"])
    _dense(m.mlm.transform, p["mlm"]["transform"])
    _ln(m.mlm.ln, p["mlm"]["ln"])
    _set(m.mlm.bias, _tensor(p["mlm"]["bias"]))


def _text(t: CLIPTextTower, p: Mapping) -> None:
    _set(t.token_embedding, _tensor(p["token_embedding"]["embedding"]))
    _set(t.position_embedding, _tensor(p["position_embedding"]))
    _stack(t.encoder, p["encoder"])
    _ln(t.final_ln, p["final_ln"])


def _vision(v: CLIPVisionTower, p: Mapping) -> None:
    kernel = _tensor(p["patch_embedding"]["kernel"])  # (kh, kw, in, out)
    _set(v.patch_embedding, kernel.permute(3, 2, 0, 1).contiguous())
    _set(v.class_embedding, _tensor(p["class_embedding"]))
    _set(v.position_embedding, _tensor(p["position_embedding"]))
    _ln(v.pre_ln, p["pre_ln"])
    _stack(v.encoder, p["encoder"])
    _ln(v.post_ln, p["post_ln"])


def _clip(m: CLIPModel, p: Mapping) -> None:
    _text(m.text_model, p["text_model"])
    _vision(m.vision_model, p["vision_model"])
    _dense(m.text_projection, p["text_projection"])
    _dense(m.visual_projection, p["visual_projection"])
    _set(m.logit_scale, _tensor(p["logit_scale"]).reshape(()))


def from_jax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Load a ``conzic_tpu`` parameter tree into ``module`` (a
    :class:`BertForMaskedLM` or :class:`CLIPModel`) in place; returns it."""
    if isinstance(module, BertForMaskedLM):
        _bert(module, params)
    elif isinstance(module, CLIPModel):
        _clip(module, params)
    else:
        raise TypeError(f"from_jax_params: no layout for {type(module)}")
    return module
