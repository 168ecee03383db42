"""Checkpoints -> port modules: ``conzic_tpu`` parameter trees and HF
state dicts; and port modules -> ``conzic_tpu`` parameter trees
(:func:`to_jax_params`, the exact inverse of :func:`from_jax_params`).

``from_hf_state_dict`` (at the end of this file) loads the HF checkpoints
that ``Captioner.from_pretrained`` reads, as ``conzic_tpu/models/convert.py``
does for the JAX package, by the name table of the module's family
(``models/families.py``): SigLIP's and SDAR's too, which the JAX package
does not hold; SDAR's stacked matrices (a layer's q, k and v, its held
experts' gates and ups, their downs) are joined from their parts
(:func:`joined`).

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

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.clip import CLIPModel, CLIPTextTower, CLIPVisionTower
from conzic_torch.models.configs import load_hf_config
from conzic_torch.models.families import family, family_of
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


# ---------------------------------------------------------------------------
# port modules -> conzic_tpu parameter trees
# ---------------------------------------------------------------------------

# DenseGeneral's q/k/v bias is (H, D) in the flax layout, the port's (E,)
_HEAD_BIASES = tuple(f"attention.{n}.bias" for n in ("query", "key", "value"))


def flax_ndim(name: str, param: torch.Tensor) -> int:
    """The number of axes of the port parameter ``name`` in the flax
    layout (what the JAX trainer's weight-decay mask reads)."""
    return param.dim() + 1 if name.endswith(_HEAD_BIASES) else param.dim()


def _array(t: torch.Tensor) -> np.ndarray:
    """A parameter as a numpy array; bf16 (which numpy lacks) as the fp32
    array of the same values."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _dense_tree(lin: Linear, kernel_shape: Optional[Tuple[int, ...]] = None,
                bias_shape: Optional[Tuple[int, ...]] = None) -> Dict:
    """Linear weight (out, in) -> the flax kernel, transposed to (in, out)
    (``nn.Dense``'s) or reshaped to ``kernel_shape`` (``DenseGeneral``'s);
    the bias as (out,) or reshaped to ``bias_shape``."""
    w = _array(lin.weight.T)
    out = {"kernel": w if kernel_shape is None else w.reshape(kernel_shape)}
    if lin.bias is not None:
        b = _array(lin.bias)
        out["bias"] = b if bias_shape is None else b.reshape(bias_shape)
    return out


def _ln_tree(ln: LayerNorm) -> Dict:
    return {"ln": {"scale": _array(ln.scale), "bias": _array(ln.bias)}}


def _stack_tree(stack: TransformerStack) -> Dict:
    out = {}
    for i, block in enumerate(stack.layers):
        attn = block.attention
        H, D = attn.num_heads, attn.head_dim
        E = H * D
        qkv = {n: _dense_tree(getattr(attn, n), (E, H, D), (H, D))
               for n in ("query", "key", "value")}
        qkv["out"] = _dense_tree(attn.out, (H, D, E))
        mlp = block.mlp
        out[f"layer_{i}"] = {
            "attention": qkv,
            "mlp": {"fc1": _dense_tree(mlp.fc1),
                    "fc2": _dense_tree(mlp.fc2)},
            "ln1": _ln_tree(block.ln1),
            "ln2": _ln_tree(block.ln2),
        }
    return out


def _bert_tree(m: BertForMaskedLM) -> Dict:
    e, head = m.embeddings, m.mlm
    return {
        "embeddings": {
            "word": {"embedding": _array(e.word)},
            "position": {"embedding": _array(e.position)},
            "token_type": {"embedding": _array(e.token_type)},
            "ln": _ln_tree(e.ln),
        },
        "encoder": _stack_tree(m.encoder),
        "mlm": {"transform": _dense_tree(head.transform),
                "ln": _ln_tree(head.ln), "bias": _array(head.bias)},
    }


def _clip_tree(m: CLIPModel) -> Dict:
    t, v = m.text_model, m.vision_model
    return {
        "text_model": {
            "token_embedding": {"embedding": _array(t.token_embedding)},
            "position_embedding": _array(t.position_embedding),
            "encoder": _stack_tree(t.encoder),
            "final_ln": _ln_tree(t.final_ln),
        },
        "vision_model": {
            # (out, in, kh, kw) -> flax's (kh, kw, in, out)
            "patch_embedding": {"kernel": _array(
                v.patch_embedding.permute(2, 3, 1, 0))},
            "class_embedding": _array(v.class_embedding),
            "position_embedding": _array(v.position_embedding),
            "pre_ln": _ln_tree(v.pre_ln),
            "encoder": _stack_tree(v.encoder),
            "post_ln": _ln_tree(v.post_ln),
        },
        "text_projection": _dense_tree(m.text_projection),
        "visual_projection": _dense_tree(m.visual_projection),
        "logit_scale": _array(m.logit_scale),
    }


def to_jax_params(module: nn.Module) -> Dict:
    """The parameters of ``module`` (a :class:`BertForMaskedLM` or
    :class:`CLIPModel`) as the ``conzic_tpu`` parameter tree: nested dicts
    of numpy arrays in the flax layout, the inverse of
    :func:`from_jax_params`. fp32 parameters come out as fp32 arrays;
    bf16 ones as fp32 arrays of the same values."""
    if isinstance(module, BertForMaskedLM):
        return _bert_tree(module)
    if isinstance(module, CLIPModel):
        return _clip_tree(module)
    raise TypeError(f"to_jax_params: no layout for {type(module)}")


# ---------------------------------------------------------------------------
# HF checkpoints: each tower family's (models/families.py)
# ---------------------------------------------------------------------------
#
# The port's modules keep torch's own layouts, which are HF's (Linear weight
# (out, in), patch conv (out, in, kh, kw)), so an HF tensor loads as it is,
# reshaped to the parameter's shape: only the names differ. A family's name
# table maps a module path to the candidate HF names, the first present one
# being read. The scale of a LayerNorm is HF's ``weight``.


def _leaf(name: str) -> tuple:
    """A port parameter name -> (module path, HF suffix): LayerNorm's
    ``scale`` is HF's ``weight``; an embedding table has no suffix (its
    HF name in the family's table is whole)."""
    for tail, hf in ((".scale", ".weight"), (".weight", ".weight"),
                     (".bias", ".bias")):
        if name.endswith(tail):
            return name[:-len(tail)], hf
    return name, ""


def hf_names(module: nn.Module, name: str) -> tuple:
    """The HF state-dict names of the port parameter ``name`` of
    ``module``, in the order they are looked up: its config's family's
    table. A tuple among them names the parts that are joined end to end
    into the parameter (:func:`joined`)."""
    path, suffix = _leaf(name)
    return tuple(n + suffix if isinstance(n, str) else n
                 for n in family_of(module.config).hf_names(
                     path, module.config))


def joined(parts) -> torch.Tensor:
    """The parts flattened and joined end to end, as ``torch.cat`` of their
    flat views makes them; a view that copies nothing where they already
    lie so in one storage, each contiguous: a state dict drawn as views of
    one buffer is then not held twice, the parts' buffer and the copy."""
    a = parts[0]
    end, base = a.storage_offset(), a.untyped_storage().data_ptr()
    for p in parts:
        if not (p.is_contiguous() and p.dtype == a.dtype
                and p.device == a.device
                and p.untyped_storage().data_ptr() == base
                and p.storage_offset() == end):
            return torch.cat([q.reshape(-1) for q in parts])
        end += p.numel()
    return a.as_strided((end - a.storage_offset(),), (1,),
                        a.storage_offset())


def _found(sd: Mapping, key) -> bool:
    return all(k in sd for k in key) if isinstance(key, tuple) else key in sd


def _read(sd: Mapping, key) -> torch.Tensor:
    if isinstance(key, tuple):
        return joined([_tensor(sd[k]) for k in key])
    return _tensor(sd[key])


def from_hf_state_dict(module: nn.Module, sd: Mapping) -> nn.Module:
    """Load an HF state dict (name -> tensor or numpy array) into
    ``module`` in place; returns it. Every parameter must be found."""
    for name, param in module.named_parameters():
        names = hf_names(module, name)
        key = next((n for n in names if _found(sd, n)), None)
        if key is None:
            raise KeyError(f"the checkpoint has none of {names} for {name} "
                           f"(not a {module.config.model_type} export?)")
        _set(param, _read(sd, key).reshape(param.shape))
    return module


# safetensors: an 8-byte little-endian header length, a JSON header
# {name: {dtype, shape, data_offsets}, "__metadata__": ...}, then the raw
# little-endian bytes of every tensor
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors of their stored type, read
    without the ``safetensors`` package."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        a = np.frombuffer(data[start:end], _ST_DTYPES[meta["dtype"]])
        t = torch.from_numpy(a.reshape(meta["shape"]).copy())
        out[name] = t.view(torch.bfloat16) if meta["dtype"] == "BF16" else t
    return out


def load_state_dict(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """The weights of a local HF checkpoint directory: ``model.safetensors``,
    the shards of ``model.safetensors.index.json``, or
    ``pytorch_model.bin``."""
    st_path = os.path.join(checkpoint_dir, "model.safetensors")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    index = os.path.join(checkpoint_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        sd: Dict[str, torch.Tensor] = {}
        for name in shards:
            sd.update(read_safetensors(os.path.join(checkpoint_dir, name)))
        return sd
    bin_path = os.path.join(checkpoint_dir, "pytorch_model.bin")
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no model.safetensors / pytorch_model.bin under {checkpoint_dir}")


def load_checkpoint(checkpoint_dir: str, role: str) -> Tuple[object, Dict]:
    """(config, state dict) of a local HF directory whose config's
    ``model_type`` names a family of ``role`` ("lm" or "match")."""
    d = load_hf_config(checkpoint_dir)
    config = family(d.get("model_type"), role).config.from_hf_dict(d)
    return config, load_state_dict(checkpoint_dir)
