"""Read and write the checkpoint directories of ``conzic_tpu``'s trainer.

Counterpart of ``conzic_tpu/models/checkpoint.py``: a directory marked by
``conzic_tiny.json`` holds both model configs, each tower's flax parameters
as msgpack (``bert.msgpack``, ``clip.msgpack``) and both tokenizers' files.
Neither flax nor the ``msgpack`` package is needed: :func:`msgpack_restore`
reads what ``flax.serialization.to_bytes`` writes for a parameter tree,
which is maps, strings, integers, floats, binary data and arrays (msgpack
ext type 1, holding the msgpack of ``(shape, dtype name, C-order
bytes)``), and :func:`msgpack_pack` writes it. Arrays come back as CPU
tensors of their stored type; ``bfloat16`` ones are read as ``uint16`` and
viewed as ``torch.bfloat16``. :func:`save_tiny_checkpoint` writes a
directory that both packages' ``load_tiny_checkpoint`` read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from conzic_torch.models.configs import (
    BertConfig,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from conzic_torch.models.convert import to_jax_params

MARKER = "conzic_tiny.json"
FORMAT = "conzic-flax-v1"
_EXT_NDARRAY = 1


def is_tiny_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MARKER))


def _array(data: bytes) -> torch.Tensor:
    """An ext payload: msgpack of (shape, dtype name, C-order bytes)."""
    shape, dtype, raw = _Reader(data).read()
    if dtype == "bfloat16":
        a = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(raw, np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(a.copy())


class _Reader:
    """A msgpack decoder over one buffer (big-endian, as the format is)."""

    def __init__(self, data: bytes):
        self.data, self.at = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.at:self.at + n].tobytes()
        self.at += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _array(data)
        raise ValueError(f"msgpack: unsupported ext type {code}")


def msgpack_restore(data: bytes) -> Any:
    """The state tree that ``flax.serialization.to_bytes`` wrote."""
    reader = _Reader(data)
    out = reader.read()
    if reader.at != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the state tree")
    return out


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                               (0xCE, "I", 0xFFFFFFFF)):
            if n <= top:
                return bytes([code]) + struct.pack(">" + fmt, n)
        return b"\xcf" + struct.pack(">Q", n)
    for code, fmt, low in ((0xD0, "b", -0x80), (0xD1, "h", -0x8000),
                           (0xD2, "i", -0x80000000)):
        if n >= low:
            return bytes([code]) + struct.pack(">" + fmt, n)
    return b"\xd3" + struct.pack(">q", n)


def _pack_sized(n: int, small: Optional[Tuple[int, int]],
                codes: Tuple[int, int, int]) -> bytes:
    """A header of a sized type: the fix form (base code, most it holds)
    where ``small`` allows, else the 8-, 16- or 32-bit length form."""
    if small is not None and n <= small[1]:
        return bytes([small[0] | n])
    for code, fmt, top in zip(codes, "BHI", (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(">" + fmt, n)
    raise ValueError(f"msgpack: {n} is too long")


def _array_payload(a) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack of (shape, dtype name,
    C-order bytes); a bf16 tensor as its ``uint16`` bits named
    ``bfloat16``."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _pack([list(t.shape), "bfloat16",
                          t.view(torch.uint16).numpy().tobytes()])
        a = t.numpy()
    a = np.asarray(a)
    return _pack([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(obj: Any) -> bytes:
    if isinstance(obj, int) and not isinstance(obj, bool):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_sized(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, bytes):
        return _pack_sized(len(obj), None, (0xC4, 0xC5, 0xC6)) + obj
    if isinstance(obj, (list, tuple)):
        return (_pack_sized(len(obj), (0x90, 15), (None, 0xDC, 0xDD))
                + b"".join(_pack(x) for x in obj))
    if isinstance(obj, dict):
        return (_pack_sized(len(obj), (0x80, 15), (None, 0xDE, 0xDF))
                + b"".join(_pack(k) + _pack(v) for k, v in obj.items()))
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        data = _array_payload(obj)
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            head = bytes([fixext[n]])
        else:
            head = _pack_sized(n, None, (0xC7, 0xC8, 0xC9))
        return head + struct.pack(">b", _EXT_NDARRAY) + data
    raise TypeError(f"msgpack: cannot pack {type(obj)}")


def msgpack_pack(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a state tree (nested dicts of
    numpy arrays or CPU tensors): the inverse of :func:`msgpack_restore`.
    Map keys are written in the tree's order."""
    return _pack(tree)


def _sorted_tree(tree: Dict) -> Dict:
    """Keys in sorted order, as a tree that went through ``jax.jit`` (the
    JAX trainer's saved trees) has them."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def _cast_tree(tree: Dict, dtype: torch.dtype) -> Dict:
    """Floating leaves cast to ``dtype`` (round to nearest even, as the JAX
    package's ``astype``), as tensors."""
    def leaf(a):
        t = torch.tensor(np.asarray(a))
        return t.to(dtype) if t.is_floating_point() else t

    return {k: _cast_tree(v, dtype) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def save_tiny_checkpoint(
    path: str,
    bert_config: BertConfig,
    bert_model: nn.Module,
    clip_config: CLIPConfig,
    clip_model: nn.Module,
    wp_vocab: Dict[str, int],
    bpe_vocab_file: str,
    bpe_merges_file: str,
    meta: Optional[Dict[str, Any]] = None,
    save_dtype: str = "bfloat16",
) -> str:
    """Write the checkpoint directory (created or overwritten) of a port
    ``BertForMaskedLM`` and ``CLIPModel``: the files and layout of the JAX
    package's ``save_tiny_checkpoint``, so either package's
    ``load_tiny_checkpoint`` reads it. Floating parameters are saved in
    ``save_dtype`` ("bfloat16" or "float32")."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if save_dtype not in dtypes:
        raise ValueError(f"save_dtype must be one of {sorted(dtypes)}, got "
                         f"{save_dtype!r}")
    os.makedirs(path, exist_ok=True)
    for name, model in (("bert.msgpack", bert_model),
                        ("clip.msgpack", clip_model)):
        tree = _cast_tree(_sorted_tree(to_jax_params(model)),
                          dtypes[save_dtype])
        with open(os.path.join(path, name), "wb") as f:
            f.write(msgpack_pack(tree))
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        for tok in sorted(wp_vocab, key=wp_vocab.get):
            f.write(tok + "\n")
    shutil.copyfile(bpe_vocab_file, os.path.join(path, "bpe_vocab.json"))
    shutil.copyfile(bpe_merges_file, os.path.join(path, "bpe_merges.txt"))
    doc = {
        "format": FORMAT,
        "save_dtype": save_dtype,
        "bert_config": dataclasses.asdict(bert_config),
        "clip_config": dataclasses.asdict(clip_config),
        "meta": meta or {},
    }
    with open(os.path.join(path, MARKER), "w") as f:
        json.dump(doc, f, indent=1)
    return path


def load_tiny_checkpoint(
    path: str,
) -> Tuple[BertConfig, Dict, CLIPConfig, Dict, Dict[str, Any]]:
    """Read back (bert_cfg, bert_params, clip_cfg, clip_params, doc).
    Parameters are returned as stored (``doc["save_dtype"]``); the
    Captioner casts them by its own ``param_dtype``."""
    with open(os.path.join(path, MARKER)) as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT:
        raise ValueError(f"unknown checkpoint format in {path}: "
                         f"{doc.get('format')!r}")
    bert_cfg = BertConfig(**doc["bert_config"])
    cd = doc["clip_config"]
    clip_cfg = CLIPConfig(
        text=CLIPTextConfig(**cd["text"]),
        vision=CLIPVisionConfig(**cd["vision"]),
        projection_dim=cd["projection_dim"],
        logit_scale_init=cd["logit_scale_init"],
    )
    params = []
    for name in ("bert.msgpack", "clip.msgpack"):
        with open(os.path.join(path, name), "rb") as f:
            params.append(msgpack_restore(f.read()))
    return bert_cfg, params[0], clip_cfg, params[1], doc
