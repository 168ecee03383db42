"""Read the checkpoint directories that ``conzic_tpu`` trains and saves.

Counterpart of the read side of ``conzic_tpu/models/checkpoint.py``: a
directory marked by ``conzic_tiny.json`` holds both model configs, each
tower's flax parameters as msgpack (``bert.msgpack``, ``clip.msgpack``) and
both tokenizers' files. Neither flax nor the ``msgpack`` package is needed:
:func:`msgpack_restore` reads what ``flax.serialization.to_bytes`` writes
for a parameter tree, which is maps, strings, integers, floats, binary
data and arrays (msgpack ext type 1, holding the msgpack of ``(shape, dtype
name, C-order bytes)``). Arrays come back as CPU tensors of their stored
type; ``bfloat16`` ones are read as ``uint16`` and viewed as
``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from conzic_torch.models.configs import (
    BertConfig,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)

MARKER = "conzic_tiny.json"
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


def load_tiny_checkpoint(
    path: str,
) -> Tuple[BertConfig, Dict, CLIPConfig, Dict, Dict[str, Any]]:
    """Read back (bert_cfg, bert_params, clip_cfg, clip_params, doc).
    Parameters are returned as stored (``doc["save_dtype"]``); the
    Captioner casts them by its own ``param_dtype``."""
    with open(os.path.join(path, MARKER)) as f:
        doc = json.load(f)
    if doc.get("format") != "conzic-flax-v1":
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
