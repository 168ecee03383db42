"""Device meshes for caption-batch scale-out.

Counterpart of ``conzic_tpu/parallel/mesh.py``, in PyTorch's idiom.
Captioning is embarrassingly parallel over (images x samples): a data mesh
is a list of devices, and ``Captioner`` keeps one replica of the towers on
each, splits the batch into contiguous blocks, one a device, runs the
blocks on one thread each and concatenates the results in order. The
Gibbs loop needs no collective.

The helpers take ``None`` for "no mesh" and then change nothing, as the
reference's do. The reference's 2-D (data, model) mesh, which splits the
BERT vocabulary, has no counterpart: no entry point builds one.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

Device = Union[str, torch.device]
Mesh = List[torch.device]


def visible_devices(kind: str = "cuda") -> List[torch.device]:
    """The devices a mesh is built over by default: every CUDA device, or
    the one CPU."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence[Device]] = None
              ) -> List[torch.device]:
    """A 1-D data mesh: the first ``num_devices`` of ``devices`` (every
    visible CUDA device by default). Asking for more devices than are
    visible raises: a silent truncation would run on fewer devices than
    asked for. ``devices`` may repeat a device (tests give eight CPUs)."""
    devices = list(devices) if devices is not None else visible_devices()
    if num_devices is not None:
        if len(devices) < num_devices:
            raise ValueError(
                f"requested a {num_devices}-device mesh but only "
                f"{len(devices)} device(s) are visible")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return [torch.device(d) for d in devices]


def data_axis_pad(mesh: Optional[Mesh], batch: int, processes: int = 1
                  ) -> int:
    """Rows to append so ``batch`` divides the data axis (times the
    process count); 0 when it already divides."""
    n = (len(mesh) if mesh is not None else 1) * processes
    return (-batch) % n


def pad_batch_to_mesh(arrays: Sequence, mesh: Optional[Mesh],
                      processes: int = 1):
    """Pad a batch (numpy arrays or tensors) with copies of its last row so
    its leading size divides the mesh (times the process count); returns
    (padded arrays, original size)."""
    B = arrays[0].shape[0]
    pad = data_axis_pad(mesh, B, processes)
    if pad == 0:
        return list(arrays), B
    return [torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
            if isinstance(a, torch.Tensor)
            else np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            for a in arrays], B


def shard_batch(mesh: Optional[Mesh], x: torch.Tensor) -> List[torch.Tensor]:
    """The leading axis of ``x`` in contiguous blocks, one on each device
    of the mesh; the axis must divide. Without a mesh: ``[x]``."""
    if mesh is None:
        return [x]
    if x.shape[0] % len(mesh):
        raise ValueError(f"a batch of {x.shape[0]} does not divide over "
                         f"{len(mesh)} devices (pad_batch_to_mesh)")
    return [blk.to(d) for blk, d in zip(x.chunk(len(mesh)), mesh)]


def replicate(mesh: Optional[Mesh], x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` on every device of the mesh. Without a mesh: ``[x]``."""
    if mesh is None:
        return [x]
    return [x.to(d) for d in mesh]
