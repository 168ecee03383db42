"""Device meshes for caption-batch scale-out.

Counterpart of ``conzic_tpu/parallel/mesh.py``, in PyTorch's idiom.
Captioning is embarrassingly parallel over (images x samples): a data mesh
is a list of devices, and ``Captioner`` keeps one replica of the towers on
each, splits the batch into contiguous blocks, one a device, runs the
blocks on one thread each and concatenates the results in order. The
Gibbs loop needs no collective.

A 2-D mesh (:func:`make_mesh_2d`) is ``data`` rows of ``model`` devices
each. The batch splits over the data axis only: a row's block runs on the
row's first device, and the BERT word table and MLM bias are cut along the
vocabulary over the row's devices (:func:`param_sharding_rules`,
``parallel/vocab.py``), so no device holds them whole. As in the
reference, the model axis buys memory, not speed: it adds a hop between
devices to every lookup and vocabulary projection.

The helpers take ``None`` for "no mesh" and then change nothing, as the
reference's do; given a 2-D mesh they work on its data axis.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from conzic_torch.parallel.vocab import VOCAB_PARAMS, cuts

Device = Union[str, torch.device]
# a data mesh (a list of devices) or a (data, model) mesh (a list of rows)
Mesh = Union[List[torch.device], List[List[torch.device]]]


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


def make_mesh_2d(data: int, model: int,
                 devices: Optional[Sequence[Device]] = None
                 ) -> List[List[torch.device]]:
    """A (data, model) mesh: the first ``data * model`` of ``devices``
    (every visible CUDA device by default) in ``data`` rows of ``model``,
    row-major. Asking for more devices than are visible raises; ``devices``
    may repeat a device (tests give eight CPUs)."""
    devices = list(devices) if devices is not None else visible_devices()
    if len(devices) < data * model:
        raise ValueError(
            f"requested a {data}x{model} mesh but only "
            f"{len(devices)} device(s) are visible")
    if data < 1 or model < 1:
        raise ValueError("a mesh needs at least one device")
    flat = [torch.device(d) for d in devices[:data * model]]
    return [flat[r * model:(r + 1) * model] for r in range(data)]


def model_axis(mesh: Optional[Mesh]) -> Optional[int]:
    """The size of the mesh's model axis; None for a data mesh (a list of
    devices) or no mesh. The one place the two kinds are told apart."""
    if mesh is None or not isinstance(mesh[0], (list, tuple)):
        return None
    return len(mesh[0])


def mesh_rows(mesh: Mesh) -> List[List[torch.device]]:
    """The mesh's data rows, each the list of its model-axis devices (one
    device a row for a data mesh)."""
    if model_axis(mesh) is None:
        return [[d] for d in mesh]
    return [list(row) for row in mesh]


def data_devices(mesh: Mesh) -> List[torch.device]:
    """The device each data row's block of the batch runs on: the row's
    first."""
    return [row[0] for row in mesh_rows(mesh)]


def param_sharding_rules(
        mesh: Optional[Mesh],
        params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, Optional[int]]:
    """For each of ``params`` (a module's ``named_parameters()``): 0 when
    the tensor is cut along its first axis over the model axis, None when
    every device holds it whole; the reference's rules, by
    ``parallel.vocab.cuts``."""
    model = model_axis(mesh)
    return {name: 0 if name in VOCAB_PARAMS and cuts(model, t.shape[0])
            else None for name, t in params}


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
    """The leading axis of ``x`` in contiguous blocks, one on the first
    device of each data row; the axis must divide. Without a mesh:
    ``[x]``."""
    if mesh is None:
        return [x]
    if x.shape[0] % len(mesh):
        raise ValueError(f"a batch of {x.shape[0]} does not divide over "
                         f"{len(mesh)} devices (pad_batch_to_mesh)")
    return [blk.to(d) for blk, d in zip(x.chunk(len(mesh)),
                                        data_devices(mesh))]


def replicate(mesh: Optional[Mesh], x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` on the first device of every data row. Without a mesh:
    ``[x]``."""
    if mesh is None:
        return [x]
    return [x.to(d) for d in data_devices(mesh)]
