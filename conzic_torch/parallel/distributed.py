"""Several processes captioning one batch (``--multihost``).

Counterpart of ``conzic_tpu/parallel/distributed.py``, in PyTorch's idiom.
The Gibbs loop needs no collective, so a multi-process run is bookkeeping:

  1. every process calls :func:`initialize`, a wrapper of
     ``torch.distributed.init_process_group`` (``--coordinator_address``
     host:port becomes a ``tcp://`` rendezvous, ``--num_processes`` and
     ``--process_id`` the world size and rank);
  2. each process decodes its contiguous block of every global batch
     (:func:`local_slice`), encodes it and all processes exchange the
     embeddings (:func:`put_local_shard`);
  3. ``Captioner.run`` gives each process its contiguous block of the
     (images x samples) rows, on its device (:func:`local_device`), and
     every process gathers every block's results (:func:`gather_to_host`);
  4. process 0 writes the artifacts (:func:`is_primary`), and every
     process leaves the group (:func:`shutdown`).

The only exchange is results and embeddings back to the host, so the
backend is ``gloo`` over host objects (``all_gather_object``): it works
whether the ranks have a card each or share one. In one process every
helper is the identity.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """Join the process group. ``coordinator_address`` (host:port of
    process 0, or a full init-method URL) defaults to ``MASTER_ADDR`` /
    ``MASTER_PORT`` of the environment, the world size and rank to
    ``WORLD_SIZE`` / ``RANK``, as ``torchrun`` sets them."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group: wait for every process (a barrier), then
    destroy the group. A process that exits with the group alive may
    abort in its teardown ("terminate called without an active
    exception") while another process still talks to the store that
    process 0 hosts. Nothing to do in one process."""
    d = _dist()
    if d is None:
        return
    d.barrier()
    d.destroy_process_group()


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def is_primary() -> bool:
    """True on the process that writes artifacts (every process holds the
    full results after :func:`gather_to_host`)."""
    return process_index() == 0


def local_rank() -> int:
    """This process's index among those of its machine (``LOCAL_RANK``,
    else its global rank)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def local_device(kind: str = "cuda") -> torch.device:
    """The device this process runs on: ``cuda:{local_rank % cards}``, so
    ranks share the cards of their machine round robin; the CPU for
    ``kind="cpu"``."""
    if kind != "cuda":
        return torch.device(kind)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "versions of the kernels on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def local_slice(n_global: int, pid: Optional[int] = None,
                cnt: Optional[int] = None) -> slice:
    """The contiguous block of a global batch this process feeds."""
    pid = process_index() if pid is None else pid
    cnt = process_count() if cnt is None else cnt
    if n_global % cnt:
        raise ValueError(
            f"global batch {n_global} does not divide over {cnt} "
            f"processes — pick a --batch_size that is a multiple of the "
            f"process count (drop_last batching keeps sizes uniform)")
    per = n_global // cnt
    return slice(pid * per, (pid + 1) * per)


def put_global(x, device) -> torch.Tensor:
    """A host array every process holds alike -> a tensor on ``device``
    (the identity onto the local device: nothing is split)."""
    return torch.as_tensor(np.asarray(x)).to(device)


def _gather_objects(obj) -> list:
    """Every process's ``obj``, in rank order (``[obj]`` in one process)."""
    d = _dist()
    if d is None or d.get_world_size() == 1:
        return [obj]
    parts: List[Optional[object]] = [None] * d.get_world_size()
    d.all_gather_object(parts, obj)
    return parts


def gather_to_host(x, axis: int = 0) -> np.ndarray:
    """Every process's block of ``x`` (a tensor or array), concatenated
    along ``axis`` in rank order, on every process, as numpy. One process:
    ``x`` as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    parts = _gather_objects(np.asarray(x))
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)


def put_local_shard(x_local, global_batch: int, device) -> torch.Tensor:
    """This process's ``local_slice`` rows of a global batch (a tensor, of
    any type, or an array) -> the global batch on ``device``, every
    process's rows in order."""
    part = (x_local.detach().cpu() if isinstance(x_local, torch.Tensor)
            else torch.as_tensor(np.asarray(x_local)))
    if process_count() == 1 and part.shape[0] != global_batch:
        raise ValueError(
            f"single-process put_local_shard got {part.shape[0]} rows "
            f"for a global batch of {global_batch}")
    full = torch.cat(_gather_objects(part))
    if full.shape[0] != global_batch:
        raise ValueError(f"the processes' blocks hold {full.shape[0]} rows "
                         f"for a global batch of {global_batch}")
    return full.to(device)


def env_requested() -> bool:
    """True when the environment asks for a multi-process run
    (``CONZIC_MULTIHOST=1``)."""
    return os.environ.get("CONZIC_MULTIHOST") == "1"
