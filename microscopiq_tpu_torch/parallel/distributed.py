"""Multi-process runtime wiring on ``torch.distributed``.

Counterpart of ``microscopiq_tpu/parallel/distributed.py``: one process per
rank joined through ``torch.distributed.init_process_group`` at an explicit
``tcp://`` address, a global ``(data, model)`` mesh whose model axis holds
consecutive ranks (one host's cards when ranks are numbered host by host),
per-rank batch slices stitched into the global batch, a barrier, a
broadcast from rank 0 and the work-list split.

Everything degrades to a no-op in one process, so one script runs
unchanged on one card or many. The backend is the caller's (``"nccl"``
on cards, ``"gloo"`` on the CPU or across processes that share one
card); a missing backend raises, and none is swapped for another. JAX's
argless TPU-pod auto-detection has no counterpart: nothing on a GPU host
describes a cluster, so the address, world size and rank are given.

Collectives on CUDA tensors over gloo go through host copies (gloo reduces
CUDA tensors but gathers only host ones): see :func:`all_reduce` and
:func:`all_gather`.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def _available(backend: str) -> bool:
    if not dist.is_available():
        return False
    return {"nccl": dist.is_nccl_available,
            "gloo": dist.is_gloo_available}.get(
                backend, lambda: False)()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl", timeout_s: float = 300.0
                     ) -> tuple:
    """Join (or skip joining) the process group. Returns ``(rank,
    world_size)``.

    Resolution order: explicit args, then ``MICROSCOPIQ_COORDINATOR`` /
    ``MICROSCOPIQ_NUM_PROCESSES`` / ``MICROSCOPIQ_PROCESS_ID``; without a
    coordinator, one process and no group: ``(0, 1)``. ``backend`` is
    ``"nccl"`` or ``"gloo"``; one that this build of torch lacks raises
    RuntimeError. Idempotent: a call while a group exists returns its rank
    and size."""
    coordinator_address = coordinator_address or \
        os.environ.get("MICROSCOPIQ_COORDINATOR")
    if num_processes is None and "MICROSCOPIQ_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MICROSCOPIQ_NUM_PROCESSES"])
    if process_id is None and "MICROSCOPIQ_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MICROSCOPIQ_PROCESS_ID"])
    if _grouped():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None:
        return 0, 1
    if not _available(backend):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not "
                           "available in this build")
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    import datetime

    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if _grouped() else 0


def process_count() -> int:
    return dist.get_world_size() if _grouped() else 1


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_hybrid_mesh(ici_model: Optional[int] = None, ici_data: int = 1,
                     dcn_data: Optional[int] = None,
                     n_devices: Optional[int] = None) -> Mesh:
    """Global ``(data, model)`` mesh over the ranks: ``data`` =
    ``dcn_data * ici_data``, ``model`` = ``ici_model``, ranks in row-major
    (host-major) order, so that a row of the model axis is consecutive
    ranks. ``n_devices`` defaults to the world size; in one process it may
    name more devices, for the sharding rules alone (no collective)."""
    n = n_devices or process_count()
    nproc = process_count()
    if dcn_data is None:
        dcn_data = nproc if nproc > 1 else 1
    if ici_model is None:
        ici_model = n // (dcn_data * ici_data)
    data = dcn_data * ici_data
    if data * ici_model != n:
        raise ValueError(f"data {data} x model {ici_model} != {n} devices")
    return Mesh(data, ici_model)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (every
    rank's ``t`` of one shape); through the host under gloo."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    host = dist.get_backend(group) == "gloo" and t.device.type != "cpu"
    src = t.detach().cpu() if host else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place (through the host under gloo)."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    if dist.get_backend(group) == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def global_batch(batch: Any, mesh: Mesh, axis: str = "data",
                 dim: int = 0) -> Any:
    """Stitch each rank's local batch slice into the global batch along
    ``dim`` over the mesh's ``axis`` (tensors or numpy arrays, nested in
    dicts, lists and tuples); the local batch itself in one process."""
    group = mesh.group(axis)

    def one(a):
        if isinstance(a, np.ndarray):
            return all_gather(torch.from_numpy(a), group, dim).numpy()
        return all_gather(a, group, dim)

    return _tree_map(one, batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's tree on every rank of the mesh (a no-op in one process)."""
    if process_count() == 1:
        return tree
    return _tree_map(lambda a: _broadcast_tensor(a), tree)


def _broadcast_tensor(a):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    host = dist.get_backend() == "gloo" and t.device.type != "cpu"
    src = t.cpu().contiguous() if host else t.contiguous()
    dist.broadcast(src, 0)
    out = src.to(t.device) if host else src
    return out if isinstance(a, torch.Tensor) else out.numpy()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def sync(name: str = "barrier") -> None:
    """Barrier over every rank (no-op in one process)."""
    if process_count() > 1:
        dist.barrier()


def broadcast_from_primary(tree: Any) -> Any:
    """Rank 0's (picklable) value on every rank (no-op in one process)."""
    if process_count() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def is_primary() -> bool:
    return process_index() == 0


def split_list(lst: Sequence, n: int) -> List[list]:
    """``lst`` in ``n`` consecutive chunks of ceil(len/n) items (a copy of
    the JAX package's ``vlm/mm_utils.split_list``)."""
    import math

    chunk_size = math.ceil(len(lst) / n)
    return [list(lst[i:i + chunk_size])
            for i in range(0, len(lst), chunk_size)]


def get_chunk(lst: Sequence, n: int, k: int) -> list:
    """Chunk ``k`` of :func:`split_list` (a copy of ``mm_utils.get_chunk``)."""
    return split_list(lst, n)[k]


def process_chunk(items: Sequence, process_index_: Optional[int] = None,
                  process_count_: Optional[int] = None) -> list:
    """This rank's slice of a work list (eval shards, file lists)."""
    return get_chunk(list(items),
                     process_count_ if process_count_ is not None
                     else process_count(),
                     process_index_ if process_index_ is not None
                     else process_index())
