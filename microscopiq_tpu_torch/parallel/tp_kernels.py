"""Tensor-parallel wrappers around the port's serving kernels.

Counterpart of ``microscopiq_tpu/parallel/tp_pallas.py`` (``shard_map``
over the Pallas kernels) on ``torch.distributed``: each rank runs the
single-card kernel on its block, and the outputs are gathered over the
mesh's ``model`` axis.

* :func:`tp_dequant_matmul` is column-parallel: the packed (K, N) weight
  splits along N, x is replicated, each rank runs ``dequant_matmul`` on its
  columns (the ``gemv_tc`` GEMV up to 64 rows, the sm90 GEMM above).
* :func:`tp_quant_attention_decode` splits heads: q on H, every per-head
  cache buffer on its KV-head axis (axis 2; ``res_k``/``res_v`` axis 3),
  the GEAR token bases ``k_q``/``v_q`` (no head axis) replicated; each rank
  runs ``quant_attention.cu`` on its heads.

Where JAX's bodies take the plain twin off a TPU, these never do: a CUDA
tensor runs the kernel (or raises), and the plain version serves only CPU
tensors, as every wrapper of ``ops/cuda`` does. ``rank`` computes one
rank's block without a process group (a test runs every rank in one
process); ``gather=False`` returns the block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.cuda.dequant_matmul import dequant_matmul
from ..ops.cuda.quant_attention import quant_attention_decode
from ..ops.packing import PackedMX, to_serving_layout
from .distributed import all_gather
from .mesh import Mesh, take_columns

# KV-head axis of each buffer of a quantized cache layer tuple (kq, k_mn,
# k_sc, vq, v_mn, v_sc, res_k, res_v, k_p, k_q, v_p, v_q); None: replicated
_KVH_AXIS = (2, 2, 2, 2, 2, 2, 3, 3, 2, None, 2, None)


def _index(mesh: Mesh, axis: str, rank: Optional[int]):
    return mesh.shape[axis], mesh.coords(rank)[axis]


def tp_dequant_matmul(mesh: Mesh, x: torch.Tensor, w: PackedMX,
                      axis: str = "model", out_dtype=torch.float32,
                      rank: Optional[int] = None,
                      gather: bool = True) -> torch.Tensor:
    """Column-parallel y = x @ dequant(w). w: the whole (K, N) PackedMX
    (axis 0, any transport); this rank multiplies its N / m columns.
    Returns y (.., N) gathered over ``axis``, or this rank's (.., N / m)."""
    m, r = _index(mesh, axis, rank)
    ws = to_serving_layout(w)
    N = ws.codes.shape[-1]
    if N % m:
        raise ValueError(f"N={N} does not split {m} ways")
    local = take_columns(ws, [(r * N // m, (r + 1) * N // m)])
    y = dequant_matmul(x, local, out_dtype=out_dtype)
    return all_gather(y, mesh.group(axis), dim=-1) if gather else y


def tp_quant_attention_decode(mesh: Mesh, q: torch.Tensor,
                              state_full: Sequence[torch.Tensor], layer: int,
                              length, v_group: int, scale: float,
                              axis: str = "model",
                              rank: Optional[int] = None,
                              gather: bool = True) -> torch.Tensor:
    """Head-parallel quantized-KV decode attention. q (B, H, hd) and the
    whole cache buffers (``quant_attention_decode``'s tuple); this rank
    takes its H / m query heads and KVH / m KV heads (GQA groups never
    straddle ranks). Returns (B, H, hd) gathered over ``axis``, or this
    rank's (B, H / m, hd)."""
    m, r = _index(mesh, axis, rank)
    KVH = state_full[0].shape[2]
    B, H, hd = q.shape
    if KVH % m or H % m:
        raise ValueError(f"KVH {KVH} and H {H} must split {m} ways")
    hl, kl = H // m, KVH // m
    local = tuple(
        b if ax is None else b.narrow(ax, r * kl, kl).contiguous()
        for b, ax in zip(state_full, _KVH_AXIS))
    y = quant_attention_decode(q[:, r * hl:(r + 1) * hl].contiguous(), local,
                               layer, length, v_group, scale)
    return all_gather(y, mesh.group(axis), dim=1) if gather else y
