"""y = x @ dequant(w) for packed MX weights: the two CUDA kernels of the
serving path, their wrappers and their plain PyTorch twin.

Counterpart of ``microscopiq_tpu/ops/pallas/dequant_matmul.py``
(``dequant_matmul_sad``, ``dequant_matmul``, ``dequant_matmul_reference``),
with the same dispatch: M <= 64 tokens go to the scale-after-dot GEMV
(``csrc/dequant_gemv.cu``), larger M to the tiled GEMM that decodes inside
the kernel (``csrc/dequant_matmul.cu``).

Tensors on the CPU go to the plain version. Tensors on a CUDA device go to a
kernel or raise: there is no silent fallback. The ``emi8`` and ``emi8m``
transports have kernels; the others raise on CUDA (ROADMAP queue 2 items
1-2).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import packing as pk
from . import build

GEMV_MAX_M = 64
GEMV_TILE_N = 512                 # kThreads * kCols in dequant_gemv.cu
_GEMV_TARGET_BLOCKS = 8 * 132     # ~8 blocks per SM of an H100
_GEMV_MIN_BLOCKS_PER_SPLIT = 4    # keeps the f32 partials << the codes

# launches per kernel wrapper, for showing that a run went through the
# kernels; chip_smoke.py zeroes them before the main path and reads them after
launch_counts = {"dequant_gemv_emi8": 0, "dequant_matmul_emi8": 0}

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_ptr, _int = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# C entry points: (source in csrc/, argument types), pointers (and the
# stream) as c_void_p, ints as c_int
_ENTRIES = {"dequant_gemv_emi8": ("dequant_gemv", [_ptr] * 5 + [_int] * 9
                                  + [_ptr]),
            "dequant_matmul_emi8": ("dequant_matmul", [_ptr] * 4 + [_int] * 8
                                    + [_ptr])}


def _kernel(name: str):
    return build.entry(_ENTRIES[name][0], name, _ENTRIES[name][1])


def dequant_matmul_reference(x: torch.Tensor, w: pk.PackedMX,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Plain twin of both kernels: dequantize to bf16, then a dot of the
    bf16 values with f32 accumulation (every product of two bf16 values is
    exact in f32; on CUDA this assumes TF32 matmul is off, the default)."""
    dense = pk.dequantize_mx(w, dtype=torch.bfloat16)      # (K, N)
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                     dense.to(torch.float32))
    return y.to(out_dtype)


def emi8_decode_params(w: pk.PackedMX) -> Tuple[int, int]:
    """(mw, fold) of the in-kernel emi8 decode: the format's for emi8, the
    tensor's own field split for the merged-outlier emi8m stream (as the
    TPU wrapper's ``_sad_fold``); other transports raise."""
    if w.transport == "emi8":
        mw, _, _ = pk.emi8_params(w.elem_format)
        return mw, pk.emi8_fold(w.elem_format)
    if w.transport == "emi8m":
        return w.transport_mw, w.transport_fold
    raise NotImplementedError(
        f"transport {w.transport!r} has no CUDA kernel yet "
        "(ROADMAP queue 2 items 1-2)")


def gemv_ksplit(N: int, NB: int) -> Tuple[int, int]:
    """(ksplit, K-blocks per split) of the GEMV grid.

    Depends only on the weight's shape, never on M, so that a row's result
    is the same in a batch of any size.
    """
    col_tiles = -(-N // GEMV_TILE_N)
    want = max(1, -(-_GEMV_TARGET_BLOCKS // col_tiles))
    per = min(NB, max(_GEMV_MIN_BLOCKS_PER_SPLIT, -(-NB // want)))
    return -(-NB // per), per


def _operands(x: torch.Tensor, w: pk.PackedMX, out_dtype):
    """Checked (x2 bf16 (M, K), serving-layout weight, mw, fold)."""
    mw, fold = emi8_decode_params(w)
    if w.axis != 0:
        raise ValueError("the kernels take (K, N) weights blocked on axis 0")
    ww = pk.to_serving_layout(w)
    if not (x.is_cuda and ww.codes.device == x.device
            and ww.scale_exp.device == x.device):
        raise ValueError("x and the packed weight must be on one CUDA device")
    if ww.codes.dtype != torch.int8 or ww.scale_exp.dtype != torch.int8:
        raise ValueError("emi8 codes and exponents must be int8")
    if not (ww.codes.is_contiguous() and ww.scale_exp.is_contiguous()):
        raise ValueError("packed weight must be contiguous")
    NB, B, N = ww.codes.shape
    if ww.scale_exp.shape != (NB, N) or ww.block_size != B:
        raise ValueError(f"scale_exp {tuple(ww.scale_exp.shape)} does not "
                         f"match codes {tuple(ww.codes.shape)}")
    K = x.shape[-1]
    if K != w.orig_dim or K > NB * B:
        raise ValueError(f"x has K={K}, weight has K={w.orig_dim}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not in {_OUT_DTYPES}")
    x2 = x.reshape(-1, K).to(torch.bfloat16).contiguous()
    return x2, ww, mw, fold


def dequant_gemv(x: torch.Tensor, w: pk.PackedMX,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Scale-after-dot GEMV (M <= 64); x is rounded to bf16 first, as the
    TPU kernel does."""
    if x.device.type == "cpu":
        return dequant_matmul_reference(x, w, out_dtype)
    x2, ww, mw, fold = _operands(x, w, out_dtype)
    M, K = x2.shape
    if not 0 < M <= GEMV_MAX_M:
        raise ValueError(f"GEMV takes 1..{GEMV_MAX_M} rows, got {M}")
    NB, B, N = ww.codes.shape
    ksplit, _ = gemv_ksplit(N, NB)
    ws = torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    err = _kernel("dequant_gemv_emi8")(
        x2.data_ptr(), ww.codes.data_ptr(), ww.scale_exp.data_ptr(),
        ws.data_ptr(), out.data_ptr(), M, K, N, NB, B, mw, fold, ksplit,
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dequant_gemv_emi8")
    launch_counts["dequant_gemv_emi8"] += 1
    return out.reshape(x.shape[:-1] + (N,))


def dequant_gemm(x: torch.Tensor, w: pk.PackedMX,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Tiled GEMM with the emi8 decode inside the kernel (any M; the
    dispatch sends it M > 64)."""
    if x.device.type == "cpu":
        return dequant_matmul_reference(x, w, out_dtype)
    x2, ww, mw, fold = _operands(x, w, out_dtype)
    M, K = x2.shape
    NB, B, N = ww.codes.shape
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out.reshape(x.shape[:-1] + (N,))
    err = _kernel("dequant_matmul_emi8")(
        x2.data_ptr(), ww.codes.data_ptr(), ww.scale_exp.data_ptr(),
        out.data_ptr(), M, K, N, NB * B, B, mw, fold,
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dequant_matmul_emi8")
    launch_counts["dequant_matmul_emi8"] += 1
    return out.reshape(x.shape[:-1] + (N,))


def dequant_matmul(x: torch.Tensor, w: pk.PackedMX,
                   out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(w): the GEMV for M <= 64 tokens, else the GEMM."""
    M = 1
    for d in x.shape[:-1]:
        M *= d
    if 0 < M <= GEMV_MAX_M:
        return dequant_gemv(x, w, out_dtype)
    return dequant_gemm(x, w, out_dtype)
