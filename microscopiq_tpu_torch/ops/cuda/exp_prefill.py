"""Prefill-GEMM experiments: the CUDA kernels of ``csrc/exp_prefill.cu``,
their wrappers and their plain PyTorch versions.

Counterparts of the Pallas kernels of ``scripts/exp_prefill_*.py``, which
take the packed prefill GEMM apart (the scripts that drive them are
:mod:`microscopiq_tpu_torch.scripts`):

* :func:`gemm_pre` (``pre_kernel``): y = x @ Wd with Wd already bf16,
  through the shipped GEMM's tile loop (128 x 128 x 32);
* :func:`gemm_tiles` (tiles2's ``kern``): that body, or the emi8 decode, at
  the tiles of :data:`TILES`, f32 or bf16 out;
* :func:`gemm_unroll` (``unroll_kernel``): a K step in ``s`` sub-chunks, the
  decode of s+1 issued before the MMAs of s or after them; emi8 or the int8
  container;
* :func:`gemm_pipe` (``pipe_kernel``): two A/B stages along K;
* :func:`gemm_rx` (``rx_kernel``): 16 rows of x resident for the whole K,
  pipelined along N.

Every wrapper checks its tile configuration first, on any device: a tile
that does not divide the shape, K that is not a multiple of the block, more
shared memory than a block has (232,448 bytes), ``s`` that does not cut the
K step into sub-chunks of 16 rows, or a configuration that was not compiled
raises ``ValueError``. Then tensors on the CPU go to the plain version and
count no launch; tensors on a CUDA device go to the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import packing as pk
from . import build
from . import dequant_matmul as dm
from . import operands as op

SMEM_MAX = 232448                 # bytes of shared memory a block may take
_PAD = 8                          # kPad: bf16 row padding of the tiles
_WARPS = 8                        # kThreads / 32
RX_ROWS = 16                      # kRxRows: x rows a resident-x block holds
PRE_TILE = (128, 128, 32)         # common.cuh's kGemmBM, kGemmBN, kGemmBK

# (source, bm, bn, bk) compiled for gemm_tiles; "pre" copies bf16 weights,
# "emi8" decodes them
TILES = (("pre", 128, 128, 32), ("pre", 128, 128, 64), ("pre", 128, 256, 32),
         ("pre", 256, 128, 32), ("pre", 64, 128, 32), ("pre", 128, 64, 32),
         ("emi8", 128, 128, 32), ("emi8", 128, 128, 64),
         ("emi8", 128, 256, 32), ("emi8", 256, 128, 32))
# (decode, s, interleave, bm, bn, bk) compiled for gemm_unroll
UNROLL = (("native", 1, False, 128, 128, 64), ("emi8", 1, False, 128, 128, 64),
          ("emi8", 4, False, 128, 128, 64), ("emi8", 4, True, 128, 128, 64),
          ("emi8", 8, True, 128, 128, 128), ("emi8", 4, True, 128, 256, 64),
          ("emi8", 8, True, 128, 128, 256))
PIPE = ((128, 128, 32), (128, 256, 32))          # (bm, bn, bk)
RX = ((256, 32), (512, 32))                      # (tn, bk)

_SRC = {"pre": 0, "emi8": 1}
_DECODE_IDS = {"emi8": 0, "native": 1}           # mxq::kEmi8, mxq::kInt8


def tiles_key(src: str, bm: int, bn: int, bk: int) -> str:
    """The launch-count key of one compiled gemm_tiles configuration."""
    return f"exp_gemm_tiles_{src}_{bm}x{bn}x{bk}"


# launches per kernel (per compiled configuration of the sweep), for showing
# that a run went through the kernels
launch_counts = {"exp_gemm_pre": 0, **{tiles_key(*c): 0 for c in TILES},
                 "exp_gemm_unroll": 0, "exp_gemm_pipe": 0, "exp_gemm_rx": 0}

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"exp_gemm_pre": [_ptr] * 3 + [_int] * 3 + [_ptr],
            "exp_gemm_tiles": [_ptr] * 4 + [_int] * 11 + [_ptr],
            "exp_gemm_unroll": [_ptr] * 4 + [_int] * 12 + [_ptr],
            "exp_gemm_pipe": [_ptr] * 4 + [_int] * 9 + [_ptr],
            "exp_gemm_rx": [_ptr] * 4 + [_int] * 9 + [_ptr]}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# shared memory of each kernel (the C++ structs TileSmem, UnrollSmem, ...)
# ---------------------------------------------------------------------------
def tiles_smem(bm: int, bn: int, bk: int) -> int:
    return (bm * (bk + _PAD) + bk * (bn + _PAD)) * 2 + _WARPS * 256 * 4


def unroll_smem(bm: int, bn: int, bk: int, s: int) -> int:
    return (bm * (bk + _PAD) + 2 * (bk // s) * (bn + _PAD)) * 2


def pipe_smem(bm: int, bn: int, bk: int) -> int:
    return 2 * (bm * (bk + _PAD) + bk * (bn + _PAD)) * 2


def rx_smem(K: int, tn: int, bk: int) -> int:
    return 2 * bk * (tn + _PAD) * 2 + RX_ROWS * (K + _PAD) * 2


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def _check_tiles(what: str, M: int, N: int, K: int, bm: int, bn: int,
                 bk: int, smem: int) -> None:
    for name, dim, t in (("M", M, bm), ("N", N, bn), ("K", K, bk)):
        if t <= 0 or dim % t:
            raise ValueError(f"{what}: the {name} tile {t} does not divide "
                             f"{name} = {dim}")
    if smem > SMEM_MAX:
        raise ValueError(f"{what}: {smem} bytes of shared memory pass the "
                         f"{SMEM_MAX} a block may take")


def _kernel(name: str):
    return build.entry("exp_prefill", name, _ENTRIES[name])


def _launched(err: int, key: str) -> None:
    build.check(err, key)
    launch_counts[key] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def reference(x: torch.Tensor, w, out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of every kernel here: for a (K, N) bf16 weight, x
    rounded to bf16 and a float32 product of the bf16 values (on CUDA this
    assumes TF32 matmul is off); for a packed one,
    ``dequant_matmul_reference``."""
    if isinstance(w, torch.Tensor):
        y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                         w.to(torch.float32))
        return y.to(out_dtype)
    return dm.dequant_matmul_reference(x, w, out_dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _dense_weight(x: torch.Tensor, wd: torch.Tensor) -> Tuple[int, int, int]:
    if wd.dim() != 2 or wd.dtype != torch.bfloat16:
        raise ValueError(f"wd must be a (K, N) bf16 matrix, got "
                         f"{tuple(wd.shape)} {wd.dtype}")
    K, N = wd.shape
    M, _ = op.x2d(x, K)
    return M, K, N


def gemm_pre(x: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """y = x @ wd (f32) through the shipped GEMM's tile loop, whose B tile
    here is a straight copy of the bf16 weights."""
    M, K, N = _dense_weight(x, wd)
    # static shared memory of common.cuh's gemm_tile, well under the limit
    _check_tiles("gemm_pre", M, N, K, *PRE_TILE, smem=0)
    if x.device.type == "cpu":
        return reference(x, wd)
    x2 = x.to(torch.bfloat16).contiguous()
    op.on_card(x2, wd)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _launched(_kernel("exp_gemm_pre")(x2.data_ptr(), wd.data_ptr(),
                                      out.data_ptr(), M, K, N, op.stream(x)),
              "exp_gemm_pre")
    return out


def gemm_tiles(x: torch.Tensor, w, *, bm: int, bn: int, bk: int,
               out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ W at tiles (bm, bn, bk): W a (K, N) bf16 matrix (the pre
    body) or an emi8 PackedMX (the decode body); f32 or bf16 out."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} is neither f32 nor bf16")
    if isinstance(w, torch.Tensor):
        src = "pre"
        M, K, N = _dense_weight(x, w)
        ops, B, mw, fold = (w, w), 0, 0, 0
    else:
        src = "emi8"
        ww, _, fold, mw = op.serving_packed(w, ("emi8",))
        NB, B, N = ww.codes.shape
        M, K = op.x2d(x, NB * B)
        ops = (ww.codes, ww.scale_exp)
    _check_tiles("gemm_tiles", M, N, K, bm, bn, bk, tiles_smem(bm, bn, bk))
    op.compiled("gemm_tiles", (src, bm, bn, bk), TILES)
    if x.device.type == "cpu":
        return reference(x, w, out_dtype)
    x2 = x.to(torch.bfloat16).contiguous()
    op.on_card(x2, *ops)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    key = tiles_key(src, bm, bn, bk)
    _launched(_kernel("exp_gemm_tiles")(
        x2.data_ptr(), ops[0].data_ptr(), ops[1].data_ptr(), out.data_ptr(),
        M, K, N, B, _SRC[src], bm, bn, bk, mw, fold,
        int(out_dtype == torch.bfloat16), op.stream(x)), key)
    return out


def gemm_unroll(x: torch.Tensor, w: pk.PackedMX, *, s: int, interleave: bool,
                bm: int, bn: int, bk: int) -> torch.Tensor:
    """y = x @ dequant(w) (f32), each bk-deep K step in ``s`` sub-chunks,
    the decode of sub-chunk s+1 issued before the MMAs of s (interleave) or
    decode then MMAs; emi8 or the int8 container."""
    ww, decode, fold, mw = op.serving_packed(w, ("emi8", "native"))
    NB, B, N = ww.codes.shape
    M, K = op.x2d(x, NB * B)
    if s <= 0 or bk % s or (bk // s) % 16:
        raise ValueError(f"gemm_unroll: s = {s} does not cut the K step "
                         f"{bk} into sub-chunks of a multiple of 16 rows")
    _check_tiles("gemm_unroll", M, N, K, bm, bn, bk,
                 unroll_smem(bm, bn, bk, s))
    op.compiled("gemm_unroll", (decode, s, bool(interleave), bm, bn, bk),
              UNROLL)
    if x.device.type == "cpu":
        return reference(x, w)
    x2 = x.to(torch.bfloat16).contiguous()
    op.on_card(x2, ww.codes, ww.scale_exp)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _launched(_kernel("exp_gemm_unroll")(
        x2.data_ptr(), ww.codes.data_ptr(), ww.scale_exp.data_ptr(),
        out.data_ptr(), M, K, N, B, _DECODE_IDS[decode], s, int(interleave),
        bm, bn, bk, mw, fold, op.stream(x)), "exp_gemm_unroll")
    return out


def gemm_pipe(x: torch.Tensor, w: pk.PackedMX, *, bm: int, bn: int,
              bk: int) -> torch.Tensor:
    """y = x @ dequant(w) (f32, emi8) with two A/B stages along K: x of
    step k+1 by cp.async and the codes of k+1 into registers before the
    MMAs of k, their decode after; one barrier a step."""
    ww, _, fold, mw = op.serving_packed(w, ("emi8",))
    NB, B, N = ww.codes.shape
    M, K = op.x2d(x, NB * B)
    _check_tiles("gemm_pipe", M, N, K, bm, bn, bk, pipe_smem(bm, bn, bk))
    op.compiled("gemm_pipe", (bm, bn, bk), PIPE)
    if x.device.type == "cpu":
        return reference(x, w)
    x2 = x.to(torch.bfloat16).contiguous()
    op.on_card(x2, ww.codes, ww.scale_exp)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _launched(_kernel("exp_gemm_pipe")(
        x2.data_ptr(), ww.codes.data_ptr(), ww.scale_exp.data_ptr(),
        out.data_ptr(), M, K, N, B, bm, bn, bk, mw, fold, op.stream(x)),
        "exp_gemm_pipe")
    return out


def rx_tiles_per_block(M: int, N: int, tn: int, sms: int) -> int:
    """N tiles a resident-x block walks: the N tiles are shared out over as
    many blocks per x panel as keep the grid within one wave of ``sms``
    blocks (one resident-x block fits an SM), so each panel is fetched as
    few times as that allows."""
    panels, ntiles = M // RX_ROWS, N // tn
    split = max(1, min(ntiles, sms // max(panels, 1)))
    while ntiles % split:
        split -= 1
    return ntiles // split


def gemm_rx(x: torch.Tensor, w: pk.PackedMX, *, tn: int,
            bk: int = 32) -> torch.Tensor:
    """y = x @ dequant(w) (f32, emi8) with 16 rows of x resident in shared
    memory for the whole K, walking N tiles of ``tn`` columns."""
    ww, _, fold, mw = op.serving_packed(w, ("emi8",))
    NB, B, N = ww.codes.shape
    M, K = op.x2d(x, NB * B)
    _check_tiles("gemm_rx", M, N, K, RX_ROWS, tn, bk, rx_smem(K, tn, bk))
    op.compiled("gemm_rx", (tn, bk), RX)
    if x.device.type == "cpu":
        return reference(x, w)
    x2 = x.to(torch.bfloat16).contiguous()
    op.on_card(x2, ww.codes, ww.scale_exp)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tiles = rx_tiles_per_block(M, N, tn, sms)
    _launched(_kernel("exp_gemm_rx")(
        x2.data_ptr(), ww.codes.data_ptr(), ww.scale_exp.data_ptr(),
        out.data_ptr(), M, K, N, B, tn, bk, tiles, mw, fold, op.stream(x)),
        "exp_gemm_rx")
    return out
