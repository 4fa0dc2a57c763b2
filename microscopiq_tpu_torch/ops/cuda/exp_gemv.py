"""Decode-GEMV experiments: the CUDA kernels of ``csrc/exp_gemv.cu``, their
wrappers and their plain PyTorch versions.

Counterparts of the Pallas kernels of ``scripts/exp_decode_variants.py`` and
``scripts/exp_nb_variants.py``, and of the GEMV that
``scripts/exp_sad_tiles.py`` sweeps (the scripts that drive them are
:mod:`microscopiq_tpu_torch.scripts`):

* :func:`gemv_variant` (``make_kernel``'s ``kern``): the scale-after-dot
  GEMV over MX-FP6 emi8 codes with one decode body a variant of
  :data:`VARIANTS`, at the tile :data:`VARIANT_TILE`; ``ebf8`` takes the
  weight that :func:`ebf8_weight` re-encodes, ``zero`` converts the code as
  it is (wrong numerics on purpose, the decode's floor);
* :func:`gemv_tiles` (the GEMV of ``exp_sad_tiles``): the shipped f32 decode
  at a compiled tile of :data:`TILES`, (rows of x a block, columns a block,
  K blocks a split); ``(8, 512, 7)`` is the shipped GEMV's at
  (4096, 28672). The split count ceil(NB / KB) depends on the shape and the
  tile, never on M;
* :func:`fd_matmul` (``_fd_kernel``, wrapper ``fd_matmul``): the compact NB
  int2 + fp4 GEMV, inliers field by field, in every mode of the TPU kernel.

The modes of :func:`fd_matmul`, what each computes, and its strategy on the
TPU and on the card (a block owns one N-block of 16 rows, so the TPU's
field-major row order is the card's row order):

=========  ======================  =========================  =====================================
mode       computes                TPU (``_fd_kernel``)        card (``csrc/exp_gemv.cu::nb_fd``)
=========  ======================  =========================  =====================================
fd         inliers + outliers      4 field dots; outliers by  fields; a 16-row outlier column from
                                   a full-size masked          selects, a second fmaf pass into the
                                   scatter and a second dot    same sums
fd_dot     inliers + outliers      one-hot weights, field-     per slot, 16 one-hot fmafs into the
                                   major, a second dot into    same sums
                                   the same accumulator
fd_sc      inliers + outliers      slots scattered into each   slots merged into each field's
                                   field before its dot        weights before the fmaf (the shipped
                                                               GEMV's way, field by field)
pdot       inliers + outliers      16 position planes (2-D)    16 position planes (one-hot selects)
                                   dotted into a second        into a second register accumulator,
                                   accumulator                 4 rows of x a block (8 would take 256
                                                               accumulator registers)
pdot3      inliers + outliers      the same planes as one 3-D  position-indexed adds into a
                                   broadcast                   per-thread accumulator in shared
                                                               memory, summed in thread order
in_only    inliers                 field dots only             fields only
in_dot1    unscaled inlier codes   field dots, no scale        fields, no scale
out_only   outliers                as fd, no inliers           as fd, no inliers
out_pdot   outliers                as pdot, no inliers         as pdot, no inliers
=========  ======================  =========================  =====================================

The full modes equal ``dequant_matmul_nb_reference`` up to the order of
the f32 sums; each ablation is held to its own plain version. ``tk0`` is the
K span of a block (the TPU's TK; ``k1024`` arms: 1024), halved while it
passes K and 128, as the TPU wrapper does.

Every wrapper checks its configuration first, on any device: a variant,
tile or mode that was not compiled, a tile whose x passes 232,448 bytes of
shared memory, or a weight the kernel does not decode raises
``ValueError``. Then tensors on the CPU go to the plain version and count
no launch; tensors on a CUDA device go to the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from .. import packing as pk
from ..elemwise import mul_pow2
from . import build
from . import dequant_matmul as dm
from . import exp_prefill as ep
from . import operands as op
from . import outlier_matmul as om

SMEM_MAX = ep.SMEM_MAX            # bytes of shared memory a block may take
VARIANTS = ("i32", "i16", "ebf8", "f32dot", "zero")
VARIANT_TILE = (8, 512, 4)        # (MT, TN, KB) of the variant kernel
# (MT, TN, KB) compiled for gemv_tiles: csrc/exp_gemv.cu's MXQ_EXP_TILES
TILES = ((8, 512, 7), (8, 256, 4), (8, 256, 16), (8, 512, 4), (8, 512, 16),
         (8, 512, 32), (8, 1024, 8), (8, 1024, 16), (8, 1024, 32),
         (8, 2048, 16), (8, 2048, 64), (8, 2048, 128), (4, 512, 7),
         (4, 1024, 16), (16, 1024, 16))
# fd_matmul mode -> the kernel's mode id
MODES = {"fd": 0, "fd_dot": 1, "fd_sc": 2, "pdot": 3, "pdot3": 4,
         "in_only": 5, "in_dot1": 6, "out_only": 7, "out_pdot": 8}
FULL_MODES = ("fd", "fd_dot", "fd_sc", "pdot", "pdot3")
# an ablation mode -> the part of the weight its plain version multiplies
ABLATIONS = {"in_only": "inliers", "in_dot1": "codes",
             "out_only": "outliers", "out_pdot": "outliers"}
# an ablation mode -> the compact-NB streams its function reads (a full mode
# reads all four); the kernel loads se in every mode
_OUT_STREAMS = ("scale_exp", "out_scale_exp", "out_byte")
STREAMS = {"in_only": ("codes", "scale_exp"), "in_dot1": ("codes",),
           "out_only": _OUT_STREAMS, "out_pdot": _OUT_STREAMS}
EBF8_SHIFT = 126                  # ebf8 values are |value| * 2^-126
NB_MAX_BUDGET = 8                 # kMaxBudget in exp_gemv.cu
_VARIANT_IDS = {v: i for i, v in enumerate(VARIANTS)}


def variant_key(variant: str) -> str:
    return f"exp_gemv_{variant}"


def tiles_key(mt: int, tn: int, kb: int) -> str:
    """The launch-count key of one compiled gemv_tiles configuration."""
    return f"exp_gemv_tiles_{mt}x{tn}x{kb}"


def fd_key(mode: str) -> str:
    return f"exp_nb_fd_{mode}"


# launches per kernel (per variant, tile and mode), for showing that a run
# went through the kernels
launch_counts = {**{variant_key(v): 0 for v in VARIANTS},
                 **{tiles_key(*t): 0 for t in TILES},
                 **{fd_key(m): 0 for m in MODES}}

_ptr, _int = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"exp_gemv_variant": [_ptr] * 5 + [_int] * 8 + [_ptr],
            "exp_gemv_tiles": [_ptr] * 5 + [_int] * 10 + [_ptr],
            "exp_nb_fd": [_ptr] * 7 + [_int] * 8 + [_ptr]}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _kernel(name: str):
    return build.entry("exp_gemv", name, _ENTRIES[name])


def _launched(err: int, key: str) -> None:
    build.check(err, key)
    launch_counts[key] += 1


def fd_bytes(w: pk.PackedOutlierNB, mode: str) -> int:
    """Bytes of the weight that ``mode``'s function reads (:data:`STREAMS`;
    a full mode: the whole weight), for its byte bound."""
    if mode not in STREAMS:
        return w.nbytes()
    return sum(getattr(w, s).numel() * getattr(w, s).element_size()
               for s in STREAMS[mode])


def tiles_smem(mt: int, kb: int, block: int) -> int:
    """Bytes of shared memory of a gemv_tiles block: its split's x in f32."""
    return 4 * mt * kb * block


# ---------------------------------------------------------------------------
# the ebf8 re-encode (scripts/exp_decode_variants.py:55-72)
# ---------------------------------------------------------------------------
def _bit_length(a: torch.Tensor) -> torch.Tensor:
    """floor(log2 a) + 1 for a > 0, 0 for a = 0 (int32, a < 2^31)."""
    n = torch.zeros_like(a)
    t = a
    for sh in (16, 8, 4, 2, 1):
        big = t >= (1 << sh)
        n = n + big.to(a.dtype) * sh
        t = torch.where(big, t >> sh, t)
    return n + (t > 0).to(a.dtype)


def ebf8_encode(codes: torch.Tensor, mw: int) -> torch.Tensor:
    """emi8 bytes -> ebf8 bytes ``s | E5 | m2``, where the bf16 with bits
    ``((b & 0x7F) << 5) | ((b & 0x80) << 8)`` is the emi8 value m̂ · 2^e'
    times 2^-126 (byte 0 is zero), in integer ops on the codes' device. Bit
    for bit the TPU script's numpy (frexp, round), which is exact for values
    of at most 3 significant bits; others raise ValueError."""
    c = codes.to(torch.int32)
    mhat = c >> (8 - mw)
    val = mhat << (c & ((1 << (8 - mw)) - 1))
    a = val.abs()
    E = _bit_length(a)                       # |val| = 1.f * 2^(E - 1)
    nz = a > 0
    sh = torch.clamp(E - 1, min=0)
    frac = torch.where(nz, ((a << 2) >> sh) - 4, 0)
    if bool((E >= 32).any()) or bool(
            (nz & (((frac + 4) << sh) != (a << 2))).any()):
        raise ValueError("an emi8 value needs more than 5 exponent or 2 "
                         "fraction bits of an ebf8 byte")
    sgn = (val < 0).to(torch.int32)
    return ((sgn << 7) | (E << 2) | frac).to(torch.uint8).view(torch.int8)


def ebf8_decode(codes: torch.Tensor) -> torch.Tensor:
    """ebf8 bytes -> their bf16 values (|value| · 2^-126), as f32."""
    b = codes.to(torch.int32) & 0xFF
    bits = ((b & 0x7F) << 5) - ((b & 0x80) << 8)     # as a signed 16-bit
    return bits.to(torch.int16).view(torch.bfloat16).to(torch.float32)


def ebf8_weight(w: pk.PackedMX) -> pk.PackedMX:
    """The ebf8 arm's weight: an emi8 PackedMX's codes re-encoded, its
    transport "ebf8", ``transport_mw`` the emi8 field split and
    ``transport_fold`` the fold minus 126 (the 2^126 that the bytes lose
    comes back through the block scale). No shipped kernel takes it."""
    ww, fold, mw = _emi8(w)
    return dataclasses.replace(ww, codes=ebf8_encode(ww.codes, mw),
                               transport="ebf8", transport_mw=mw,
                               transport_fold=fold - EBF8_SHIFT)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def _emi8(w: pk.PackedMX) -> Tuple[pk.PackedMX, int, int]:
    """(serving-layout weight, fold, mw) of a (K, N) emi8 weight whose K is
    a whole number of blocks; else ValueError."""
    if not isinstance(w, pk.PackedMX) or w.transport != "emi8" or w.axis:
        raise ValueError(f"the kernel takes (K, N) emi8 weights blocked on "
                         f"axis 0, got {getattr(w, 'transport', type(w))}")
    ww, _, fold, mw = op.serving_packed(w, ("emi8",))
    return ww, fold, mw


def _variant_operands(w: pk.PackedMX, variant: str):
    """(serving-layout weight, fold, mw) of the variant's weight."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} was not compiled; the kernel "
                         f"takes {VARIANTS}")
    if variant != "ebf8":
        return _emi8(w)
    if not isinstance(w, pk.PackedMX) or w.transport != "ebf8":
        raise ValueError("the ebf8 variant takes ebf8_weight(w)")
    ww = pk.to_serving_layout(w)
    NB, rows, N = ww.codes.shape
    if rows != ww.block_size or w.orig_dim != NB * rows:
        raise ValueError(f"ebf8 codes {tuple(ww.codes.shape)} are not a "
                         f"whole-block serving layout")
    return ww, w.transport_fold, w.transport_mw


def _nb_checks(w: pk.PackedOutlierNB, mode: str, tk0: int) -> int:
    """The K span a block covers; ValueError for a mode that was not
    compiled, a weight the kernel does not decode or a bad span."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} was not compiled; the kernel takes "
                         f"{list(MODES)}")
    if not isinstance(w, pk.PackedOutlierNB) or w.block_size != 16:
        raise ValueError("the kernel takes the compact NB transport at "
                         "block 16")
    if w.elem_format != "int2" or w.outlier_format not in ("fp4",
                                                           "fp4_e2m1"):
        raise ValueError(f"the kernel decodes int2 + fp4, got "
                         f"{w.elem_format} + {w.outlier_format}")
    if not 0 <= w.budget <= NB_MAX_BUDGET:
        raise ValueError(f"budget {w.budget} > {NB_MAX_BUDGET}")
    tk = tk0
    while tk > w.orig_k and tk > 128:
        tk //= 2
    if tk <= 0 or tk % 4:
        raise ValueError(f"the K span {tk} is not a positive multiple of 4")
    return tk


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _plain_matmul(x: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 times a (K, N) f32 weight, f32 sums (on CUDA this
    assumes TF32 matmul is off)."""
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32), dense)


def variant_weight(w: pk.PackedMX, variant: str) -> torch.Tensor:
    """The (K, N) f32 weight that a variant multiplies: its decode of the
    codes times 2^(se - fold) with its own fold. i32, i16, f32dot and ebf8
    give the emi8 weight; zero the codes as values."""
    ww, fold, mw = _variant_operands(w, variant)
    NB, B, N = ww.codes.shape
    if variant == "ebf8":
        vals = ebf8_decode(ww.codes)
    elif variant == "zero":
        vals = ww.codes.to(torch.float32)
    else:
        c = ww.codes.to(torch.int32)
        vals = (c >> (8 - mw) << (c & ((1 << (8 - mw)) - 1))).to(
            torch.float32)
    se = ww.scale_exp.to(torch.float32) - fold
    return mul_pow2(vals, se[:, None, :]).reshape(NB * B, N)


def variant_reference(x: torch.Tensor, w: pk.PackedMX,
                      variant: str) -> torch.Tensor:
    """Plain version of :func:`gemv_variant`: x (bf16-rounded) times the
    variant's weight, f32 out."""
    return _plain_matmul(x, variant_weight(w, variant))


def fd_reference(x: torch.Tensor, w: pk.PackedOutlierNB,
                 mode: str) -> torch.Tensor:
    """Plain version of :func:`fd_matmul`'s ``mode``: a full mode is
    ``dequant_matmul_nb_reference``; an ablation, x (bf16-rounded) times its
    part of the weight (:data:`ABLATIONS`), f32 out."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} was not compiled; the kernel takes "
                         f"{list(MODES)}")
    x2 = x.reshape(-1, x.shape[-1])
    if mode in FULL_MODES:
        return om.dequant_matmul_nb_reference(x2, w)
    return _plain_matmul(x2, pk.outlier_nb_parts(w)[ABLATIONS[mode]].T)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def gemv_variant(x: torch.Tensor, w: pk.PackedMX,
                 variant: str) -> torch.Tensor:
    """y = x @ W (f32) through the variant's decode body at
    :data:`VARIANT_TILE`; ``w`` an emi8 PackedMX, or for ``ebf8`` its
    :func:`ebf8_weight`."""
    ww, fold, mw = _variant_operands(w, variant)
    NB, B, N = ww.codes.shape
    M, K = op.x2d(x, NB * B)
    mt, tn, kb = VARIANT_TILE
    if tiles_smem(mt, kb, B) > SMEM_MAX:
        raise ValueError(f"block {B}: x passes {SMEM_MAX} bytes of shared "
                         "memory")
    if x.device.type == "cpu":
        return variant_reference(x, w, variant)
    x2 = x.to(torch.bfloat16).contiguous()
    op.on_card(x2, ww.codes, ww.scale_exp)
    ws = torch.empty((-(-NB // kb), M, N), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _launched(_kernel("exp_gemv_variant")(
        x2.data_ptr(), ww.codes.data_ptr(), ww.scale_exp.data_ptr(),
        ws.data_ptr(), out.data_ptr(), M, K, N, NB, B, _VARIANT_IDS[variant],
        mw, fold, op.stream(x)), variant_key(variant))
    return out


def gemv_tiles(x: torch.Tensor, w: pk.PackedMX, *, mt: int, tn: int,
               kb: int) -> torch.Tensor:
    """y = x @ dequant(w) (f32, emi8) through the shipped decode at tile
    (mt rows of x, tn columns, kb K blocks a split)."""
    ww, fold, mw = _emi8(w)
    NB, B, N = ww.codes.shape
    M, K = op.x2d(x, NB * B)
    op.compiled("gemv_tiles", (mt, tn, kb), TILES)
    smem = tiles_smem(mt, kb, B)
    if smem > SMEM_MAX:
        raise ValueError(f"gemv_tiles: {smem} bytes of shared memory pass "
                         f"the {SMEM_MAX} a block may take")
    if x.device.type == "cpu":
        return dm.dequant_matmul_reference(x, w)
    x2 = x.to(torch.bfloat16).contiguous()
    op.on_card(x2, ww.codes, ww.scale_exp)
    ws = torch.empty((-(-NB // kb), M, N), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    _launched(_kernel("exp_gemv_tiles")(
        x2.data_ptr(), ww.codes.data_ptr(), ww.scale_exp.data_ptr(),
        ws.data_ptr(), out.data_ptr(), M, K, N, NB, B, mt, tn, kb, mw, fold,
        op.stream(x)), tiles_key(mt, tn, kb))
    return out


def fd_matmul(x: torch.Tensor, w: pk.PackedOutlierNB, mode: str,
              tk0: int = 512) -> torch.Tensor:
    """y = x @ W^T (f32) for the compact NB transport (W stored (N, K)),
    field by field in ``mode``; ``tk0`` is the K span of a block."""
    tk = _nb_checks(w, mode, tk0)
    if op.on_cpu(x, op.nb_tensors(w)):
        return fd_reference(x, w, mode)
    x2 = op.nb_operands(x, w, torch.float32)
    M, K = x2.shape
    N, Np = w.orig_n, 4 * w.codes.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    ws = torch.empty((-(-K // tk), M, Np), dtype=torch.float32,
                     device=x.device)
    _launched(_kernel("exp_nb_fd")(
        x2.data_ptr(), w.codes.data_ptr(), w.scale_exp.data_ptr(),
        w.out_scale_exp.data_ptr(), w.out_byte.data_ptr(), ws.data_ptr(),
        out.data_ptr(), M, K, Np, N, w.budget, dm.scale_fold(w.elem_format),
        MODES[mode], tk, op.stream(x)), fd_key(mode))
    return out
