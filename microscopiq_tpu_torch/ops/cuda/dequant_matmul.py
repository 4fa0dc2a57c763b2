"""y = x @ dequant(w) for packed MX weights: the CUDA kernels of the serving
path, their wrappers and their plain PyTorch twins.

Counterpart of ``microscopiq_tpu/ops/pallas/dequant_matmul.py``
(``dequant_matmul_sad``, ``dequant_matmul``, ``dequant_matmul_reference``,
``dequant_matmul_sad_s8`` and its reference, ``quantize_activations_int8``),
with the same dispatch: M <= 64 tokens go to the scale-after-dot GEMV
(``csrc/dequant_gemv.cu``'s ``gemv_tc`` at the blocks that are multiples of
16, ``csrc/gemv_any.cu`` at the others: :func:`gemv_route`), larger M to
the tiled GEMM that decodes inside
the kernel (``csrc/dequant_matmul.cu``; pf6, pf4, sb4, sb2, the fp16,
bf16, int8 and float8 containers and emi8/emi8m on the wgmma + TMA
mainloop of ``csrc/gemm_sm90.cuh``, whose host-side plan is
:func:`sm90_plan`: compiled per block at the blocks of ``SM90_BLOCKS``,
and at every other block that a packer makes by ``csrc/gemm_any.cu``'s
kernels, which take the block at run time (:func:`sm90_unit`)).
Both
take every transport that the TPU kernels decode: emi8 and emi8m, the int8
container (pre-blocked or 2-D, which reaches the serving layout by a view),
sb4, sb2, pf4, pf6, the bf16/fp16 containers and the float8 containers (``float8_e4m3fn`` from
fp8_e4m3, and from fp6/fp4 packed ``native``; ``float8_e5m2`` from
fp8_e5m2). Where the JAX package sends sb4/sb2/pf4/pf6/bf16/fp16 at M > 64
to XLA's dequantize-then-dot, the port's GEMM decodes them too. JAX sends
2-D float8 codes to ``_dq_matmul_kernel``'s ``native2d`` branch at every M
and serving-layout float8 codes to XLA; the port routes both as every other
transport, the GEMV for M <= 64 and the GEMM above (the same function, f32
sums in another order). The W8A8 GEMV (``csrc/dequant_gemv_s8.cu``, and
``csrc/gemv_any.cu`` at the blocks no multiple of 16: :func:`s8_route`)
takes int8 activations against the int transports (int8 container, sb4,
sb2).

Tensors on the CPU go to the plain version. Tensors on a CUDA device go to a
kernel or raise: there is no silent fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from ...formats import get_format_params
from .. import packing as pk
from . import build

GEMV_MAX_M = 64
# the CUDA-core GEMVs (dequant_gemv.cu's gemv_partial, the "cc" route, and
# dequant_gemv_s8.cu): columns a block, blocks to aim for, K-blocks a split
GEMV_TILE_N = 512                 # kThreads * kCols in dequant_gemv.cu
_GEMV_TARGET_BLOCKS = 8 * 132     # ~8 blocks per SM of an H100
_GEMV_MIN_BLOCKS_PER_SPLIT = 4    # keeps the f32 partials << the codes
# the tensor-core GEMVs (csrc/gemv_tc.cuh, dequant_gemv.cu's gemv_tc and
# nb_matmul.cu's nb_gemv): one CTA an SM of an H100, tiles an SM to aim
# for, K rows of x a split at most, the ring's depth at most, the
# alignment slack and barrier block, and dequant_gemv.cu's tile (columns)
# and sub-tile row (bytes)
GEMV_SMS = 132
GEMV_TILES_PER_SM = 6
GEMV_SPLIT_ROWS = 1024
GEMV_MAX_STAGES = 8
_GEMV_FIXED_SMEM = 1024 + 1024
GEMV_TC_TN = 256
_GEMV_SUB_W = 128

# decode name -> mxq::Decode id of csrc/common.cuh; the names key the launch
# counts ("emi8" serves emi8 and emi8m, "native" the int8 container,
# "fp8_e4m3" every float8_e4m3fn container)
_DECODES = {"emi8": 0, "native": 1, "sb4": 2, "sb2": 3, "pf4": 4, "pf6": 5,
            "bf16": 6, "fp16": 7, "fp8_e4m3": 8, "fp8_e5m2": 9}
_S8_DECODES = ("native", "sb4", "sb2")
# the decodes of csrc/gemv_any.cu's kernels (pf4 and pf6 blocks are
# multiples of 16: gemv_tc's), and the K rows a packed row carries
_ANY_DECODES = tuple(d for d in _DECODES if d not in ("pf4", "pf6"))
_FIELDS = {"sb4": 2, "sb2": 4, "pf4": 2, "pf6": 4}
# decode -> the transport whose packed rows it reads
_TRANSPORT_OF = {d: d if d in ("sb4", "sb2", "pf4", "pf6") else "native"
                 for d in _DECODES}
# decode -> code container, for the decodes whose codes are not int8
_CODE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
                "fp8_e4m3": torch.float8_e4m3fn,
                "fp8_e5m2": torch.float8_e5m2}

# csrc/gemm_sm90.cuh: the output tile and K step (BM, BN, BK), the shared
# memory a block may use, one ring stage (x tile + bf16 B tile)
SM90_TILE = (256, 128, 64)
SM90_MAX_SMEM = 232448
_SM90_STAGE_BYTES = (SM90_TILE[0] + SM90_TILE[1]) * SM90_TILE[2] * 2
NB_BLOCK = 16                     # the compact NB transport's one block
# the GEMMs with a decoder on that mainloop -> the MX blocks it is compiled
# for one by one (those that divide the 64-deep K step and whose ring fits;
# pf6 at 16 is one that no packer makes; gemm_any.cu's kernels take the
# other blocks); "fp16" and "bf16" are the 16-bit
# containers, "emi8" emi8 and emi8m, "native" the int8 container, "fp8_e4m3" and "fp8_e5m2" the
# float8 containers, "sideband" the PackedMXOutlier GEMM and "nb" the
# compact PackedOutlierNB GEMM (block 16 only) of outlier_matmul.py
_BYTE_BLOCKS = (4, 8, 16, 32, 64)
SM90_BLOCKS = {"pf6": (16, 32, 64), "pf4": (16, 32, 64),
               "fp16": (8, 16, 32, 64), "bf16": (8, 16, 32, 64),
               "emi8": _BYTE_BLOCKS,
               "native": _BYTE_BLOCKS, "fp8_e4m3": _BYTE_BLOCKS,
               "fp8_e5m2": _BYTE_BLOCKS,
               "sb4": (2, 4, 8, 16, 32, 64), "sb2": (4, 8, 16, 32, 64),
               "sideband": (8, 16, 32, 64), "nb": (NB_BLOCK,)}
MAX_OUTLIER_BUDGET = 8            # kMaxBudget in outlier_matmul.cu
NB_SLOT_CLASSES = (1, 2, 4, 8, 16)   # the rings of nb_matmul.cu's NbSm90
# csrc/gemm_any.cu's decoders at the blocks taken at run time: (stages, raw
# buffers, raw bytes) of RowAny (one-byte and two-byte codes), PlanarAny
# (pf6, pf4, sb4, sb2) and SidebandAny, and the planar transports
_ANY_RINGS = {"row1": (4, 2, (64 + 64) * 128),
              "row2": (3, 3, (128 + 64) * 128),
              "planar": (3, 2, 327 * 128), "sideband": (3, 2, 327 * 128)}
_PLANAR = ("pf6", "pf4", "sb4", "sb2")
# the planar transports' blocks at run time: a multiple of (pf6 32, pf4 16,
# sb4 2, sb2 4), at least (sb4 6, sb2 8: a chunk of 8 K rows then crosses
# at most one block edge)
_PLANAR_MULTIPLE = {"pf6": 32, "pf4": 16, "sb4": 2, "sb2": 4}
_PLANAR_MIN = {"pf6": 32, "pf4": 16, "sb4": 6, "sb2": 8}

# launches per kernel and decode, for showing that a run went through the
# kernels; chip_smoke.py zeroes them before the main path and reads them
# after. dequant_gemv_<decode> counts the tensor-core GEMV (gemv_route's
# "tc" blocks), dequant_gemv_<decode>_any gemv_any.cu's kernel at the
# other blocks a packer makes and dequant_gemv_<decode>_cc the CUDA-core
# one (blocks no packer makes, tests that force it);
# dequant_gemv_s8_<decode>, dequant_gemv_s8_<decode>_any and
# dequant_gemv_s8_<decode>_cc the W8A8 GEMV's routes (s8_route),
# quantize_x_int8 its activation quantizer; dequant_matmul_<decode> counts the GEMM that gemm_route gives the
# default blocks (the sm90 kernel for pf6, pf4, sb4, sb2, fp16, bf16, emi8,
# the int8 container and float8), and
# dequant_matmul_<decode>_tile the gemm_tile kernel at the other blocks.
launch_counts = {**{f"dequant_gemv_{d}": 0 for d in _DECODES},
                 **{f"dequant_gemv_{d}_any": 0 for d in _ANY_DECODES},
                 **{f"dequant_gemv_{d}_cc": 0 for d in _DECODES},
                 **{f"dequant_matmul_{d}": 0 for d in _DECODES},
                 **{f"dequant_matmul_{d}_tile": 0 for d in SM90_BLOCKS
                    if d in _DECODES},
                 **{f"dequant_gemv_s8_{d}": 0 for d in _S8_DECODES},
                 **{f"dequant_gemv_s8_{d}_any": 0 for d in _S8_DECODES},
                 **{f"dequant_gemv_s8_{d}_cc": 0 for d in _S8_DECODES},
                 "quantize_x_int8": 0}

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_ptr, _int = ctypes.c_void_p, ctypes.c_int

def _ring_bytes(stages: int, raw: int, raw_bufs: int) -> int:
    """gemm_sm90.cuh's ring_bytes: alignment slack, the stages, the raw
    buffers (128-byte padded), the mbarriers."""
    return (1024 + stages * _SM90_STAGE_BYTES
            + raw_bufs * (-(-raw // 128) * 128) + (2 * stages + raw_bufs) * 8)


def _exp_rows(U: int, B: int) -> int:
    """gemm_any.cu's exp_rows: the exponent rows of a unit of U K rows
    (starting at a multiple of U) in blocks of B: U / B where B divides U,
    else at most ceil((U - 1) / B) + 1."""
    return U // B if U % B == 0 else (U + B - 2) // B + 1


@functools.lru_cache(maxsize=None)
def sm90_unit(kind: str, block: int, budget: int = 0):
    """The raw copy ("unit") of ``csrc/gemm_any.cu``'s kernel for ``kind``
    at ``block`` (and ``budget`` slots), mirroring ``dq_unit`` and
    ``sideband_unit``: ``unit_rows`` (U, the K rows a copy covers),
    ``code_rows`` (packed rows of the (NB * rows, N) codes; the side-band
    format's code rows are K rows), ``exp_rows`` (exponent rows from block
    k0 // block), ``unit_bytes`` (one copy's bytes) and ``stages`` (64-row
    stages a unit, S) or ``parts`` (units a stage, H). None where no unit
    fits.

    - one-byte and two-byte codes (emi8, the int8 and float8 containers,
      fp16, bf16): U = 64, every block;
    - pf6, pf4, sb4, sb2: U = lcm(block, 64), whole blocks, decoded in
      U / 64 stages, where that copy fits (at most 256 code rows, 327 rows
      with the exponents), else U = 64 and the whole blocks that hold the
      stage (copied from block k0 // block; a straddling block is copied
      for each stage it holds rows of);
    - the side-band format: the largest U of 64, 32, 16 and 8 whose copy
      (codes, se, seo, the slots' codes and int32 positions) fits 41,856
      bytes."""
    BN, BK = SM90_TILE[1:]
    if kind in _PLANAR:
        if block % _PLANAR_MULTIPLE[kind] or block < _PLANAR_MIN[kind]:
            return None
        lcm = block // math.gcd(block, BK) * BK
        for U in (lcm, BK):
            nb = lcm // block if U == lcm else _exp_rows(BK, block)
            cr = nb * pk.transport_rows_per_block(kind, block)
            raw = (cr + nb) * BN
            if cr <= 256 and nb <= 256 and raw <= _ANY_RINGS["planar"][2]:
                return {"unit_rows": U, "code_rows": cr, "exp_rows": nb,
                        "unit_bytes": raw, "stages": U // BK, "parts": 1}
        return None
    if kind == "sideband":
        for U in (64, 32, 16, 8):
            E = _exp_rows(U, block)
            raw = BN * (U + E * (2 + 5 * budget))
            if E <= 256 and raw <= _ANY_RINGS["sideband"][2]:
                return {"unit_rows": U, "code_rows": U, "exp_rows": E,
                        "unit_bytes": raw, "stages": 1, "parts": BK // U}
        return None
    if kind not in _DECODES:
        return None
    E = _exp_rows(BK, block)
    cb = 2 if kind in ("fp16", "bf16") else 1
    return {"unit_rows": BK, "code_rows": BK, "exp_rows": E,
            "unit_bytes": (cb * BK + E) * BN, "stages": 1, "parts": 1}


def _any_ring(kind: str):
    """(stages, raw buffers, raw bytes) of gemm_any.cu's decoder of
    ``kind``."""
    if kind in _PLANAR or kind == "sideband":
        return _ANY_RINGS["planar" if kind in _PLANAR else "sideband"]
    return _ANY_RINGS["row2" if kind in ("fp16", "bf16") else "row1"]


def _sm90_ring(kind: str, block: int, budget: int):
    """(slots, stages, raw buffers, raw bytes, any) of the sm90 kernel for
    ``kind`` at ``block`` (and ``budget`` slots): the kernel compiled for
    that block, mirroring its decoder (``Pf6Sm90``, ``Pf4Sm90``,
    ``Fp16Sm90``, ``Bf16Sm90``, ``Emi8Sm90``, ``Int8Sm90``, ``Fp8Sm90``,
    ``Sb4Sm90``, ``Sb2Sm90``, ``SidebandSm90``, ``NbSm90``; any False),
    else gemm_any.cu's (``RowAny``, ``PlanarAny``, ``SidebandAny``; any
    True, slots the budget); None where neither takes it. Raises
    ValueError for a budget that no kernel takes."""
    if kind == "sideband" and not 0 <= budget <= MAX_OUTLIER_BUDGET:
        raise ValueError(f"budget {budget} > {MAX_OUTLIER_BUDGET}")
    ring = _sm90_block_ring(kind, block, budget)
    if ring is not None:
        return ring + (False,)
    if sm90_unit(kind, block, budget) is None:
        return None
    return (budget if kind == "sideband" else 0,) + _any_ring(kind) + (True,)


def _sm90_block_ring(kind: str, block: int, budget: int):
    """(slots, stages, raw buffers, raw bytes) of the sm90 kernel compiled
    for ``kind`` at ``block``; None where none is or its ring would not
    fit."""
    if block not in SM90_BLOCKS.get(kind, ()):
        return None
    BN, BK = SM90_TILE[1:]
    nblk = BK // block
    if kind == "pf6":                     # 3B/4 packed rows a block
        return 0, 4, 3, (nblk * 3 * block // 4 + nblk) * BN
    if kind in ("pf4", "sb4"):            # B/2 packed rows a block
        return 0, 4, 3, (BK // 2 + nblk) * BN
    if kind == "sb2":                     # B/4 packed rows a block
        return 0, 4, 3, (BK // 4 + nblk) * BN
    if kind in ("fp16", "bf16"):          # 2-byte codes
        return 0, 3, 3, (2 * BK + nblk) * BN
    def four_stages(slots, raw):          # pf6's ring, where it fits
        fits = _ring_bytes(4, raw, 3) <= SM90_MAX_SMEM
        return (slots, 4, 3, raw) if fits else None

    if kind in ("emi8", "native", "fp8_e4m3", "fp8_e5m2"):   # a byte a row
        return four_stages(0, (BK + nblk) * BN)
    if kind == "nb":
        # the 8 N-blocks of a tile, 64 K columns: 32 code rows, se, seo,
        # then 8 rows a slot, the slots of the smallest class that holds
        # the budget
        slots = next((c for c in NB_SLOT_CLASSES if budget <= c), None)
        if slots is None:
            return None
        return four_stages(slots,
                           (BN // 4 + (2 + slots) * (BN // 16)) * BK)
    slots = 1 if budget <= 1 else 2 if budget <= 2 else \
        4 if budget <= 4 else 8
    # codes, se, seo, outlier codes, int32 positions
    raw = BK * BN + 2 * nblk * BN + 5 * nblk * BN * slots
    raw_bufs = 3 if slots <= 4 and _ring_bytes(3, raw, 3) <= SM90_MAX_SMEM \
        else 2
    if _ring_bytes(3, raw, raw_bufs) > SM90_MAX_SMEM:
        return None                       # block 8 with 8 slots
    return slots, 3, raw_bufs, raw


def sm90_plan(kind: str, K: int, N: int, block: int,
              budget: int = 0) -> dict:
    """Host-side plan of the wgmma + TMA GEMM (``csrc/gemm_sm90.cuh``) for a
    ``"pf6"``, ``"pf4"``, ``"sb4"``, ``"sb2"``, ``"fp16"``, ``"bf16"``
    (containers),
    ``"emi8"`` (emi8, emi8m), ``"native"`` (the int8 container),
    ``"fp8_e4m3"``, ``"fp8_e5m2"`` (float8 containers), ``"sideband"`` or
    ``"nb"`` weight of K rows and N columns (output columns) in blocks of
    ``block`` with ``budget`` outlier slots, mirroring the kernels' ``Ring`` and decoder sizes: the tile, the ring's
    stages and raw buffers, the outlier slots read, one step's raw weight
    bytes, the dynamic shared memory, whether the raw operands come by TMA
    (rows of a multiple of 16 bytes: N % 16 == 0, for the (N, K) NB weight
    K % 16 == 0; else plain copies), and x's row length ``k_x``: K
    rounded up to a multiple of 8 (TMA needs rows of a multiple of 16
    bytes), with ``pad_x`` where that adds zero columns. Nothing here
    depends on M. Raises ValueError for what no sm90 kernel takes (those
    blocks go to ``gemm_tile``: :func:`gemm_route`)."""
    if kind not in SM90_BLOCKS:
        raise ValueError(f"unknown sm90 GEMM {kind!r}")
    ring = _sm90_ring(kind, block, budget)
    if ring is None:
        raise ValueError(f"no sm90 {kind} GEMM takes block {block}"
                         + (f" with {budget} slots" if budget else ""))
    slots, stages, raw_bufs, raw, any_block = ring
    k_x = -(-K // 8) * 8
    return {"tile": SM90_TILE, "stages": stages, "raw_buffers": raw_bufs,
            "slots": slots, "raw_bytes": raw,
            "smem_bytes": _ring_bytes(stages, raw, raw_bufs),
            "tma": (K if kind == "nb" else N) % 16 == 0, "k_x": k_x,
            "pad_x": k_x != K, "any": any_block,
            "unit": sm90_unit(kind, block, budget) if any_block else None}


def sm90_copies(kind: str, K: int, block: int, budget: int = 0) -> list:
    """The raw copies of gemm_any.cu's kernel over a weight of K rows (x's
    row length k_x): for each, its K rows, code rows and exponent rows as
    (first, stop) and its bytes; every copy covers U K rows from a multiple
    of U, whole 64-row stages or a part of one. The host-side mirror of
    ``copy_tma``; K rows past the weight are zeros of the copy."""
    unit = sm90_unit(kind, block, budget)
    if unit is None:
        raise ValueError(f"no gemm_any.cu {kind} kernel takes block {block}")
    U, BK = unit["unit_rows"], SM90_TILE[2]
    k_x = -(-K // 8) * 8
    nk = -(-k_x // BK)
    n_units = -(-nk * unit["parts"] // unit["stages"])
    planar = kind in _PLANAR
    rows = pk.transport_rows_per_block(kind, block) if planar else 0
    out = []
    for u in range(n_units):
        k0 = u * U
        r0 = k0 // block * rows if planar else k0
        out.append({"k_rows": (k0, k0 + U),
                    "code_rows": (r0, r0 + unit["code_rows"]),
                    "exp_rows": (k0 // block, k0 // block + unit["exp_rows"]),
                    "bytes": unit["unit_bytes"]})
    return out


def gemm_route(kind: str, block: int, budget: int = 0) -> str:
    """The hand-written kernel that runs the GEMM (M > 64; the outlier
    formats from 256 rows) of a weight of transport or decode ``kind`` in
    blocks of ``block`` (``budget`` outlier slots for ``"sideband"`` and
    ``"nb"``): ``"sm90"``, the wgmma + TMA mainloop (:func:`sm90_plan`),
    for every decode of ``_DECODES`` at every block that its packer makes
    (compiled per block at ``SM90_BLOCKS``, else gemm_any.cu's kernel:
    :func:`sm90_unit`; every block up to 256 but pf6 at 224, and beyond
    256 where a unit fits), the side-band format at every block from 2 and
    every budget up to 8, and the compact NB format (block 16) with up to
    16 slots; else ``"tile"``, common.cuh's ``gemm_tile``, which takes
    every block and budget: NB above 16 slots, which no packer makes, and
    planar blocks whose unit would not fit (pf6 at 224: two blocks of 168
    packed rows). Chosen from the weight alone, before the launch. Raises
    ValueError for a side-band budget above 8."""
    return "sm90" if _sm90_ring(kind, block, budget) is not None else "tile"


def block_is_any(kind: str, block: int, budget: int = 0) -> bool:
    """Whether gemm_any.cu's kernel (the block at run time) runs the sm90
    GEMM of ``kind`` at ``block``: the route is "sm90" and no kernel is
    compiled for that block."""
    ring = _sm90_ring(kind, block, budget)
    return ring is not None and ring[-1]


def gemm_counter(decode: str, block: int) -> str:
    """The ``launch_counts`` key of the GEMM that ``dequant_gemm`` launches
    for ``decode`` at ``block``."""
    tile = decode in SM90_BLOCKS and gemm_route(decode, block) == "tile"
    return f"dequant_matmul_{decode}" + ("_tile" if tile else "")


def sm90_x(x2: torch.Tensor, k_x: int) -> torch.Tensor:
    """x (M, K) bf16 as the sm90 GEMM's TMA reads it: zero columns up to
    ``k_x`` (exact: they meet weight rows that the sum then adds as zeros)
    and a 16-byte aligned start."""
    if x2.shape[1] != k_x:
        x2 = torch.nn.functional.pad(x2, (0, k_x - x2.shape[1]))
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    return x2


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# C entry points: (source in csrc/, argument types), pointers (and the
# stream) as c_void_p, ints as c_int
_ENTRIES = {"dequant_gemv": ("dequant_gemv", [_ptr] * 5 + [_int] * 16
                             + [_ptr]),
            "dequant_gemv_occupancy": ("dequant_gemv", [_int] * 3 + [_ptr]),
            "dequant_gemv_cc": ("dequant_gemv", [_ptr] * 5 + [_int] * 11
                                + [_ptr]),
            "dequant_gemv_any": ("gemv_any", [_ptr] * 5 + [_int] * 15
                                 + [_ptr]),
            "dequant_gemv_s8_any": ("gemv_any", [_ptr] * 6 + [_int] * 13
                                    + [_ptr]),
            "dequant_matmul": ("dequant_matmul", [_ptr] * 4 + [_int] * 11
                               + [_ptr]),
            "dequant_gemv_s8": ("dequant_gemv_s8", [_ptr] * 6 + [_int] * 14
                                + [_ptr]),
            "dequant_gemv_s8_cc": ("dequant_gemv_s8", [_ptr] * 6
                                   + [_int] * 9 + [_ptr]),
            "quantize_x_int8": ("dequant_gemv_s8", [_ptr, _int, _ptr, _ptr,
                                                    _int, _int, _ptr]),
            "dequant_b_tile": ("dequant_matmul", [_ptr] * 3 + [_int] * 8
                               + [_ptr]),
            "dequant_matmul_any": ("gemm_any", [_ptr] * 4 + [_int] * 11
                                   + [_ptr]),
            "dequant_b_tile_any": ("gemm_any", [_ptr] * 3 + [_int] * 7
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


def scale_fold(fmt: str) -> int:
    """Extra exponent shift of the int formats' codes (code = value ·
    2^(mbits-2)), folded into the scale: 6 for int8, 2 for int4, 0 for int2
    (the TPU wrapper's ``_scale_fold``)."""
    if fmt in ("int8", "int4", "int2"):
        return get_format_params(fmt).mbits - 2
    return 0


def sad_decode_params(w: pk.PackedMX) -> Tuple[str, int, int, int]:
    """(decode, fold, mw, ebits) of the in-kernel decode, as the TPU
    wrapper's ``_sad_fold``: emi8 with the format's field split, emi8m with
    the tensor's own, sb4/sb2 and the int8 container with the int fold,
    pf4/pf6 with the format's stored mantissa bits and exponent bits, the
    bf16/fp16 and float8 containers as they are (fold 0, as the TPU
    wrapper's ``_scale_fold`` gives a float format)."""
    t = w.transport
    if t == "emi8":
        mw, _, _ = pk.emi8_params(w.elem_format)
        return "emi8", pk.emi8_fold(w.elem_format), mw, 0
    if t == "emi8m":
        return "emi8", w.transport_fold, w.transport_mw, 0
    if t in ("sb4", "sb2"):
        return t, scale_fold(w.elem_format), 0, 0
    if t in ("pf4", "pf6"):
        ebits, mbits, _, _, _ = get_format_params(w.elem_format)
        return t, pk.emi8_fold(w.elem_format), mbits - 2, ebits
    if t != "native":
        raise ValueError(f"unknown transport {t!r}")
    if w.codes.dtype == torch.int8:
        return "native", scale_fold(w.elem_format), 0, 0
    for name, dt in _CODE_DTYPES.items():
        if w.codes.dtype == dt:
            return name, 0, 0, 0
    raise ValueError(f"{w.codes.dtype} codes are no container of a packed "
                     f"MX weight ({w.elem_format})")


def gemv_ksplit(N: int, NB: int) -> Tuple[int, int]:
    """(ksplit, K-blocks per split) of the GEMV grid.

    Depends only on the weight's shape, never on M, so that a row's result
    is the same in a batch of any size.
    """
    col_tiles = -(-N // GEMV_TILE_N)
    want = max(1, -(-_GEMV_TARGET_BLOCKS // col_tiles))
    per = min(NB, max(_GEMV_MIN_BLOCKS_PER_SPLIT, -(-NB // want)))
    return -(-NB // per), per


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def gemv_n8_tiles(M: int) -> int:
    """n8 tiles of x rows that one tile of a tensor-core GEMV sums (its
    template NT; 8 rows each): 1, 2, 4 or 8."""
    return 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8


def gemv_split(stages_total: int, stage_rows: int, col_tiles: int,
               fits) -> Tuple[int, int]:
    """(ksplit, stages a split) of a tensor-core GEMV: enough splits for
    ~GEMV_TILES_PER_SM tiles an SM, at most GEMV_SPLIT_ROWS K rows of x a
    split, fewer where ``fits(stages a split)`` says that the ring would
    not keep two stages beside 64 rows of x. Depends on the weight's
    shape alone, never on M."""
    per = max(1, GEMV_SPLIT_ROWS // stage_rows)
    while per > 1 and not fits(per):
        per //= 2
    want = -(-GEMV_SMS * GEMV_TILES_PER_SM // col_tiles)
    ksplit = min(stages_total, max(-(-stages_total // per), want))
    sps = -(-stages_total // ksplit)
    return -(-stages_total // sps), sps


def _gemv_stages(fixed: int, stage_bytes: int) -> int:
    """Ring stages (at most GEMV_MAX_STAGES) that fit beside ``fixed``
    bytes in the shared memory a block may use."""
    return min(GEMV_MAX_STAGES, (SM90_MAX_SMEM - fixed) // stage_bytes)


def _gemv_stage(decode: str, B: int) -> Tuple[int, int, int, int]:
    """(packed rows a block, sb, sub_stride, stage_bytes) of ``gemv_tc``'s
    ring stage for ``decode`` at block B (its ``layout``): 2 * code bytes
    sub-tiles of sb * rows rows of 128 bytes, each 1024-aligned, then the
    sb exponent rows of 256 columns, 1024-aligned."""
    cb = 2 if decode in ("bf16", "fp16") else 1
    rows = pk.transport_rows_per_block(_TRANSPORT_OF[decode], B)
    sb = 1
    while 2 * sb * rows * cb <= _GEMV_SUB_W:
        sb *= 2
    sub_stride = _align(sb * rows * _GEMV_SUB_W, 1024)
    stage_bytes = 2 * cb * sub_stride + _align(sb * GEMV_TC_TN, 1024)
    return rows, sb, sub_stride, stage_bytes


def _gemv_x_bytes(nt: int, split_rows: int, xb: int = 2) -> int:
    """gemv_tc's, nb_gemv's and gemv_s8_tc's x in shared memory: 8 nt rows
    of the split's K rows of xb bytes (bf16: 2, int8: 1) plus 16 bytes,
    128-aligned."""
    return _align(8 * nt * (split_rows * xb + 16), 128)


@functools.lru_cache(maxsize=None)
def gemv_route(decode: str, block: int) -> str:
    """The hand-written GEMV kernel of a weight of ``decode`` (a key of
    ``_DECODES``) in blocks of ``block``: ``"tc"``, dequant_gemv.cu's
    ``gemv_tc`` (mma.sync on the tensor cores behind a TMA ring;
    :func:`gemv_plan`), for blocks that are a multiple of 16 whose stage
    holds at most 256 packed rows and whose ring keeps two stages beside
    64 rows of x (16-256 for the one-byte decodes, 16-128 for the bf16
    and fp16 containers); else ``"any"``, ``csrc/gemv_any.cu``'s kernel,
    which takes the block at run time (:func:`any_plan`), for the decodes
    of ``_ANY_DECODES`` at every block of whole packed rows (blocks 2, 4,
    8, 6, 12, 20, ... and the 16-bit containers at 208-256: every other
    block a packer makes); else ``"cc"``, ``gemv_partial`` on CUDA cores
    (blocks no packer makes: pf4 and pf6 off their multiples of 16 and
    32, sb4 and sb2 off 2 and 4). Chosen from the weight alone, before the
    launch."""
    if decode not in _DECODES:
        raise ValueError(f"unknown GEMV decode {decode!r}")
    return _tc_route(decode, block, 2)


def _tc_route(decode: str, block: int, xb: int) -> str:
    """"tc" where a tensor-core GEMV with x of xb bytes takes ``decode`` at
    ``block`` (a multiple of 16, at most 256 packed rows a stage, two
    stages beside 64 rows of x), else "any" where gemv_any.cu's kernel
    does (:func:`_any_takes`), else "cc"."""
    if block % 16 == 0:
        rows, sb, _, stage_bytes = _gemv_stage(decode, block)
        fits = _gemv_stages(
            _GEMV_FIXED_SMEM + _gemv_x_bytes(8, sb * block, xb),
            stage_bytes) >= 2
        if rows <= 256 and fits:
            return "tc"
    return "any" if _any_takes(decode, block, xb) else "cc"


def _route_suffix(route: str) -> str:
    return {"tc": "", "any": "_any", "cc": "_cc"}[route]


def gemv_counter(decode: str, block: int) -> str:
    """The ``launch_counts`` key of the GEMV that ``dequant_gemv`` launches
    for ``decode`` at ``block``."""
    return f"dequant_gemv_{decode}" + _route_suffix(gemv_route(decode, block))


def _any_stage(decode: str, B: int) -> Tuple[int, int, int, int]:
    """(positions S, packed rows, exponent rows E, stage_bytes) of a ring
    stage of gemv_any.cu for ``decode`` at block B (its ``layout``): 128 /
    code bytes packed rows, F positions each, in 2 * code bytes sub-tiles
    of 128 bytes a row, each 1024-aligned, then the exponent rows of the
    blocks S positions touch (S / B where B divides S, else at most
    ceil((S - 1) / B) + 1) of 256 columns, 1024-aligned."""
    cb = 2 if decode in ("bf16", "fp16") else 1
    rows = _GEMV_SUB_W // cb
    S = rows * _FIELDS.get(decode, 1)
    E = S // B if S % B == 0 else (S + B - 2) // B + 1
    stage_bytes = (2 * cb * _align(rows * _GEMV_SUB_W, 1024)
                   + _align(E * GEMV_TC_TN, 1024))
    return S, rows, E, stage_bytes


def _any_x_pitch(positions: int, xb: int) -> int:
    """gemv_any.cu's x row in shared memory: the split's positions rounded
    up to 16 (bf16) or 32 (int8), plus 16 bytes."""
    if xb == 2:
        return _align(positions, 16) * 2 + 16
    return _align(positions, 32) + 16


def _any_takes(decode: str, block: int, xb: int) -> bool:
    """Whether gemv_any.cu's kernel (x of xb bytes) takes ``decode`` at
    ``block``: a decode of ``_ANY_DECODES`` (of ``_S8_DECODES`` for int8
    x), whole packed rows a block, at most 256 exponent rows a stage and
    two stages beside 64 rows of x over one block."""
    if decode not in (_ANY_DECODES if xb == 2 else _S8_DECODES):
        return False
    if block < 1 or block % _FIELDS.get(decode, 1):
        return False
    _, _, E, stage_bytes = _any_stage(decode, block)
    x_bytes = _align(8 * 8 * _any_x_pitch(block, xb), 128)
    return E <= 256 and _gemv_stages(_GEMV_FIXED_SMEM + x_bytes,
                                     stage_bytes) >= 2


@functools.lru_cache(maxsize=None)
def any_plan(decode: str, N: int, K: int, B: int, M: int,
             xb: int = 2) -> dict:
    """Host-side plan of ``csrc/gemv_any.cu``'s kernels (``gemv_any``, x
    of xb = 2 bytes; ``gemv_s8_any``, xb = 1) for a (K, N) weight of
    ``decode`` in blocks of B and M rows of x, mirroring the kernel's
    ``layout`` and ``smem_bytes``:

    - ``stage_positions`` (S), ``stage_rows`` (S / F packed rows: 128 / code
      bytes), ``exp_rows`` (E) and ``stage_bytes`` (:func:`_any_stage`);
    - ``ksplit`` and ``split_blocks``: :func:`gemv_split` over blocks (a
      split is whole blocks, at most GEMV_SPLIT_ROWS K rows where a block
      is shorter); they and the stage never depend on M;
    - ``n8_tiles``, ``x_pitch`` (:func:`_any_x_pitch` of the split's
      positions), ``stages`` (2-8, as many as fit beside x), ``smem_bytes``;
    - ``col_tiles``, ``tiles``, ``ctas`` (one an SM, persistent) and
      ``tma`` (N % 16 == 0, else plain copies).

    Cached; the dict is shared, not to be changed. Raises ValueError where
    :func:`_any_takes` says no."""
    if not _any_takes(decode, B, xb):
        raise ValueError(f"no gemv_any.cu {decode} GEMV takes block {B}")
    S, rows, E, stage_bytes = _any_stage(decode, B)
    NB = -(-K // B)
    col_tiles = -(-N // GEMV_TC_TN)

    def x_bytes(nt, blocks):
        return _align(8 * nt * _any_x_pitch(blocks * B, xb), 128)

    ksplit, nbps = gemv_split(
        NB, B, col_tiles,
        lambda per: _gemv_stages(_GEMV_FIXED_SMEM + x_bytes(8, per),
                                 stage_bytes) >= 2)
    nt = gemv_n8_tiles(M)
    fixed = _GEMV_FIXED_SMEM + x_bytes(nt, nbps)
    stages = _gemv_stages(fixed, stage_bytes)
    tiles = col_tiles * ksplit
    return {"n8_tiles": nt, "stage_positions": S, "stage_rows": rows,
            "exp_rows": E, "stage_bytes": stage_bytes, "ksplit": ksplit,
            "split_blocks": nbps, "x_pitch": _any_x_pitch(nbps * B, xb),
            "stages": stages, "smem_bytes": fixed + stages * stage_bytes,
            "col_tiles": col_tiles, "tiles": tiles,
            "ctas": min(tiles, GEMV_SMS), "tma": N % 16 == 0}


@functools.lru_cache(maxsize=None)
def gemv_plan(decode: str, N: int, K: int, B: int, M: int) -> dict:
    """Host-side plan of ``gemv_tc`` (``csrc/dequant_gemv.cu``) for a (K, N)
    weight of ``decode`` in blocks of ``B`` and M rows of x, mirroring the
    kernel's ``layout`` and ``smem_bytes``:

    - ``stage_blocks`` (sb): K-blocks a ring stage holds, the largest
      power of two whose packed rows fill at most one 128-byte row a column
      pair (sb * rows * code bytes <= 128, at least one block);
    - ``sub_stride`` (one 128-byte-wide, 1024-aligned sub-tile of sb *
      rows rows; two a stage for one-byte codes, four for two-byte ones),
      ``se_off`` and ``stage_bytes`` (the sb exponent rows of 256 columns
      after them, 1024-aligned);
    - ``ksplit`` and ``split_blocks``: :func:`gemv_split`, whole stages;
      they and the stage never depend on M, so neither does the order of
      a row's sums;
    - ``n8_tiles`` (rows of x a tile: 8 each), ``x_pitch`` (bytes of an x
      row in shared memory: the split's K as bf16, plus 16), ``stages``
      (2-8, as many as fit beside x in 227 KB), ``smem_bytes``;
    - ``col_tiles``, ``tiles`` and ``ctas`` (one an SM, persistent);
      ``tma``: TMA copies (N % 16 == 0), else plain copies.

    Cached (a decode step asks for the same few plans at every layer):
    the dict is shared, not to be changed. Raises ValueError for a block
    that ``gemv_route`` does not send to ``"tc"``."""
    if gemv_route(decode, B) != "tc":
        raise ValueError(f"no tensor-core {decode} GEMV takes block {B}")
    return _tc_plan(decode, N, K, B, M, 2)


def _tc_plan(decode: str, N: int, K: int, B: int, M: int, xb: int) -> dict:
    """:func:`gemv_plan` for x of xb bytes an element."""
    _, sb, sub_stride, stage_bytes = _gemv_stage(decode, B)
    se_off = stage_bytes - _align(sb * GEMV_TC_TN, 1024)
    NB = -(-K // B)
    col_tiles = -(-N // GEMV_TC_TN)
    ksplit, sps = gemv_split(
        -(-NB // sb), sb * B, col_tiles,
        lambda per: _gemv_stages(_GEMV_FIXED_SMEM
                                 + _gemv_x_bytes(8, per * sb * B, xb),
                                 stage_bytes) >= 2)
    nt = gemv_n8_tiles(M)
    fixed = _GEMV_FIXED_SMEM + _gemv_x_bytes(nt, sps * sb * B, xb)
    stages = _gemv_stages(fixed, stage_bytes)
    tiles = col_tiles * ksplit
    return {"n8_tiles": nt, "stage_blocks": sb, "sub_stride": sub_stride,
            "se_off": se_off, "stage_bytes": stage_bytes, "ksplit": ksplit,
            "split_blocks": sps * sb, "x_pitch": sps * sb * B * xb + 16,
            "stages": stages, "smem_bytes": fixed + stages * stage_bytes,
            "col_tiles": col_tiles, "tiles": tiles,
            "ctas": min(tiles, GEMV_SMS), "tma": N % 16 == 0}


def _operands(x: torch.Tensor, w: pk.PackedMX, out_dtype):
    """Checked (x (M, K), serving-layout weight, decode, fold, mw, ebits);
    x is not yet cast."""
    decode, fold, mw, ebits = sad_decode_params(w)
    if w.axis != 0:
        raise ValueError("the kernels take (K, N) weights blocked on axis 0")
    ww = pk.to_serving_layout(w)          # a view for 2-D (K, N) codes
    if not (x.is_cuda and ww.codes.device == x.device
            and ww.scale_exp.device == x.device):
        raise ValueError("x and the packed weight must be on one CUDA device")
    want = _CODE_DTYPES.get(decode, torch.int8)
    if ww.codes.dtype != want or ww.scale_exp.dtype != torch.int8:
        raise ValueError(f"{decode} codes must be {want} and exponents int8, "
                         f"got {ww.codes.dtype}, {ww.scale_exp.dtype}")
    if not (ww.codes.is_contiguous() and ww.scale_exp.is_contiguous()):
        raise ValueError("packed weight must be contiguous")
    if ww.codes.data_ptr() % 16 or ww.scale_exp.data_ptr() % 16:
        raise ValueError("packed weight must be 16-byte aligned")
    NB, rows, N = ww.codes.shape
    B = ww.block_size
    if (ww.scale_exp.shape != (NB, N)
            or rows != pk.transport_rows_per_block(w.transport, B)):
        raise ValueError(f"scale_exp {tuple(ww.scale_exp.shape)} and codes "
                         f"{tuple(ww.codes.shape)} do not match a "
                         f"{w.transport} weight of block {B}")
    K = x.shape[-1]
    if K != w.orig_dim or K > NB * B:
        raise ValueError(f"x has K={K}, weight has K={w.orig_dim}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not in {_OUT_DTYPES}")
    return x.reshape(-1, K), ww, decode, fold, mw, ebits


def gemv_occupancy(decode: str, M: int, smem: int) -> int:
    """CTAs of ``gemv_tc`` that one SM holds at once (the card's occupancy
    query) for ``decode``, M rows and ``smem`` bytes of shared memory."""
    blocks = ctypes.c_int(0)
    err = _kernel("dequant_gemv_occupancy")(M, _DECODES[decode], smem,
                                            ctypes.addressof(blocks))
    build.check(err, "dequant_gemv_occupancy")
    return blocks.value


def dequant_gemv(x: torch.Tensor, w: pk.PackedMX,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Scale-after-dot GEMV (M <= 64) on the kernel that :func:`gemv_route`
    names (``gemv_tc`` on the plan of :func:`gemv_plan`, gemv_any.cu's on
    that of :func:`any_plan`, or the CUDA-core ``gemv_partial``); x is
    rounded to bf16 first, as the TPU kernel does."""
    if x.device.type == "cpu":
        return dequant_matmul_reference(x, w, out_dtype)
    x2, ww, decode, fold, mw, ebits = _operands(x, w, out_dtype)
    x2 = x2.to(torch.bfloat16).contiguous()
    M, K = x2.shape
    if not 0 < M <= GEMV_MAX_M:
        raise ValueError(f"GEMV takes 1..{GEMV_MAX_M} rows, got {M}")
    NB, _, N = ww.codes.shape
    B = ww.block_size
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    common = (ww.codes.data_ptr(), ww.scale_exp.data_ptr())
    counter = gemv_counter(decode, B)
    route = gemv_route(decode, B)
    if route == "tc":
        plan = gemv_plan(decode, N, K, B, M)
        if x2.data_ptr() % 16:
            x2 = x2.clone()
        ws = torch.empty((plan["ksplit"], M, N), dtype=torch.float32,
                         device=x.device)
        err = _kernel("dequant_gemv")(
            x2.data_ptr(), *common, ws.data_ptr(), out.data_ptr(), M, K, N,
            NB, B, _DECODES[decode], mw, ebits, fold, plan["ksplit"],
            plan["split_blocks"], plan["stage_blocks"], plan["stages"],
            plan["ctas"], plan["smem_bytes"],
            int(out_dtype == torch.bfloat16), stream)
    elif route == "any":
        plan = any_plan(decode, N, K, B, M)
        ws = torch.empty((plan["ksplit"], M, N), dtype=torch.float32,
                         device=x.device)
        err = _kernel("dequant_gemv_any")(
            x2.data_ptr(), *common, ws.data_ptr(), out.data_ptr(), M, K, N,
            NB, B, _DECODES[decode], mw, ebits, fold, plan["ksplit"],
            plan["split_blocks"], plan["stages"], plan["ctas"],
            plan["smem_bytes"], int(out_dtype == torch.bfloat16), stream)
    else:
        ksplit, _ = gemv_ksplit(N, NB)
        ws = torch.empty((ksplit, M, N), dtype=torch.float32,
                         device=x.device)
        err = _kernel("dequant_gemv_cc")(
            x2.data_ptr(), *common, ws.data_ptr(), out.data_ptr(), M, K, N,
            NB, B, _DECODES[decode], mw, ebits, fold, ksplit,
            int(out_dtype == torch.bfloat16), stream)
    build.check(err, counter)
    launch_counts[counter] += 1
    return out.reshape(x.shape[:-1] + (N,))


def dequant_gemm(x: torch.Tensor, w: pk.PackedMX,
                 out_dtype=torch.float32) -> torch.Tensor:
    """Tiled GEMM with the transport's decode inside the kernel (any M; the
    dispatch sends it M > 64): the kernel that :func:`gemm_route` names for
    the weight's decode and block."""
    if x.device.type == "cpu":
        return dequant_matmul_reference(x, w, out_dtype)
    x2, ww, decode, fold, mw, ebits = _operands(x, w, out_dtype)
    x2 = x2.to(torch.bfloat16).contiguous()
    M, K = x2.shape
    NB, _, N = ww.codes.shape
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out.reshape(x.shape[:-1] + (N,))
    sm90 = gemm_route(decode, ww.block_size) == "sm90"
    plan = sm90_plan(decode, K, N, ww.block_size) if sm90 else None
    if sm90:
        K = plan["k_x"]
        x2 = sm90_x(x2, K)
    counter = gemm_counter(decode, ww.block_size)
    args = (x2.data_ptr(), ww.codes.data_ptr(), ww.scale_exp.data_ptr(),
            out.data_ptr(), M, K, N, NB * ww.block_size, ww.block_size,
            _DECODES[decode], mw, ebits, fold,
            int(out_dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if sm90 and plan["any"]:
        err = _kernel("dequant_matmul_any")(
            *args, plan["unit"]["unit_rows"], stream)
    else:
        err = _kernel("dequant_matmul")(*args, int(sm90), stream)
    build.check(err, counter)
    launch_counts[counter] += 1
    return out.reshape(x.shape[:-1] + (N,))


def decoded_b_tile(w: pk.PackedMX, route: str) -> torch.Tensor:
    """The bf16 weight (K, N) that the decode of the GEMM on ``route``
    (``"sm90"`` or ``"tile"``) writes into its B tile, as int16 bit
    patterns: a test hook that holds two decoders to each other bit for
    bit, NaN and inf codes included, where a product with x cannot show
    them (x = I turns an inf weight into a NaN column). No model path calls
    it, and it counts no launch. Rows 0..K-1; on the CPU the twin's
    dequantized bf16 weight."""
    if w.codes.device.type == "cpu":
        return pk.dequantize_mx(w, dtype=torch.bfloat16).view(torch.int16)
    x = torch.empty((1, w.orig_dim), device=w.codes.device)
    _, ww, decode, fold, mw, ebits = _operands(x, w, torch.float32)
    if route == "sm90" and gemm_route(decode, ww.block_size) != "sm90":
        raise ValueError(f"no sm90 {decode} GEMM takes block "
                         f"{ww.block_size}")
    NB, _, N = ww.codes.shape
    bits = torch.empty((NB * ww.block_size, N), dtype=torch.int16,
                       device=x.device)
    args = (ww.codes.data_ptr(), ww.scale_exp.data_ptr(), bits.data_ptr(), N,
            NB * ww.block_size, ww.block_size, _DECODES[decode], mw, ebits,
            fold)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "sm90" and block_is_any(decode, ww.block_size):
        err = _kernel("dequant_b_tile_any")(*args, stream)
    else:
        err = _kernel("dequant_b_tile")(*args, int(route == "sm90"), stream)
    build.check(err, f"dequant_b_tile_{decode}")
    return bits[:w.orig_dim]


def dequant_matmul(x: torch.Tensor, w: pk.PackedMX,
                   out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(w): the GEMV for M <= 64 tokens, else the GEMM."""
    M = 1
    for d in x.shape[:-1]:
        M *= d
    if 0 < M <= GEMV_MAX_M:
        return dequant_gemv(x, w, out_dtype)
    return dequant_gemm(x, w, out_dtype)


# ---------------------------------------------------------------------------
# W8A8: per-token int8 activations against integer weight codes
# ---------------------------------------------------------------------------
def quantize_activations_int8(x: torch.Tensor):
    """Per-token symmetric int8 quantization: (codes, scale), x: (..., K)
    -> int8 codes of x's shape and an f32 scale (..., 1). Divides by
    amax / 127 and rounds half to even, bit for bit as the JAX function.
    The plain twin of :func:`quantize_x_int8`. The divisor 127 is a
    tensor on x's device: PyTorch on CUDA multiplies by the reciprocal of a
    CPU scalar divisor, which is not JAX's (exact) division."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / torch.full((), 127.0,
                                                      device=x.device)
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def quantize_x_int8(x: torch.Tensor):
    """:func:`quantize_activations_int8` of x (M, K) in one launch of
    ``csrc/dequant_gemv_s8.cu``'s ``quantize_rows`` on the card (x in f32
    or bf16; another dtype is cast to f32 first), bit for bit; on the CPU
    the twin itself."""
    if x.device.type == "cpu":
        return quantize_activations_int8(x)
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    M, K = x.shape
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return codes, scale
    err = _kernel("quantize_x_int8")(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        scale.data_ptr(), M, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quantize_x_int8")
    launch_counts["quantize_x_int8"] += 1
    return codes, scale


@functools.lru_cache(maxsize=None)
def s8_route(decode: str, block: int) -> str:
    """The W8A8 GEMV kernel of a weight of ``decode`` (the int8 container
    "native", "sb4" or "sb2") in blocks of ``block``: ``"tc"``,
    ``gemv_s8_tc`` (int8 mma.sync behind a TMA ring; :func:`s8_gemv_plan`),
    for blocks that are a multiple of 16 whose stage and ring fit; else
    ``"any"``, gemv_any.cu's ``gemv_s8_any`` (:func:`any_plan` with int8
    x) at every other block of whole packed rows (every block a packer
    makes); else ``"cc"``, ``s8_partial`` on CUDA cores, which only a test
    that forces it reaches. Chosen from the weight alone, before the
    launch."""
    if decode not in _S8_DECODES:
        raise ValueError(f"unknown W8A8 decode {decode!r}")
    return _tc_route(decode, block, 1)


def s8_counter(decode: str, block: int) -> str:
    """The ``launch_counts`` key of the W8A8 GEMV at ``decode``, ``block``."""
    return f"dequant_gemv_s8_{decode}" + _route_suffix(s8_route(decode,
                                                                block))


@functools.lru_cache(maxsize=None)
def s8_gemv_plan(decode: str, N: int, K: int, B: int, M: int) -> dict:
    """Host-side plan of ``gemv_s8_tc``: :func:`gemv_plan`'s stage, split
    and ring for int8 x (one byte a K row, so ``x_pitch`` is the split's K
    plus 16 and the ring may be deeper). Depends on M only through
    ``n8_tiles`` and what fits beside it, never the split. Raises
    ValueError for a block that :func:`s8_route` does not send to
    ``"tc"``."""
    if s8_route(decode, B) != "tc":
        raise ValueError(f"no tensor-core W8A8 {decode} GEMV takes block "
                         f"{B}")
    return _tc_plan(decode, N, K, B, M, 1)


def _s8_check(w: pk.PackedMX) -> Tuple[str, int]:
    """(decode, fold) of a weight the W8A8 path takes, else ValueError."""
    if w.axis != 0:
        raise ValueError("the W8A8 path takes (K, N) weights blocked on "
                         "axis 0")
    if w.elem_format not in ("int8", "int4", "int2"):
        raise ValueError("the W8A8 path needs integer weight codes, got "
                         f"{w.elem_format}")
    decode, fold, _, _ = sad_decode_params(w)
    if decode not in _S8_DECODES:
        raise ValueError(f"the W8A8 path takes the int8 container, sb4 and "
                         f"sb2, got {w.transport} with {w.codes.dtype} codes")
    return decode, fold


def dequant_matmul_sad_s8_reference(x: torch.Tensor, w: pk.PackedMX,
                                    out_dtype=torch.float32) -> torch.Tensor:
    """Plain twin of the W8A8 kernel: the same per-token int8 activation
    grid, float32 math."""
    x2 = x.reshape(-1, x.shape[-1])
    xq, xscale = quantize_activations_int8(x2)
    dense = pk.dequantize_mx(w, dtype=torch.float32)
    y = torch.matmul(xq.to(torch.float32), dense) * xscale
    return y.to(out_dtype).reshape(x.shape[:-1] + (dense.shape[1],))


def dequant_matmul_sad_s8(x: torch.Tensor, w: pk.PackedMX,
                          out_dtype=torch.float32) -> torch.Tensor:
    """y ≈ x @ dequant(w) with int8 activations (the W8A8 decode path):
    integer-exact given the quantized operands, whose only approximation is
    the per-token int8 activation grid. Int-format weights in the int8
    container, sb4 or sb2. On a CUDA device the activations are quantized
    by one launch (:func:`quantize_x_int8`), then the GEMV of
    :func:`s8_route` runs, 64 rows at a time on its "tc" and "any"
    routes."""
    decode, fold = _s8_check(w)
    if x.device.type == "cpu":
        return dequant_matmul_sad_s8_reference(x, w, out_dtype)
    x2, ww, _, _, _, _ = _operands(x, w, out_dtype)
    M, K = x2.shape
    NB, _, N = ww.codes.shape
    B = ww.block_size
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out.reshape(x.shape[:-1] + (N,))
    xq, xscale = quantize_x_int8(x2)
    xscale = xscale.reshape(M)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    common = (ww.codes.data_ptr(), ww.scale_exp.data_ptr())
    counter = s8_counter(decode, B)
    out_bf16 = int(out_dtype == torch.bfloat16)
    route = s8_route(decode, B)
    if route in ("tc", "any"):
        for m0 in range(0, M, GEMV_MAX_M):
            mt = min(GEMV_MAX_M, M - m0)
            rows = (xq[m0:].data_ptr(), xscale[m0:].data_ptr(), *common)
            if route == "tc":
                plan = s8_gemv_plan(decode, N, K, B, mt)
                ws = torch.empty((plan["ksplit"], mt, N),
                                 dtype=torch.float32, device=x.device)
                err = _kernel("dequant_gemv_s8")(
                    *rows, ws.data_ptr(), out[m0:].data_ptr(), mt, K, N, NB,
                    B, _DECODES[decode], fold, plan["ksplit"],
                    plan["split_blocks"], plan["stage_blocks"],
                    plan["stages"], plan["ctas"], plan["smem_bytes"],
                    out_bf16, stream)
            else:
                plan = any_plan(decode, N, K, B, mt, 1)
                ws = torch.empty((plan["ksplit"], mt, N),
                                 dtype=torch.float32, device=x.device)
                err = _kernel("dequant_gemv_s8_any")(
                    *rows, ws.data_ptr(), out[m0:].data_ptr(), mt, K, N, NB,
                    B, _DECODES[decode], fold, plan["ksplit"],
                    plan["split_blocks"], plan["stages"], plan["ctas"],
                    plan["smem_bytes"], out_bf16, stream)
            build.check(err, counter)
            launch_counts[counter] += 1
    else:
        if ww.codes.shape[1] % 4:
            raise ValueError("s8_partial reads 4 packed rows at a time; "
                             f"block {B} gives {ww.codes.shape[1]}")
        ksplit, _ = gemv_ksplit(N, NB)
        ws = torch.empty((ksplit, M, N), dtype=torch.float32,
                         device=x.device)
        err = _kernel("dequant_gemv_s8_cc")(
            xq.data_ptr(), xscale.data_ptr(), *common, ws.data_ptr(),
            out.data_ptr(), M, K, N, NB, B, _DECODES[decode], fold, ksplit,
            out_bf16, stream)
        build.check(err, counter)
        launch_counts[counter] += 1
    return out.reshape(x.shape[:-1] + (N,))
