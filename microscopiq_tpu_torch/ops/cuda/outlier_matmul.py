"""y = x @ dequant(w) for the MicroScopiQ outlier weight formats: the CUDA
kernels, their wrappers and their plain PyTorch twins.

Counterpart of the outlier parts of
``microscopiq_tpu/ops/pallas/dequant_matmul.py``:

* :func:`dequant_matmul_nb` (``csrc/nb_matmul.cu``, replaces ``_nb_kernel``):
  the compact N-blocked int2 + fp4 transport, :class:`PackedOutlierNB`,
  stored (N, K); its GEMM runs on the wgmma + TMA mainloop of
  ``csrc/gemm_sm90.cuh`` at the budgets that ``dequant_matmul.gemm_route``
  gives it (every budget up to 16, all that the packer makes), else on
  ``gemm_tile``;
* :func:`dequant_matmul_outlier` (``csrc/outlier_matmul.cu``, replaces
  ``_dq_matmul_outlier_kernel``): the side-band :class:`PackedMXOutlier`,
  stored (K, N); its GEMM runs on the wgmma + TMA mainloop of
  ``csrc/gemm_sm90.cuh`` (plan: ``dequant_matmul.sm90_plan``) at every
  block and budget up to 8: compiled per block (8, 16, 32, 64) where its
  ring fits, else ``csrc/gemm_any.cu``'s kernel, which takes the block at
  run time.

Each format has two kernels: a K-split GEMV for fewer than ``GEMM_FROM_M``
rows (the side-band one a persistent TMA stream, planned by
:func:`outlier_gemv_plan`) and a tensor-core GEMM that decodes the weight
tile in shared memory from ``GEMM_FROM_M`` rows on, the token count at which the JAX ``QLinear``
leaves these formats to XLA. Tensors on the CPU go to the twin. Tensors on a
CUDA device go to a kernel or raise; a weight on another device than x
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import packing as pk
from ..packing import PackedMXOutlier, PackedOutlierNB
from . import build
from . import operands as op
from .dequant_matmul import (MAX_OUTLIER_BUDGET, NB_BLOCK, SM90_MAX_SMEM,
                             gemm_route, gemv_n8_tiles, gemv_split,
                             sm90_plan, sm90_x)
from .dequant_matmul import _GEMV_FIXED_SMEM as _TC_FIXED_SMEM
from .dequant_matmul import _align, _gemv_stages, _gemv_x_bytes
from .dequant_matmul import scale_fold as _scale_fold

GEMM_FROM_M = 256                 # rows from which the GEMMs take over
# the NB GEMV (nb_matmul.cu, namespace gv): K columns a stage, N-blocks a
# tile (one a consumer warp), the bytes of a stage before its slots and of
# one slot, a warp's bf16 decode tile
NB_GEMV_K = 128
NB_GEMV_BLOCKS = 8
_NB_GEMV_SLOT0 = 6144
_NB_GEMV_SLOT = 1024
_NB_GEMV_TILE = 16 * 128
# the side-band GEMV (outlier_matmul.cu, namespace gemv): columns a tile,
# row groups, the shared-memory slack and barrier bytes, K rows a stage at
# least, K rows of x a split at most, the SMs of an H100 (one CTA each),
# tiles an SM to aim for, and the ring's depth at most
GEMV_TN = 128
_GEMV_ROW_GROUPS = 32
_GEMV_FIXED_SMEM = 128 + 256
_GEMV_STAGE_ROWS = 128
_GEMV_SPLIT_ROWS = 1024
GEMV_SMS = 132
_GEMV_TILES_PER_SM = 4
_GEMV_MAX_STAGES = 8

# launches per kernel wrapper, for showing that a run went through the
# kernels; chip_smoke.py zeroes them before the main path and reads them
# after. dequant_gemm_outlier and dequant_gemm_nb count the sm90 GEMMs,
# their _tile keys the gemm_tile ones (gemm_route's "tile" routes).
launch_counts = {"dequant_gemv_nb": 0, "dequant_gemm_nb": 0,
                 "dequant_gemm_nb_tile": 0, "dequant_gemv_outlier": 0,
                 "dequant_gemm_outlier": 0, "dequant_gemm_outlier_tile": 0}

_OUT_DTYPES = op.OUT_DTYPES
_ptr, _int = ctypes.c_void_p, ctypes.c_int
# C entry points: (source in csrc/, argument types)
_ENTRIES = {
    "dequant_gemv_nb": ("nb_matmul", [_ptr] * 7 + [_int] * 12 + [_ptr]),
    "nb_gemv_occupancy": ("nb_matmul", [_int] * 2 + [_ptr]),
    "dequant_gemm_nb": ("nb_matmul", [_ptr] * 6 + [_int] * 9 + [_ptr]),
    "dequant_gemv_outlier": ("outlier_matmul",
                             [_ptr] * 8 + [_int] * 17 + [_ptr]),
    "outlier_gemv_occupancy": ("outlier_matmul", [_int] * 3 + [_ptr]),
    "dequant_gemm_outlier": ("outlier_matmul",
                             [_ptr] * 7 + [_int] * 11 + [_ptr]),
    "dequant_gemm_outlier_any": ("gemm_any",
                                 [_ptr] * 7 + [_int] * 11 + [_ptr])}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _kernel(name: str):
    return build.entry(_ENTRIES[name][0], name, _ENTRIES[name][1])


def _rows(x: torch.Tensor) -> int:
    M = 1
    for d in x.shape[:-1]:
        M *= d
    return M


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------
def dequant_matmul_nb_reference(x: torch.Tensor, w: PackedOutlierNB,
                                out_dtype=torch.float32) -> torch.Tensor:
    """Plain twin of the NB kernel: dequantize the (N, K) weight to bf16,
    then a dot of the bf16 values with f32 sums (exact products; on CUDA
    this assumes TF32 matmul is off, the default)."""
    dense = pk.dequantize_outlier_nb(w, dtype=torch.bfloat16)     # (N, K)
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                     dense.to(torch.float32).T)
    return y.to(out_dtype)


def dequant_matmul_outlier_reference(x: torch.Tensor, w: PackedMXOutlier,
                                     out_dtype=torch.float32) -> torch.Tensor:
    """Plain twin of the side-band kernel: dequantize the (K, N) weight to
    bf16, then a bf16 dot with f32 sums."""
    dense = pk.dequantize_mx_outlier(w, dtype=torch.bfloat16)     # (K, N)
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                     dense.to(torch.float32))
    return y.to(out_dtype)


# ---------------------------------------------------------------------------
# NB kernels
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def nb_gemv_plan(Np: int, K: int, budget: int, M: int) -> dict:
    """Host-side plan of the NB GEMV (``nb_matmul.cu``'s ``gv::nb_gemv``)
    for a compact (Np, K) weight (Np = 16 NB rows) with ``budget`` slots
    and M rows of x, mirroring the kernel's ``stage_bytes`` and
    ``smem_bytes``:

    - a stage is 128 K columns of the 8 N-blocks of a tile: 32 code rows,
      8 se and 8 seo rows, 8 rows a slot (``stage_bytes``, 1024-aligned);
    - ``ksplit`` and ``split_stages`` (sps): ``gemv_split``, never
      depending on M;
    - ``n8_tiles`` (8 rows of x each; at most 64 rows a tile) and
      ``m_groups``; ``x_pitch``; ``stages`` (2-8, as many as fit beside
      x and the 8 warps' 4 KB bf16 decode tiles); ``smem_bytes``;
    - ``n_tiles``, ``tiles`` and ``ctas`` (one an SM, persistent);
      ``tma``: TMA copies (K % 16 == 0), else plain copies.

    Cached, as ``dequant_matmul.gemv_plan``: the dict is shared, not to be
    changed. Raises ValueError where no ring of two stages fits (a budget
    far above what the packer makes)."""
    NB = Np // 16
    n_tiles = -(-NB // NB_GEMV_BLOCKS)
    stage_bytes = _align(_NB_GEMV_SLOT0 + budget * _NB_GEMV_SLOT, 1024)
    fixed0 = _TC_FIXED_SMEM + NB_GEMV_BLOCKS * _NB_GEMV_TILE

    ksplit, sps = gemv_split(
        -(-K // NB_GEMV_K), NB_GEMV_K, n_tiles,
        lambda per: _gemv_stages(fixed0 + _gemv_x_bytes(8, per * NB_GEMV_K),
                                 stage_bytes) >= 2)
    nt = gemv_n8_tiles(M)
    fixed = fixed0 + _gemv_x_bytes(nt, sps * NB_GEMV_K)
    stages = _gemv_stages(fixed, stage_bytes)
    if stages < 2:
        raise ValueError(f"no NB GEMV ring fits {budget} slots")
    m_groups = -(-M // (8 * nt))
    tiles = m_groups * n_tiles * ksplit
    return {"n8_tiles": nt, "stage_bytes": stage_bytes, "ksplit": ksplit,
            "split_stages": sps, "x_pitch": sps * NB_GEMV_K * 2 + 16,
            "stages": stages, "smem_bytes": fixed + stages * stage_bytes,
            "m_groups": m_groups, "n_tiles": n_tiles, "tiles": tiles,
            "ctas": min(tiles, GEMV_SMS), "tma": K % 16 == 0}


def nb_gemv_occupancy(M: int, smem: int) -> int:
    """CTAs of the NB GEMV that one SM holds at once (the card's occupancy
    query) for M rows and ``smem`` bytes of shared memory."""
    blocks = ctypes.c_int(0)
    err = _kernel("nb_gemv_occupancy")(M, smem, ctypes.addressof(blocks))
    build.check(err, "nb_gemv_occupancy")
    return blocks.value


def dequant_gemv_nb(x: torch.Tensor, w: PackedOutlierNB,
                    out_dtype=torch.float32) -> torch.Tensor:
    """The NB GEMV kernel (any M; the dispatch sends it M < GEMM_FROM_M), on
    the plan of :func:`nb_gemv_plan`. x is rounded to bf16 first, as the
    TPU kernel does."""
    if op.on_cpu(x, op.nb_tensors(w)):
        return dequant_matmul_nb_reference(x, w, out_dtype)
    x2 = op.nb_operands(x, w, out_dtype)
    M, K = x2.shape
    N, Np = w.orig_n, 4 * w.codes.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out.reshape(x.shape[:-1] + (N,))
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    plan = nb_gemv_plan(Np, K, w.budget, M)
    ws = torch.empty((plan["ksplit"], M, Np), dtype=torch.float32,
                     device=x.device)
    err = _kernel("dequant_gemv_nb")(
        x2.data_ptr(), w.codes.data_ptr(), w.scale_exp.data_ptr(),
        w.out_scale_exp.data_ptr(), w.out_byte.data_ptr(), ws.data_ptr(),
        out.data_ptr(), M, K, Np, N, w.budget, _scale_fold(w.elem_format),
        plan["ksplit"], plan["split_stages"], plan["stages"], plan["ctas"],
        plan["smem_bytes"], int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dequant_gemv_nb")
    launch_counts["dequant_gemv_nb"] += 1
    return out.reshape(x.shape[:-1] + (N,))


def nb_gemm_counter(budget: int) -> str:
    """The ``launch_counts`` key of the GEMM that ``dequant_gemm_nb``
    launches for a compact NB weight of ``budget`` slots."""
    tile = gemm_route("nb", NB_BLOCK, budget) == "tile"
    return "dequant_gemm_nb" + ("_tile" if tile else "")


def dequant_gemm_nb(x: torch.Tensor, w: PackedOutlierNB,
                    out_dtype=torch.float32) -> torch.Tensor:
    """The NB tensor-core GEMM (any M; the dispatch sends it
    M >= GEMM_FROM_M): the kernel that ``gemm_route("nb", 16, budget)``
    names. x is rounded to bf16 first."""
    if op.on_cpu(x, op.nb_tensors(w)):
        return dequant_matmul_nb_reference(x, w, out_dtype)
    x2 = op.nb_operands(x, w, out_dtype)
    M, K = x2.shape
    N, Np = w.orig_n, 4 * w.codes.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out.reshape(x.shape[:-1] + (N,))
    sm90 = gemm_route("nb", NB_BLOCK, w.budget) == "sm90"
    k_x = K
    if sm90:
        k_x = sm90_plan("nb", K, N, NB_BLOCK, w.budget)["k_x"]
        x2 = sm90_x(x2, k_x)
    counter = nb_gemm_counter(w.budget)
    err = _kernel("dequant_gemm_nb")(
        x2.data_ptr(), w.codes.data_ptr(), w.scale_exp.data_ptr(),
        w.out_scale_exp.data_ptr(), w.out_byte.data_ptr(), out.data_ptr(),
        M, K, k_x, Np, N, w.budget, _scale_fold(w.elem_format),
        int(out_dtype == torch.bfloat16), int(sm90),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, counter)
    launch_counts[counter] += 1
    return out.reshape(x.shape[:-1] + (N,))


def dequant_matmul_nb(x: torch.Tensor, w: PackedOutlierNB,
                      out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ W^T for the compact transport (W stored (N, K)): the GEMV
    below GEMM_FROM_M rows, else the GEMM; the twin on the CPU."""
    if _rows(x) < GEMM_FROM_M:
        return dequant_gemv_nb(x, w, out_dtype)
    return dequant_gemm_nb(x, w, out_dtype)


# ---------------------------------------------------------------------------
# Side-band kernels
# ---------------------------------------------------------------------------
def _container_flag(t: torch.Tensor, what: str) -> int:
    """1 for float8_e4m3fn codes, 0 for int8; other containers raise."""
    if t.dtype == torch.int8:
        return 0
    if t.dtype == torch.float8_e4m3fn:
        return 1
    raise ValueError(f"{what} in {t.dtype}: the kernel takes int8 or "
                     "float8_e4m3fn containers")


def _outlier_operands(x: torch.Tensor, w: PackedMXOutlier, out_dtype):
    inl = w.inlier
    if not x.is_cuda:
        raise ValueError("the side-band kernel takes CUDA tensors")
    if inl.axis != 0 or inl.codes.ndim != 2:
        raise ValueError("the kernel takes 2-D (K, N) weights blocked on "
                         "axis 0")
    tensors = (inl.codes, inl.scale_exp, w.out_codes, w.out_pos,
               w.out_scale_exp)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("packed weight must be contiguous")
    if inl.scale_exp.dtype != torch.int8 or w.out_scale_exp.dtype != \
            torch.int8 or w.out_pos.dtype != torch.int32:
        raise ValueError("exponents must be int8 and positions int32")
    Kp, N = inl.codes.shape
    B = inl.block_size
    NB = Kp // B
    budget = w.budget
    if (NB * B != Kp or inl.scale_exp.shape != (NB, N)
            or w.out_scale_exp.shape != (NB, N)
            or w.out_codes.shape != (NB, N, budget)
            or w.out_pos.shape != (NB, N, budget)):
        raise ValueError(f"side-band operands disagree: codes "
                         f"{tuple(inl.codes.shape)}, out_codes "
                         f"{tuple(w.out_codes.shape)}, out_pos "
                         f"{tuple(w.out_pos.shape)}")
    if not 0 <= budget <= MAX_OUTLIER_BUDGET:
        raise ValueError(f"budget {budget} > {MAX_OUTLIER_BUDGET}")
    K = x.shape[-1]
    if K != inl.orig_dim or K > Kp:
        raise ValueError(f"x has K={K}, weight has K={inl.orig_dim}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not in {_OUT_DTYPES}")
    flags = (_container_flag(inl.codes, "codes"),
             _container_flag(w.out_codes, "out_codes"))
    return x.reshape(-1, K).to(torch.bfloat16).contiguous(), flags


def _sideband_tensors(w: PackedMXOutlier):
    inl = w.inlier
    return (inl.codes, inl.scale_exp, w.out_codes, w.out_pos,
            w.out_scale_exp)


def _view8(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int8) if t.dtype != torch.int8 else t


def gemv_rows_per_tile(M: int) -> int:
    """Rows of x that one tile of the side-band GEMV sums (its template
    MT): 8, 4, 2 or 1."""
    return 8 if M >= 8 else 4 if M >= 4 else 2 if M >= 2 else 1


def outlier_gemv_plan(N: int, K: int, B: int, budget: int, M: int) -> dict:
    """Host-side plan of the side-band GEMV (``outlier_matmul.cu``'s
    ``gemv::sideband_gemv``) for a (K, N) weight in blocks of ``B`` with
    ``budget`` slots and M rows of x, mirroring the kernel's layout:

    - ``stage_blocks`` (sb): K-blocks a ring stage holds, the least power
      of two giving 128 K rows (at most 32, fewer where two stages would
      not fit), and ``rows_per_group``: rows of a block that each of the
      32 / sb row groups of a stage sums;
    - ``ksplit`` and ``split_blocks``: the K split, whole stages, enough
      splits for ~4 tiles an SM (132 SMs) and at most 1024 K rows of x a
      split; they, the stage size and the row groups never depend on M
      (the stage size is chosen as if x had 8 rows), so neither does the
      order of a row's sums;
    - ``stage_bytes`` (codes, se, seo, outlier codes, int32 positions of
      sb blocks, 128 columns), ``stages`` (2-8, as many as fit beside x and
      the reduction in 227 KB), ``smem_bytes`` (what the kernel checks);
    - ``rows_per_tile`` (MT), ``m_groups``, ``col_tiles``, ``tiles`` and
      ``ctas`` (one an SM, persistent); ``tma``: TMA and bulk copies (N a
      multiple of 16, a stage's rows within a 256-row box), else plain
      copies.

    Raises ValueError for a budget above 8."""
    if not 0 <= budget <= MAX_OUTLIER_BUDGET:
        raise ValueError(f"budget {budget} > {MAX_OUTLIER_BUDGET}")
    mt = gemv_rows_per_tile(M)
    NB = -(-K // B)
    col_tiles = -(-N // GEMV_TN)
    sb = 1
    while sb * B < _GEMV_STAGE_ROWS and sb < _GEMV_ROW_GROUPS:
        sb *= 2
    while True:
        stages_total = -(-NB // sb)
        per_split = max(1, _GEMV_SPLIT_ROWS // (sb * B))
        want = -(-GEMV_SMS * _GEMV_TILES_PER_SM // col_tiles)
        ksplit = min(stages_total, max(-(-stages_total // per_split), want))
        sps = -(-stages_total // ksplit)
        ksplit = -(-stages_total // sps)
        nbps = sps * sb
        stage_bytes = GEMV_TN * (sb * B + 2 * sb + 5 * sb * budget)

        def stages_at(rows):              # the ring beside x and the sums
            x_pad = -(-rows * nbps * B * 4 // 128) * 128
            fixed = _GEMV_FIXED_SMEM + x_pad + 10 * rows * GEMV_TN * 4
            return fixed, min(_GEMV_MAX_STAGES,
                              (SM90_MAX_SMEM - fixed) // stage_bytes)

        # the stage size is chosen at 8 rows of x, so that it (and with it
        # the order of a row's sums) does not depend on M
        if stages_at(8)[1] >= 2 or sb == 1:
            break
        sb //= 2
    fixed, stages = stages_at(mt)
    if stages < 2:
        raise ValueError(f"no side-band GEMV ring fits block {B} with "
                         f"{budget} slots")
    groups = _GEMV_ROW_GROUPS // sb
    m_groups = -(-M // mt)
    tiles = m_groups * col_tiles * ksplit
    return {"rows_per_tile": mt, "stage_blocks": sb,
            "rows_per_group": -(-B // groups), "ksplit": ksplit,
            "split_blocks": nbps, "stage_bytes": stage_bytes,
            "stages": stages, "smem_bytes": fixed + stages * stage_bytes,
            "m_groups": m_groups, "col_tiles": col_tiles, "tiles": tiles,
            "ctas": min(tiles, GEMV_SMS),
            "tma": N % 16 == 0 and sb * B <= 256}


def outlier_gemv_occupancy(M: int, codes_fp8: bool, smem: int) -> int:
    """CTAs of the side-band GEMV that one SM holds at once (the card's
    occupancy query) for M rows and ``smem`` bytes of shared memory; each
    has 12 warps (8 consumers, a copying warpgroup)."""
    blocks = ctypes.c_int(0)
    err = _kernel("outlier_gemv_occupancy")(M, int(codes_fp8), smem,
                                            ctypes.addressof(blocks))
    build.check(err, "outlier_gemv_occupancy")
    return blocks.value


def dequant_gemv_outlier(x: torch.Tensor, w: PackedMXOutlier,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The side-band GEMV kernel (any M; the dispatch sends it
    M < GEMM_FROM_M), on the plan of :func:`outlier_gemv_plan`. x is
    rounded to bf16 first, as the TPU kernel does."""
    if op.on_cpu(x, _sideband_tensors(w)):
        return dequant_matmul_outlier_reference(x, w, out_dtype)
    inl = w.inlier
    x2, (codes_fp8, oc_fp8) = _outlier_operands(x, w, out_dtype)
    M, K = x2.shape
    Kp, N = inl.codes.shape
    B = inl.block_size
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out.reshape(x.shape[:-1] + (N,))
    plan = outlier_gemv_plan(N, Kp, B, w.budget, M)
    ws = torch.empty((plan["ksplit"], M, N), dtype=torch.float32,
                     device=x.device)
    err = _kernel("dequant_gemv_outlier")(
        x2.data_ptr(), _view8(inl.codes).data_ptr(),
        inl.scale_exp.data_ptr(), w.out_scale_exp.data_ptr(),
        _view8(w.out_codes).data_ptr(), w.out_pos.data_ptr(), ws.data_ptr(),
        out.data_ptr(), M, K, N, Kp // B, B, w.budget,
        _scale_fold(inl.elem_format), codes_fp8, oc_fp8, plan["ksplit"],
        plan["split_blocks"], plan["stage_blocks"], plan["rows_per_group"],
        plan["stages"], plan["ctas"], plan["smem_bytes"],
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dequant_gemv_outlier")
    launch_counts["dequant_gemv_outlier"] += 1
    return out.reshape(x.shape[:-1] + (N,))


def gemm_counter(block: int, budget: int) -> str:
    """The ``launch_counts`` key of the GEMM that ``dequant_gemm_outlier``
    launches for a side-band weight of ``block`` and ``budget`` slots."""
    tile = gemm_route("sideband", block, budget) == "tile"
    return "dequant_gemm_outlier" + ("_tile" if tile else "")


def dequant_gemm_outlier(x: torch.Tensor, w: PackedMXOutlier,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The side-band tensor-core GEMM (any M; the dispatch sends it
    M >= GEMM_FROM_M): the kernel that ``gemm_route("sideband", block,
    budget)`` names. x is rounded to bf16 first."""
    if op.on_cpu(x, _sideband_tensors(w)):
        return dequant_matmul_outlier_reference(x, w, out_dtype)
    inl = w.inlier
    x2, (codes_fp8, oc_fp8) = _outlier_operands(x, w, out_dtype)
    M, K = x2.shape
    Kp, N = inl.codes.shape
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out.reshape(x.shape[:-1] + (N,))
    sm90 = gemm_route("sideband", inl.block_size, w.budget) == "sm90"
    plan = sm90_plan("sideband", K, N, inl.block_size, w.budget) if sm90 \
        else None
    if sm90:
        K = plan["k_x"]
        x2 = sm90_x(x2, K)
    counter = gemm_counter(inl.block_size, w.budget)
    args = (x2.data_ptr(), _view8(inl.codes).data_ptr(),
            inl.scale_exp.data_ptr(), w.out_scale_exp.data_ptr(),
            _view8(w.out_codes).data_ptr(), w.out_pos.data_ptr(),
            out.data_ptr(), M, K, N, Kp, inl.block_size, w.budget,
            _scale_fold(inl.elem_format), codes_fp8, oc_fp8,
            int(out_dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if sm90 and plan["any"]:
        err = _kernel("dequant_gemm_outlier_any")(
            *args, plan["unit"]["unit_rows"], stream)
    else:
        err = _kernel("dequant_gemm_outlier")(*args, int(sm90), stream)
    build.check(err, counter)
    launch_counts[counter] += 1
    return out.reshape(x.shape[:-1] + (N,))


def dequant_matmul_outlier(x: torch.Tensor, w: PackedMXOutlier,
                           out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(w) for the side-band format: the GEMV below
    GEMM_FROM_M rows, else the GEMM; the twin on the CPU."""
    if _rows(x) < GEMM_FROM_M:
        return dequant_gemv_outlier(x, w, out_dtype)
    return dequant_gemm_outlier(x, w, out_dtype)
