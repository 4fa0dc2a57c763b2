"""The host side of the wgmma + TMA GEMM (``csrc/gemm_sm90.cuh``) that the
pf6, pf4, sb4, sb2, fp16-container, emi8/emi8m, int8-container, float8,
side-band and compact-NB GEMMs run on: its plan (tile,
stages, shared memory, padding of x) at every Llama-3-8B shape and every
block it is compiled for; the routing of every block that the JAX packers
take to the sm90 loop (compiled per block, or ``csrc/gemm_any.cu``'s
kernels, which take the block at run time; ``gemm_tile`` is left to the NB
format above 16 slots); the raw copies ("units") of the run-time-block
kernels and a CPU model of their decoders' walks over the packed rows; the
plain GEMM twins against JAX's at blocks 48 and 128; and the zero-padding
of x to a multiple of 8 columns, which must leave the plain versions'
results bit for bit as they are, against the JAX twins on the same numpy
inputs. The kernels themselves are held to the plain versions on a card by
tests/test_torch_kernels_gpu.py (``-k sm90``).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import outlier as jol
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul_nb_reference as j_nb_ref,
    dequant_matmul_outlier_reference as j_outlier_ref,
    dequant_matmul_reference as j_reference)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

CSRC = Path(dm.__file__).resolve().parent / "csrc"
LLAMA3_8B = {"qkv": (4096, 6144), "o": (4096, 4096),
             "gate_up": (4096, 28672), "down": (14336, 4096),
             "lm_head": (4096, 128256)}
PLANS = ([("pf6", 0)]
         + [("sideband", b) for b in (0, 1, 2, 3, 4, 5, 8)])


@pytest.mark.parametrize("kind,budget", PLANS)
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("lin", sorted(LLAMA3_8B))
def test_plan_fits_shared_memory_at_llama_shapes(lin, block, kind, budget):
    K, N = LLAMA3_8B[lin]
    plan = dm.sm90_plan(kind, K, N, block, budget)
    assert plan["tile"] == (256, 128, 64)
    assert plan["stages"] >= 3
    assert plan["smem_bytes"] <= dm.SM90_MAX_SMEM == 232448
    assert plan["raw_bytes"] > 0 and plan["tma"]
    assert plan["k_x"] == K and not plan["pad_x"]
    if kind == "sideband":
        assert budget <= plan["slots"] < 2 * max(budget, 1)
        assert plan["slots"] in (1, 2, 4, 8)


# (kind, budget, block) of every sm90 kernel beyond the blocks 16 and 32 of
# pf6 and the side-band format
NEW_PLANS = ([("pf4", 0, b) for b in (16, 32, 64)]
             + [(k, 0, b) for k in ("fp16", "bf16") for b in (8, 16, 32, 64)]
             + [("pf6", 0, 64)]
             + [("sideband", s, b) for b in (8, 64) for s in (0, 1, 2, 4, 8)
                if (b, s) != (8, 8)]
             + [("emi8", 0, b) for b in (4, 8, 16, 32, 64)]
             + [("nb", s, 16) for s in (0, 1, 2, 4, 8, 16)]
             + [("sb4", 0, b) for b in (2, 4, 8, 16, 32, 64)]
             + [("sb2", 0, b) for b in (4, 8, 16, 32, 64)]
             + [(k, 0, b) for k in ("native", "fp8_e4m3", "fp8_e5m2")
                for b in (4, 8, 16, 32, 64)])


@pytest.mark.parametrize("kind,budget,block", NEW_PLANS)
@pytest.mark.parametrize("lin", sorted(LLAMA3_8B))
def test_plan_fits_shared_memory_at_every_sm90_block(lin, kind, budget,
                                                     block):
    K, N = LLAMA3_8B[lin]
    plan = dm.sm90_plan(kind, K, N, block, budget)
    assert dm.gemm_route(kind, block, budget) == "sm90"
    assert plan["tile"] == (256, 128, 64) and plan["stages"] >= 3
    assert plan["smem_bytes"] <= dm.SM90_MAX_SMEM == 232448
    assert plan["tma"] and plan["k_x"] == K and not plan["pad_x"]
    nblk = 64 // block
    raw = {"pf6": (48 + nblk) * 128, "pf4": (32 + nblk) * 128,
           "fp16": (128 + nblk) * 128, "bf16": (128 + nblk) * 128,
           "emi8": (64 + nblk) * 128,
           "native": (64 + nblk) * 128, "fp8_e4m3": (64 + nblk) * 128,
           "fp8_e5m2": (64 + nblk) * 128,
           "sb4": (32 + nblk) * 128, "sb2": (16 + nblk) * 128,
           # 32 code rows, se, seo and 8 rows a slot of the slot class, 64
           # K columns each
           "nb": (48 + 8 * plan["slots"]) * 64}.get(kind)
    if raw is not None:           # the decoder's raw copy of one step
        assert plan["raw_bytes"] == raw
    if kind in ("fp16", "bf16"):  # 16 KB of codes a step: 3 stages, 3 buffers
        assert (plan["stages"], plan["raw_buffers"]) == (3, 3)
    if kind in ("emi8", "nb", "sb4", "sb2", "native", "fp8_e4m3",
                "fp8_e5m2"):                   # pf6's ring: 4 stages, 3
        assert (plan["stages"], plan["raw_buffers"]) == (4, 3)


# (sm90_plan arguments) that no kernel compiled per block takes: the
# blocks that do not divide the 64-deep K step (sb4 48 and 128, sb2 12 and
# 48 among them), pf6 below 16, emi8, int8 and float8 at block 2 (a 12 KB
# raw step leaves no 4-stage ring) and the side-band format at block 8 with
# 8 slots, all of which gemm_any.cu's kernels take; the NB format above 16
# slots and at another block than 16 (gemm_tile takes them); and a
# side-band budget above 8 (nothing does)
REFUSED = [("pf6", 256, 128, 8), ("pf6", 256, 128, 128),
           ("pf4", 256, 128, 48), ("pf4", 256, 128, 128),
           ("fp16", 256, 128, 48), ("fp16", 256, 128, 4),
           ("bf16", 256, 128, 48), ("bf16", 256, 128, 4),
           ("sideband", 256, 128, 8, 8), ("sideband", 256, 128, 48, 4),
           ("sideband", 256, 128, 16, 9), ("emi8", 256, 128, 48),
           ("emi8", 256, 128, 2), ("emi8", 256, 128, 128),
           ("nb", 256, 128, 16, 17), ("nb", 256, 128, 32, 2),
           ("sb4", 256, 128, 48), ("sb4", 256, 128, 128),
           ("sb2", 256, 128, 12), ("sb2", 256, 128, 48),
           ("native", 256, 128, 2), ("native", 256, 128, 48),
           ("fp8_e4m3", 256, 128, 2), ("fp8_e4m3", 256, 128, 128),
           ("fp8_e5m2", 256, 128, 2), ("fp8_e5m2", 256, 128, 48)]


@pytest.mark.parametrize("args", REFUSED, ids=lambda a: "-".join(map(str, a)))
def test_plan_pads_ragged_k_and_refuses_other_blocks(args):
    """Every block that no kernel compiled per block takes runs on
    gemm_any.cu's (its plan fits and names the unit), but for the NB
    format's and pf6's below 32, which no packer makes (gemm_tile takes
    them), and a side-band budget above 8, which nothing takes."""
    plan = dm.sm90_plan("pf6", 203, 130, 32)
    assert plan["pad_x"] and plan["k_x"] == 208 and not plan["tma"]
    assert not dm.sm90_plan("sideband", 200, 384, 16, 4)["pad_x"]
    kind, block, budget = args[0], args[3], (args[4:] or (0,))[0]
    if kind == "sideband" and budget > dm.MAX_OUTLIER_BUDGET:
        for fn in (dm.sm90_plan, dm.gemm_route):
            with pytest.raises(ValueError):
                fn(*args) if fn is dm.sm90_plan else fn(kind, block, budget)
        return
    if kind == "nb" or block % PACKER_MULTIPLE.get(kind, 1):
        with pytest.raises(ValueError):
            dm.sm90_plan(*args)
        assert dm.gemm_route(kind, block, budget) == "tile"
        return
    plan = dm.sm90_plan(*args)
    assert dm.gemm_route(kind, block, budget) == "sm90"
    assert plan["any"] and dm.block_is_any(kind, block, budget)
    assert plan["smem_bytes"] <= dm.SM90_MAX_SMEM
    assert plan["unit"] == dm.sm90_unit(kind, block, budget)
    assert plan["unit"]["unit_bytes"] <= plan["raw_bytes"]


def test_plan_mirrors_the_kernel_sources():
    """The plan's constants are the ones the CUDA sources compile with."""
    head = (CSRC / "gemm_sm90.cuh").read_text()
    assert "kBM = 256, kBN = 128, kBK = 64" in head
    assert f"kMaxSmem = {dm.SM90_MAX_SMEM}" in head
    assert ("return 1024 + stages * kStageBytes + rawbufs * raw_pad(raw)\n"
            "         + (2 * stages + rawbufs) * 8;") in head
    assert "esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16" in head
    dq = (CSRC / "dequant_matmul.cu").read_text()
    for dec, ring, blocks in (("Pf6Sm90", "kStages = 4, kRawBufs = 3",
                               "B == 16 || B == 32 || B == 64"),
                              ("Pf4Sm90", "kStages = 4, kRawBufs = 3",
                               "B == 16 || B == 32 || B == 64"),
                              ("Fp16Sm90", "kStages = 3, kRawBufs = 3",
                               "B == 8 || B == 16 || B == 32 || B == 64"),
                              ("Bf16Sm90", "kStages = 3, kRawBufs = 3",
                               "B == 8 || B == 16 || B == 32 || B == 64"),
                              ("ByteSm90", "kStages = 4, kRawBufs = 3",
                               "B == 4 || B == 8 || B == 16 || B == 32 "
                               "|| B == 64"),
                              ("SubbyteSm90", "kStages = 4, kRawBufs = 3",
                               "(F == 2 && (B == 2 || B == 4 || B == 8 "
                               "|| B == 16\n                            "
                               "|| B == 32 || B == 64))\n"
                               "                    || (F == 4 && (B == 4 "
                               "|| B == 8 || B == 16 || B == 32\n"
                               "                                   "
                               "|| B == 64))")):
        body = dq[dq.index(f"struct {dec} "):]
        body = body[:body.index("\n};\n")]
        assert ring in body and f"static_assert({blocks}" in body
    for kind, blocks in dm.SM90_BLOCKS.items():
        if kind in ("sideband", "nb"):
            continue
        decode = {"pf6": "kPf6", "pf4": "kPf4", "fp16": "kFp16",
                  "bf16": "kBf16",
                  "emi8": "kEmi8", "sb4": "kSb4", "sb2": "kSb2",
                  "native": "kInt8", "fp8_e4m3": "kFp8E4m3",
                  "fp8_e5m2": "kFp8E5m2"}[kind]
        assert [b for b in (2, 4, 8, 16, 32, 48, 64, 128)
                if f"MXQ_SM90(mxq::{decode}, {b})" in dq] == list(blocks)
    # sb4 and sb2 are SubbyteSm90 with 2 and 4 fields a byte
    assert "using Sb4Sm90 = SubbyteSm90<2, B>;" in dq
    assert "using Sb2Sm90 = SubbyteSm90<4, B>;" in dq
    assert "D == mxq::kSb4, Sb4Sm90<B>," in dq
    assert "D == mxq::kSb2, Sb2Sm90<B>," in dq
    # emi8, int8 and float8 are ByteSm90, each decode named in the chain,
    # whose fallback does not compile
    for alias in ("using Emi8Sm90 = ByteSm90<mxq::kEmi8, B>;",
                  "using Int8Sm90 = ByteSm90<mxq::kInt8, B>;",
                  "using Fp8Sm90 = ByteSm90<D, B>;",
                  "D == mxq::kEmi8, Emi8Sm90<B>,",
                  "D == mxq::kInt8, Int8Sm90<B>,",
                  "mxq::is_fp8<D>(),\n", "Fp8Sm90<D, B>,\n",
                  "D == mxq::kBf16, Bf16Sm90<B>,",
                  "NoSm90Dec<D>>>>>>>>>>;",
                  'static_assert(D < 0, "no sm90 decoder for this decode");',
                  "|| D == mxq::kInt8 || mxq::is_fp8<D>(),"):
        assert alias in dq, alias
    nb = (CSRC / "nb_matmul.cu").read_text()
    body = nb[nb.index("struct NbSm90 "):]
    body = body[:body.index("\n};\n")]
    assert "kStages = 4, kRawBufs = 3, kDwg = 2;" in body
    assert "kRawBytes = kObOff + MAXB * kSlotBytes;" in body
    assert [int(c) for c in
            __import__("re").findall(r"MXQ_NB\((\d+)\);", nb)] == list(
                dm.NB_SLOT_CLASSES)
    sb = (CSRC / "outlier_matmul.cu").read_text()
    assert ("MAXB <= 4\n"
            "      && mxq::sm90::ring_bytes(3, kRawBytes, 3) <= "
            "mxq::sm90::kMaxSmem;") in sb
    assert "kStages = 3, kRawBufs = kThreeRaw ? 3 : 2;" in sb
    built = sorted((int(b), int(m)) for m, b in
                   __import__("re").findall(r"MXQ_SIDEBAND\((\d+), (\d+)\)",
                                            sb))
    want = sorted((b, s) for b in dm.SM90_BLOCKS["sideband"]
                  for s in (1, 2, 4, 8)
                  if not dm.block_is_any("sideband", b, s))
    assert built == want
    # gemm_any.cu: the rings and raw buffers that _ANY_RINGS mirrors
    an = (CSRC / "gemm_any.cu").read_text()
    for dec, ring in (("RowAny", "kStages = mxq::code_bytes<D>() == 1 ? 4 : 3"
                                 ";\n  static constexpr int kRawBufs = "
                                 "mxq::code_bytes<D>() == 1 ? 2 : 3;"),
                      ("PlanarAny", "kStages = 3, kRawBufs = 2, kDwg = 2;"),
                      ("SidebandAny", "kStages = 3, kRawBufs = 2, kDwg = 2;")):
        body = an[an.index(f"struct {dec} "):]
        assert ring in body[:body.index("\n};\n")], dec
    assert dm._ANY_RINGS["row1"] == (4, 2, (64 + 64) * 128)
    assert dm._ANY_RINGS["row2"] == (3, 3, (128 + 64) * 128)
    assert "static constexpr int kMaxExp = kBK;" in an
    assert dm._ANY_RINGS["planar"][2] == dm._ANY_RINGS["sideband"][2] \
        == 327 * 128
    assert an.count("static constexpr int kRawBytes = 327 * kN;") == 2
    assert "return U % B == 0 ? U / B : (U + B - 2) / B + 1;" in an
    for b in range(1, 300):
        assert dm._exp_rows(64, b) == (64 // b if 64 % b == 0
                                       else (64 + b - 2) // b + 1)


# (JAX packer call, port kind, budget) for each transport the GEMMs take;
# pack_mx at block B, or pack_mx_outlier
ROUTED = {"pf6": ("fp6_e3m2", "pf6"), "pf4": ("fp4_e2m1", "pf4"),
          "fp16": ("fp16", "native"), "bf16": ("bfloat16", "native"),
          "sb4": ("int4", "sb4"), "sb2": ("int2", "sb2"),
          "emi8": ("fp6_e3m2", "emi8"),
          "emi8_fp4": ("fp4_e2m1", "emi8"), "emi8m": None,
          "int8": ("int8", "native"), "fp8_e4m3": ("fp8_e4m3", "native"),
          "fp8_e5m2": ("fp8_e5m2", "native"),
          "fp6_native": ("fp6_e3m2", "native"),
          "sideband": None, "sideband8": None}


def _jax_packs(name, block):
    """Whether the JAX packer takes ``name`` at ``block``; the port's
    packer must agree."""
    W = np.random.default_rng(block).standard_normal((128, 64)
                                                     ).astype(np.float32)

    def pack(lib, A):
        if name.startswith("sideband"):
            return lib.pack_mx_outlier(
                A, 8, 8, "int2", "fp4_e2m1", std_dev=2.0, block_size=block,
                outlier_budget=8 if name == "sideband8" else 4, axis=0)
        if name == "emi8m":       # exact values: small integers
            return lib.pack_emi8m_absolute(lib_round(A), block_size=block,
                                           axis=0)
        fmt, transport = ROUTED[name]
        return lib.pack_mx(A, 8, fmt, block, axis=0, transport=transport)

    def lib_round(A):
        return jnp.round(A * 4) if isinstance(A, jnp.ndarray) else \
            torch.round(A * 4)

    try:
        pack(jpk, jnp.asarray(W))
    except (AssertionError, ValueError):
        with pytest.raises((AssertionError, ValueError)):
            pack(tpk, torch.from_numpy(W))
        return False
    pack(tpk, torch.from_numpy(W))
    return True


# the block multiples that the JAX packers require, where they require one
PACKER_MULTIPLE = {"pf6": 32, "pf4": 16, "sb2": 4}


@pytest.mark.parametrize("block", [2, 4, 6, 8, 12, 16, 20, 24, 32, 48, 64,
                                   96, 128, 256])
@pytest.mark.parametrize("name", sorted(ROUTED))
def test_gemm_route_names_a_kernel_for_every_block_the_packers_take(
        name, block):
    """Every block that the JAX packer accepts routes to the sm90 loop,
    whose plan then fits (compiled per block where the block is one of
    ``SM90_BLOCKS`` and its ring fits, else gemm_any.cu's kernel); the
    side-band format at every budget up to 8; and the launch counter of
    that kernel exists and is not a gemm_tile one."""
    if not _jax_packs(name, block):
        assert block % PACKER_MULTIPLE[name]
        return
    if name.startswith("sideband"):
        for budget in range(dm.MAX_OUTLIER_BUDGET + 1):
            assert dm.gemm_route("sideband", block, budget) == "sm90"
            plan = dm.sm90_plan("sideband", 4096, 4096, block, budget)
            assert plan["smem_bytes"] <= dm.SM90_MAX_SMEM
            assert om.gemm_counter(block, budget) == "dequant_gemm_outlier"
        return
    decode = {"emi8_fp4": "emi8", "emi8m": "emi8", "int8": "native",
              "fp6_native": "fp8_e4m3"}.get(name, name)
    route = dm.gemm_route(decode, block)
    assert dm.gemm_counter(decode, block) == f"dequant_matmul_{decode}"
    assert dm.gemm_counter(decode, block) in dm.launch_counts
    plan = dm.sm90_plan(decode, 4096, 4096, block)
    assert plan["smem_bytes"] <= dm.SM90_MAX_SMEM
    assert plan["any"] == (block not in dm.SM90_BLOCKS[decode])
    assert route == "sm90"


# the smallest block of each planar transport that a packer makes but
# whose gemm_any.cu unit would not fit (a 64-row stage's whole blocks over
# 256 code rows or the raw buffer), so gemm_route leaves it on gemm_tile
FIRST_TILE_BLOCK = {"pf6": 224, "pf4": 272, "sb4": 258, "sb2": 516}


@pytest.mark.parametrize("kind", sorted(FIRST_TILE_BLOCK))
def test_planar_blocks_left_on_gemm_tile_are_those_no_unit_fits(kind):
    """The planar blocks that stay on ``gemm_tile``: exactly those whose
    ``sm90_unit`` is None, from FIRST_TILE_BLOCK on (the JAX packer makes
    that block, and its counter is the ``_tile`` one); below it every
    block that the packer's multiple allows runs on the sm90 loop."""
    mult, low = dm._PLANAR_MULTIPLE[kind], dm._PLANAR_MIN[kind]
    first = FIRST_TILE_BLOCK[kind]
    assert _jax_packs(kind, first)
    for block in range(mult, 1025, mult):
        route = dm.gemm_route(kind, block)
        if block < low:
            assert route == "sm90" and not dm.block_is_any(kind, block)
            continue
        assert (route == "tile") == (dm.sm90_unit(kind, block) is None)
        if block < first:
            assert route == "sm90"
    assert dm.gemm_route(kind, first) == "tile"
    assert dm.gemm_counter(kind, first) == f"dequant_matmul_{kind}_tile"
    assert dm.gemm_counter(kind, first) in dm.launch_counts
    with pytest.raises(ValueError):
        dm.sm90_plan(kind, 4096, 4096, first)


def _x(M, K, seed):
    """Small integers: with them every f32 sum of these products is exact,
    so two libraries' sums agree bit for bit in any order."""
    return np.random.default_rng(seed).integers(-4, 5, (M, K)
                                                ).astype(np.float32)


def _padded(x: np.ndarray, k_x: int) -> torch.Tensor:
    """x as the sm90 GEMM reads it: bf16, zero columns up to k_x."""
    x8 = dm.sm90_x(torch.from_numpy(x).to(torch.bfloat16), k_x)
    assert x8.shape[1] == k_x and not x8[:, x.shape[1]:].any()
    return x8


def _zero_blocks(t, k_x: int):
    """The serving-layout weight t read to k_x rows, as the sm90 GEMM reads
    it: blocks past the weight (blocks 2 and 4 hold fewer than k_x rows at
    K = 203) are zero codes, which decode to +0 at any exponent."""
    nb = -(-k_x // t.block_size) - t.codes.shape[0]
    if nb > 0:
        t = dataclasses.replace(
            t, codes=torch.cat([t.codes, t.codes.new_zeros(
                (nb,) + t.codes.shape[1:])]),
            scale_exp=torch.cat([t.scale_exp, t.scale_exp.new_zeros(
                (nb,) + t.scale_exp.shape[1:])]))
    assert t.codes.shape[0] * t.block_size >= k_x
    return dataclasses.replace(t, orig_dim=k_x)


def test_k8_padding_leaves_the_pf6_reference_unchanged():
    K, N, M = 203, 96, 5
    rng = np.random.default_rng(11)
    W = (rng.standard_normal((K, N))
         * np.exp(rng.uniform(-2, 2, (1, N)))).astype(np.float32)
    j = jpk.to_serving_layout(jpk.pack_mx(jnp.asarray(W), 8, "fp6_e3m2", 32,
                                          axis=0, transport="pf6"))
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8,
                                          "fp6_e3m2", 32, axis=0,
                                          transport="pf6"))
    plan = dm.sm90_plan("pf6", K, N, 32)
    assert plan["pad_x"] and t.codes.shape[0] * 32 >= plan["k_x"]
    x = _x(M, K, 12)
    want = np.asarray(j_reference(jnp.asarray(x), j))
    y = dm.dequant_matmul_reference(torch.from_numpy(x), t)
    # the weight read to k_x rows meets the zero columns of x
    y8 = dm.dequant_matmul_reference(
        _padded(x, plan["k_x"]), dataclasses.replace(t, orig_dim=plan["k_x"]))
    assert torch.equal(y8, y)
    np.testing.assert_array_equal(y8.numpy(), want)


def test_k8_padding_leaves_the_sideband_reference_unchanged():
    K, N, M = 203, 96, 5
    rng = np.random.default_rng(13)
    W = (rng.standard_normal((K, N))
         * np.exp(rng.uniform(-1, 1, (1, N)))).astype(np.float32)
    W.ravel()[rng.integers(0, K * N, K * N // 64)] *= 25.0
    args = (8, 8, "int2", "fp4_e2m1")
    kw = dict(std_dev=2.0, block_size=16, outlier_budget=4, axis=0)
    j = jpk.pack_mx_outlier(jnp.asarray(W), *args, **kw)
    t = tpk.pack_mx_outlier(torch.from_numpy(W), *args, **kw)
    plan = dm.sm90_plan("sideband", K, N, 16, t.budget)
    assert plan["pad_x"] and t.inlier.codes.shape[0] >= plan["k_x"]
    x = _x(M, K, 14)
    want = np.asarray(j_outlier_ref(jnp.asarray(x), j))
    y = om.dequant_matmul_outlier_reference(torch.from_numpy(x), t)
    t8 = dataclasses.replace(t, inlier=dataclasses.replace(
        t.inlier, orig_dim=plan["k_x"]))
    y8 = om.dequant_matmul_outlier_reference(_padded(x, plan["k_x"]), t8)
    assert torch.equal(y8, y)
    np.testing.assert_array_equal(y8.numpy(), want)


@pytest.mark.parametrize("fmt,transport,block", [
    ("fp4_e2m1", "pf4", 16), ("fp4_e2m1", "pf4", 32), ("fp4_e2m1", "pf4", 64),
    ("fp16", "native", 8), ("fp16", "native", 32), ("fp16", "native", 64),
    ("fp6_e3m2", "pf6", 64), ("fp6_e3m2", "emi8", 32),
    ("fp6_e3m2", "emi8", 8), ("fp4_e2m1", "emi8", 16),
    ("fp6_e2m3", "emi8", 64), ("int4", "sb4", 2), ("int4", "sb4", 8),
    ("int4", "sb4", 32), ("int4", "sb4", 64), ("int2", "sb2", 4),
    ("int2", "sb2", 16), ("int2", "sb2", 64), ("int8", "native", 4),
    ("int8", "native", 32), ("int2", "native", 64),
    ("fp8_e4m3", "native", 8), ("fp8_e4m3", "native", 64),
    ("fp6_e3m2", "native", 32), ("fp8_e5m2", "native", 4),
    ("fp8_e5m2", "native", 16)])
def test_k8_padding_leaves_the_sm90_references_unchanged(fmt, transport,
                                                         block):
    K, N, M = 203, 96, 5
    rng = np.random.default_rng(block + len(fmt))
    W = (rng.standard_normal((K, N))
         * np.exp(rng.uniform(-2, 2, (1, N)))).astype(np.float32)
    if transport == "native":
        # fp16 codes keep 11 bits, int8 and float8 codes span wide
        # exponents a block: small integers times a power of two a column
        # keep every f32 sum exact, as pf4's and pf6's coarse codes
        W = (rng.integers(-16, 17, (K, N))
             * 2.0 ** rng.integers(-3, 3, (1, N))).astype(np.float32)
    j = jpk.to_serving_layout(jpk.pack_mx(jnp.asarray(W), 8, fmt, block,
                                          axis=0, transport=transport))
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, fmt,
                                          block, axis=0,
                                          transport=transport))
    decode = dm.sad_decode_params(t)[0]
    assert dm.gemm_route(decode, block) == "sm90"
    plan = dm.sm90_plan(decode, K, N, block)
    assert plan["pad_x"]
    x = _x(M, K, block)
    want = np.asarray(j_reference(jnp.asarray(x), j))
    y = dm.dequant_matmul_reference(torch.from_numpy(x), t)
    y8 = dm.dequant_matmul_reference(_padded(x, plan["k_x"]),
                                     _zero_blocks(t, plan["k_x"]))
    assert torch.equal(y8, y)
    np.testing.assert_array_equal(y8.numpy(), want)


@pytest.mark.parametrize("block", [8, 64])
def test_k8_padding_leaves_the_sideband_reference_unchanged_at_new_blocks(
        block):
    K, N, M = 203, 96, 5
    rng = np.random.default_rng(block)
    W = (rng.standard_normal((K, N))
         * np.exp(rng.uniform(-1, 1, (1, N)))).astype(np.float32)
    W.ravel()[rng.integers(0, K * N, K * N // 64)] *= 25.0
    args = (8, 8, "int2", "fp4_e2m1")
    kw = dict(std_dev=2.0, block_size=block, outlier_budget=4, axis=0)
    j = jpk.pack_mx_outlier(jnp.asarray(W), *args, **kw)
    t = tpk.pack_mx_outlier(torch.from_numpy(W), *args, **kw)
    plan = dm.sm90_plan("sideband", K, N, block, t.budget)
    assert plan["pad_x"] and t.inlier.codes.shape[0] >= plan["k_x"]
    x = _x(M, K, block + 1)
    want = np.asarray(j_outlier_ref(jnp.asarray(x), j))
    y = om.dequant_matmul_outlier_reference(torch.from_numpy(x), t)
    t8 = dataclasses.replace(t, inlier=dataclasses.replace(
        t.inlier, orig_dim=plan["k_x"]))
    y8 = om.dequant_matmul_outlier_reference(_padded(x, plan["k_x"]), t8)
    assert torch.equal(y8, y)
    np.testing.assert_array_equal(y8.numpy(), want)


@pytest.mark.parametrize("kind,rows", [("sb4", 32), ("sb2", 16)])
def test_sb4_and_sb2_rings_fit_at_every_block_dividing_64(kind, rows):
    """sb4's raw step (32 packed rows and one exponent row a block, 128
    columns) and sb2's (16 packed rows) leave a ring of 4 stages and 3 raw
    buffers within 227 KB at every block that the packers take (sb4: even,
    sb2: multiples of 4) and that divides the 64-deep K step; the largest
    is sb4 at block 2, 222,296 bytes."""
    per = {"sb4": 2, "sb2": 4}[kind]
    blocks = tuple(b for b in (1, 2, 4, 8, 16, 32, 64) if b % per == 0)
    assert all(dm._ring_bytes(4, (rows + 64 // b) * 128, 3)
               <= dm.SM90_MAX_SMEM for b in blocks)
    assert blocks == dm.SM90_BLOCKS[kind]
    assert dm.sm90_plan("sb4", 4096, 28672, 2)["smem_bytes"] == 222296
    assert dm.gemm_counter(kind, 32) == f"dequant_matmul_{kind}"
    assert dm.gemm_counter(kind, 48) == f"dequant_matmul_{kind}"
    assert f"dequant_matmul_{kind}_tile" in dm.launch_counts


def test_emi8_blocks_are_those_whose_ring_fits():
    """emi8's sm90 blocks are the divisors of the 64-deep K step whose raw
    step (64 code rows and one exponent row a block, 128 columns) leaves a
    ring of 4 stages and 3 raw buffers within 227 KB: 4 to 64, not 2 or
    1."""
    fits = tuple(b for b in (1, 2, 4, 8, 16, 32, 64)
                 if dm._ring_bytes(4, (64 + 64 // b) * 128, 3)
                 <= dm.SM90_MAX_SMEM)
    assert fits == dm.SM90_BLOCKS["emi8"] == (4, 8, 16, 32, 64)
    assert dm.sm90_plan("emi8", 4096, 28672, 32)["smem_bytes"] == 223064
    assert dm.gemm_counter("emi8", 32) == "dequant_matmul_emi8"
    assert dm.gemm_counter("emi8", 48) == "dequant_matmul_emi8"
    assert "dequant_matmul_emi8_tile" in dm.launch_counts


@pytest.mark.parametrize("budget", range(0, 18))
def test_nb_gemm_route_at_every_budget(budget):
    """The compact NB GEMM takes the sm90 loop at every budget up to 16
    (a slot's row is 4 bits, so no packer makes more), sized by the
    smallest slot class that holds it; above 16 gemm_tile's nb_gemm."""
    route = dm.gemm_route("nb", 16, budget)
    counter = om.nb_gemm_counter(budget)
    assert counter in om.launch_counts
    if budget > 16:
        assert route == "tile" and counter == "dequant_gemm_nb_tile"
        with pytest.raises(ValueError):
            dm.sm90_plan("nb", 4096, 28672, 16, budget)
        return
    assert route == "sm90" and counter == "dequant_gemm_nb"
    plan = dm.sm90_plan("nb", 4096, 28672, 16, budget)
    want = next(c for c in dm.NB_SLOT_CLASSES if c >= max(budget, 1))
    assert plan["slots"] == want
    assert plan["raw_bytes"] == 3072 + 512 * want
    assert plan["smem_bytes"] <= dm.SM90_MAX_SMEM
    assert plan["tma"] and not plan["pad_x"]
    assert not dm.sm90_plan("nb", 4104, 28672, 16, budget)["tma"]
    assert dm.gemm_route("nb", 32, budget) == "tile"


def _nb_decisions(N, K, cap, seed):
    """RTN decisions on the (N, K) weight from the JAX package, as numpy."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((N, K)) * 0.02).astype(np.float32)
    W[rng.random(W.shape) < 0.03] *= 10.0
    _, _, dec = jol.quantize_mx_outlier_hessian_decisions(
        jnp.asarray(W), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0], 16,
        max_outliers_per_block=cap)
    dec = {k: np.asarray(v) for k, v in dec.items()}
    dec["block_size"] = 16
    return dec


def test_nb_packers_make_at_most_16_slots():
    """Asked for 20 slots, both packers make 16: every NB weight they make
    takes the sm90 route."""
    dec = _nb_decisions(48, 32, 0, 5)
    j = jpk.pack_outlier_nb(dec, budget=20)
    t = tpk.pack_outlier_nb({k: (torch.from_numpy(np.array(v))
                                 if isinstance(v, np.ndarray) else v)
                             for k, v in dec.items()}, budget=20)
    assert j.out_byte.shape[0] == t.budget == 16
    assert dm.gemm_route("nb", 16, t.budget) == "sm90"


@pytest.mark.parametrize("budget", [1, 2])
def test_k8_padding_leaves_the_nb_reference_unchanged(budget):
    """x padded to k_x columns meets zero weight columns (codes, exponents
    and slot bytes 0 decode to +0), as the sm90 NB GEMM reads them."""
    N, K, M = 40, 203, 5
    dec = _nb_decisions(N, K, budget, 17 + budget)
    j = jpk.pack_outlier_nb(dec, budget=budget)
    t = tpk.pack_outlier_nb({k: (torch.from_numpy(np.array(v))
                                 if isinstance(v, np.ndarray) else v)
                             for k, v in dec.items()}, budget=budget)
    plan = dm.sm90_plan("nb", K, N, 16, t.budget)
    assert plan["pad_x"] and plan["k_x"] == 208 and not plan["tma"]
    x = _x(M, K, 18)
    want = np.asarray(j_nb_ref(jnp.asarray(x), j))
    y = om.dequant_matmul_nb_reference(torch.from_numpy(x), t)
    pad = lambda a: torch.nn.functional.pad(a, (0, plan["k_x"] - K))
    t8 = dataclasses.replace(
        t, codes=pad(t.codes), scale_exp=pad(t.scale_exp),
        out_byte=pad(t.out_byte), out_scale_exp=pad(t.out_scale_exp),
        orig_k=plan["k_x"])
    y8 = om.dequant_matmul_nb_reference(_padded(x, plan["k_x"]), t8)
    assert torch.equal(y8, y)
    np.testing.assert_array_equal(y8.numpy(), want)


@pytest.mark.parametrize("block", [16, 32])
def test_k8_padding_leaves_the_emi8m_reference_unchanged(block):
    """The absolute emi8m stream (its own mw and fold) through the padded
    x, against the JAX twin."""
    K, N, M = 203, 96, 5
    rng = np.random.default_rng(block + 3)
    W = (rng.integers(-7, 8, (K, N))
         * 2.0 ** rng.integers(-3, 2, (1, N))).astype(np.float32)
    j = jpk.to_serving_layout(jpk.pack_emi8m_absolute(jnp.asarray(W),
                                                      block_size=block))
    t = tpk.to_serving_layout(tpk.pack_emi8m_absolute(torch.from_numpy(W),
                                                      block_size=block))
    assert t.transport == "emi8m" and dm.sad_decode_params(t)[0] == "emi8"
    assert dm.gemm_route("emi8", block) == "sm90"
    plan = dm.sm90_plan("emi8", K, N, block)
    assert plan["pad_x"] and t.codes.shape[0] * block >= plan["k_x"]
    x = _x(M, K, block)
    want = np.asarray(j_reference(jnp.asarray(x), j))
    y = dm.dequant_matmul_reference(torch.from_numpy(x), t)
    y8 = dm.dequant_matmul_reference(
        _padded(x, plan["k_x"]), dataclasses.replace(t, orig_dim=plan["k_x"]))
    assert torch.equal(y8, y)
    np.testing.assert_array_equal(y8.numpy(), want)


def test_shipped_digests_cover_the_nb_gemm():
    """shipped_digests.py digests the compact NB GEMV and GEMM beside the
    MX decodes (on the CPU through the plain versions), so that two builds'
    NB GEMMs can be compared on a card."""
    from microscopiq_tpu_torch.scripts import shipped_digests as sd

    got = sd.digests("cpu")
    assert len(got) == len(sd.DECODES) + 2       # the NB and side-band lines
    p, x = sd._nb_case(torch.device("cpu"))
    assert p.budget == 2 and tuple(x.shape) == (300, 512)
    want = sd._digest(om.dequant_matmul_nb_reference(x, p))
    assert got["int2_fp4_nb_b16"]["gemm"] == want
    assert got["int2_fp4_nb_b16"]["gemv"] == sd._digest(
        om.dequant_matmul_nb_reference(x[:8], p))


def test_shipped_digests_cover_the_sideband_gemv():
    """shipped_digests.py digests the side-band GEMV and GEMM (on the CPU
    through the plain twin), so that two builds' can be compared on a
    card."""
    from microscopiq_tpu_torch.scripts import shipped_digests as sd

    got = sd.digests("cpu")["int2_fp4_sideband_b16"]
    p, x = sd._sideband_case(torch.device("cpu"))
    assert p.budget == 4 and p.inlier.block_size == 16
    assert got["gemm"] == sd._digest(om.dequant_matmul_outlier_reference(x, p))
    assert got["gemv"] == sd._digest(
        om.dequant_matmul_outlier_reference(x[:8], p))


# ---------------------------------------------------------------------------
# gemm_any.cu: the units of the kernels that take the block at run time
# ---------------------------------------------------------------------------
# every decode at those of blocks 2, 12, 48 and 128 that its packer takes,
# and the side-band format at block 8 with 8 slots and at 48 with 4
UNIT_CASES = ([(d, b, 0) for d in sorted(dm._DECODES) for b in (2, 12, 48, 128)
               if b % {"pf6": 32, "pf4": 16, "sb4": 2, "sb2": 4}.get(d, 1)
               == 0]
              + [("sideband", 8, 8), ("sideband", 48, 4)]
              # units that straddle blocks (lcm(B, 64) would not fit)
              + [("sb4", 18, 0), ("sb2", 68, 0), ("pf4", 144, 0)])


def _packed_rows(kind, block, k):
    """The packed rows (of the (NB * rows, N) codes) that hold K row k of a
    ``kind`` weight in blocks of ``block``: the transport's layout
    (packing._subbyte_pack; pf6's two low planes and its high plane)."""
    nb, j = divmod(k, block)
    rows = tpk.transport_rows_per_block(kind, block)
    if kind == "pf6":
        q = block // 4
        return {nb * rows + j % q + (j // q % 2) * q, nb * rows + 2 * q + j % q}
    if kind in ("pf4", "sb4", "sb2"):
        return {nb * rows + j % rows}
    return {k}


@pytest.mark.parametrize("kind,block,budget", UNIT_CASES)
def test_any_units_cover_every_k_row_once_in_order(kind, block, budget):
    """The host-side mirror of gemm_any.cu's raw copies (sm90_copies): the
    copies cover x's K rows exactly once, in order, U rows each from a
    multiple of U, whole 64-row stages (U = 64 S) or a part of one
    (U = 64 / H); every K row's packed rows and block exponent row lie in
    its copy's code and exponent rows; each copy is at most 256 rows of
    each (a TMA box) and fits the plan's raw buffer."""
    if not dm.block_is_any(kind, block, budget):
        assert block in dm.SM90_BLOCKS[kind]      # compiled for this block
        return
    K = 1000
    plan = dm.sm90_plan(kind, K, 4096, block, budget)
    unit = plan["unit"]
    U = unit["unit_rows"]
    S, H = unit["stages"], unit["parts"]
    assert U == 64 * S // H and min(S, H) == 1
    copies = dm.sm90_copies(kind, K, block, budget)
    covered = []
    for i, cp in enumerate(copies):
        k0, k1 = cp["k_rows"]
        assert (k0, k1) == (i * U, (i + 1) * U)
        assert cp["code_rows"][1] - cp["code_rows"][0] <= 256
        assert cp["exp_rows"][1] - cp["exp_rows"][0] <= 256
        assert cp["bytes"] == unit["unit_bytes"] <= plan["raw_bytes"]
        for k in range(k0, k1):
            assert set(range(*cp["code_rows"])) >= _packed_rows(kind, block,
                                                                 k)
            assert cp["exp_rows"][0] <= k // block < cp["exp_rows"][1]
        covered += range(k0, k1)
    nk = -(-plan["k_x"] // 64)                    # 64-row stages
    assert covered[:plan["k_x"]] == list(range(plan["k_x"]))
    assert len(copies) == -(-nk * H // S) and len(covered) >= 64 * nk
    cb = 2 if kind in ("fp16", "bf16") else 1
    want = (128 * (U + unit["exp_rows"] * (2 + 5 * budget))
            if kind == "sideband"
            else 128 * (unit["code_rows"] * cb + unit["exp_rows"]))
    assert unit["unit_bytes"] == want


def _div_by(n, d):
    """gemm_any.cu's div_by: n / d through the f32 reciprocal, one
    correction step."""
    inv = np.float32(1) / np.asarray(d, np.float32)
    q = np.trunc(np.asarray(n, np.float32) * inv).astype(np.int64)
    r = n - q * d
    return q + (r >= d) - (r < 0)


def test_reciprocal_division_is_exact():
    """n / d through 1/d as an f32 (gemm_any.cu's div_by) is the integer
    quotient for every d of 1 to 256 and n below 70,000, and for 200,000
    random n below 2^22."""
    d = np.arange(1, 257, dtype=np.int64)[:, None]
    n = np.arange(70000, dtype=np.int64)[None, :]
    np.testing.assert_array_equal(_div_by(n, d), n // d)
    n = np.random.default_rng(0).integers(0, 1 << 22, (1, 200000))
    np.testing.assert_array_equal(_div_by(n, d), n // d)


def _row_scales(B, blk, off, sideband=False):
    """RowWalk::scales: the block (of the copy) of each of a chunk's 8 K
    rows, and the walk's state after it."""
    if B % 8 == 0:
        out = [blk] * 8
        off += 8
        if off == B:
            off, blk = 0, blk + 1
        return out, blk, off
    if B >= 8:
        return ([blk if r < B - off else blk + 1 for r in range(8)],
                blk + (off + 8 >= B), off + 8 - B * (off + 8 >= B))
    if 8 % B == 0 and not sideband:         # RowAny's whole blocks
        return [blk + r // B for r in range(8)], blk + 8 // B, off
    out = []
    for _ in range(8):
        out.append(blk)
        off += 1
        if off == B:
            off, blk = 0, blk + 1
    return out, blk, off


def _planar_chunk(kind, B, blk, f, g):
    """PlanarAny::decode's walk over one chunk (runs of L packed rows of
    one plane): for each K row its (packed row, plane) and block, and the
    walk's state after it."""
    planes = 4 if kind == "pf6" else {"pf4": 2, "sb4": 2, "sb2": 4}[kind]
    q, R = B // planes, tpk.transport_rows_per_block(kind, B)
    L = next(n for n in (8, 4, 2, 1) if q % n == 0)
    out = []
    for _ in range(8 // L):
        for r in range(L):
            if kind == "pf6":
                row = {blk * R + g + r + (f & 1) * q, blk * R + 2 * q + g + r}
            else:
                row = {blk * R + g + r}
            out.append((row, f, blk))
        g += L
        if g >= q:
            g -= q
            f += 1
            if f == planes:
                f, blk = 0, blk + 1
    return out, blk, f, g


@pytest.mark.parametrize("kind", sorted(dm._DECODES) + ["sideband"])
def test_any_decoder_walks_read_each_k_rows_own_operands(kind):
    """A CPU model of gemm_any.cu's decode walks, call by call as the unit
    mainloop makes them (stage d, part ph of H = unit u, part ps of S):
    for every block from 1 to 256 that its kernel takes, each decode
    thread's chunks of 8 K rows (2 warpgroups; RowAny and PlanarAny 4
    chunks a thread, the side-band format its unit's chunks split in two)
    read, for each K row, the packed rows and plane of the transport's
    layout and the exponent row of its block, relative to the copy; every
    8-row chunk of every stage's B tile is written once."""
    budget = 4 if kind == "sideband" else 0
    planes = {"pf6": 4, "pf4": 2, "sb4": 2, "sb2": 4}.get(kind)
    for B in range(1, 257):
        unit = dm.sm90_unit(kind, B, budget)
        if unit is None or (B > 40 and B % 8):
            continue
        U, S, H = unit["unit_rows"], unit["stages"], unit["parts"]
        R = tpk.transport_rows_per_block(kind, B) if planes else 0
        nk = 2 * S
        written = []
        d = u = ph = ps = 0
        while d < nk:
            k0, part = u * U, ph + ps
            for h in range(2):
                if kind == "sideband":
                    per = -(-(U // 8) // 2)
                    chunks = range(h * per, min(h * per + per, U // 8))
                else:
                    chunks = range(4 * h, 4 * h + 4)
                if not chunks:
                    continue
                c0 = chunks[0]
                if planes:
                    q = B // planes
                    j0 = k0 - k0 // B * B + 64 * part + 8 * c0
                    blk = int(_div_by(j0, B))
                    g = j0 - blk * B
                    f = sum(g >= i * q for i in range(1, planes))
                    g -= f * q
                else:
                    qk = int(_div_by(k0 + 8 * c0, B))
                    blk, off = qk - int(_div_by(k0, B)), k0 + 8 * c0 - qk * B
                for c in chunks:
                    if planes:
                        got, blk, f, g = _planar_chunk(kind, B, blk, f, g)
                        for r, (rows, plane, b) in enumerate(got):
                            k = k0 + 64 * part + 8 * c + r
                            assert 0 <= b < unit["exp_rows"]
                            assert rows == {x - k0 // B * R for x in
                                            _packed_rows(kind, B, k)}
                            assert plane == k % B // q
                            assert b == k // B - k0 // B
                        written.append((d, 8 * c))
                    else:
                        got, blk, off = _row_scales(B, blk, off,
                                                    kind == "sideband")
                        for r, b in enumerate(got):
                            k = k0 + 8 * c + r
                            assert b == k // B - k0 // B < unit["exp_rows"]
                        written.append((d, (part * U if H > 1 else 0)
                                        + 8 * c))
            ph += 1
            if ph == H:
                ph, d = 0, d + 1
            ps += 1
            if ps == S:
                ps, u = 0, u + 1
        assert sorted(written) == [(s, r) for s in range(nk)
                                   for r in range(0, 64, 8)], (kind, B)


# (format, transport) of each transport that gemm_any.cu decodes, at the
# blocks 48 and 128 where its packer takes them (pf6 needs a multiple of
# 32), and the side-band format
TWIN_CASES = ([("fp6_e3m2", "pf6", 128)]
              + [(f, t, b) for f, t in (("fp4_e2m1", "pf4"), ("int4", "sb4"),
                                        ("int2", "sb2"),
                                        ("fp6_e3m2", "emi8"),
                                        ("int8", "native"),
                                        ("fp8_e4m3", "native"),
                                        ("fp8_e5m2", "native"),
                                        ("fp16", "native"),
                                        ("bfloat16", "native"),
                                        ("int2", "sideband"))
                 for b in (48, 128)])


@pytest.mark.parametrize("fmt,transport,block", TWIN_CASES)
def test_plain_gemm_twin_matches_jax_at_blocks_48_and_128(fmt, transport,
                                                          block):
    """The port's plain GEMM twin (dequant_matmul_reference, the side-band
    format's dequant_matmul_outlier_reference) against JAX's on the same
    numpy weight and x, bit for bit, at blocks that only gemm_any.cu's
    kernels take on the card (small-integer x and few-bit weight codes keep
    every f32 sum exact in any order)."""
    K, N, M = 300, 96, 5
    rng = np.random.default_rng(block + len(fmt) + len(transport))
    W = (rng.standard_normal((K, N))
         * np.exp(rng.uniform(-2, 2, (1, N)))).astype(np.float32)
    if transport == "native":
        W = (rng.integers(-16, 17, (K, N))
             * 2.0 ** rng.integers(-3, 3, (1, N))).astype(np.float32)
    x = _x(M, K, block)
    if transport == "sideband":
        W.ravel()[rng.integers(0, K * N, K * N // 64)] *= 25.0
        args = (8, 8, "int2", "fp4_e2m1")
        kw = dict(std_dev=2.0, block_size=block, outlier_budget=4, axis=0)
        j = jpk.pack_mx_outlier(jnp.asarray(W), *args, **kw)
        t = tpk.pack_mx_outlier(torch.from_numpy(W), *args, **kw)
        assert dm.block_is_any("sideband", block, t.budget)
        want = np.asarray(j_outlier_ref(jnp.asarray(x), j))
        got = om.dequant_matmul_outlier_reference(torch.from_numpy(x), t)
    else:
        j = jpk.to_serving_layout(jpk.pack_mx(jnp.asarray(W), 8, fmt, block,
                                              axis=0, transport=transport))
        t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, fmt,
                                              block, axis=0,
                                              transport=transport))
        assert dm.block_is_any(dm.sad_decode_params(t)[0], block)
        want = np.asarray(j_reference(jnp.asarray(x), j))
        got = dm.dequant_matmul_reference(torch.from_numpy(x), t)
    np.testing.assert_array_equal(got.numpy(), want)
