"""The host side of the wgmma + TMA GEMM (``csrc/gemm_sm90.cuh``) that the
pf6, pf4, sb4, sb2, fp16-container, emi8/emi8m, int8-container, float8,
side-band and compact-NB GEMMs run on: its plan (tile,
stages, shared memory, padding of x) at every Llama-3-8B shape and every
block it is compiled for; the routing of every block that the JAX packers
take to a hand-written kernel (the sm90 loop or ``gemm_tile``); and the
zero-padding of x to a multiple of 8 columns, which must leave the plain
versions' results bit for bit as they are, against the JAX twins on the
same numpy inputs. The kernels themselves are held to the plain versions
on a card by tests/test_torch_kernels_gpu.py (``-k sm90``).
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


# (sm90_plan arguments) that no sm90 kernel takes: the blocks that do not
# divide the 64-deep K step (sb4 48 and 128, sb2 12 and 48 among them), pf6
# below 16, emi8, int8 and float8 at block 2 (a 12 KB raw step leaves no
# 4-stage ring), the
# side-band format at block 8 with 8 slots and the NB format above 16
# slots (gemm_tile takes them), and a side-band budget above 8 (nothing
# does)
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
    plan = dm.sm90_plan("pf6", 203, 130, 32)
    assert plan["pad_x"] and plan["k_x"] == 208 and not plan["tma"]
    assert not dm.sm90_plan("sideband", 200, 384, 16, 4)["pad_x"]
    with pytest.raises(ValueError):
        dm.sm90_plan(*args)
    kind, block, budget = args[0], args[3], (args[4:] or (0,))[0]
    if kind != "sideband" or budget <= dm.MAX_OUTLIER_BUDGET:
        assert dm.gemm_route(kind, block, budget) == "tile"
    else:
        with pytest.raises(ValueError):
            dm.gemm_route(kind, block, budget)


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
                  if dm.gemm_route("sideband", b, s) == "sm90")
    assert built == want


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


@pytest.mark.parametrize("block", [2, 4, 8, 16, 32, 48, 64, 128])
@pytest.mark.parametrize("name", sorted(ROUTED))
def test_gemm_route_names_a_kernel_for_every_block_the_packers_take(
        name, block):
    """Every block that the JAX packer accepts routes to a hand-written
    kernel: the sm90 loop, whose plan then fits, or gemm_tile; and the
    launch counter of that kernel exists."""
    if not _jax_packs(name, block):
        assert block % PACKER_MULTIPLE[name]
        return
    if name.startswith("sideband"):
        budget = 8 if name == "sideband8" else 4
        route = dm.gemm_route("sideband", block, budget)
        assert om.gemm_counter(block, budget) in om.launch_counts
        if route == "sm90":
            dm.sm90_plan("sideband", 4096, 4096, block, budget)
        want = block in (8, 16, 32, 64) and (block, budget) != (8, 8)
    else:
        decode = {"emi8_fp4": "emi8", "emi8m": "emi8", "int8": "native",
                  "fp6_native": "fp8_e4m3"}.get(name, name)
        route = dm.gemm_route(decode, block)
        assert dm.gemm_counter(decode, block) in dm.launch_counts
        if route == "sm90":
            plan = dm.sm90_plan(decode, 4096, 4096, block)
            assert plan["smem_bytes"] <= dm.SM90_MAX_SMEM
        want = block in dm.SM90_BLOCKS.get(decode, ())
    assert route == ("sm90" if want else "tile")


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
    assert dm.gemm_counter(kind, 48) == f"dequant_matmul_{kind}_tile"
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
    assert dm.gemm_counter("emi8", 48) == "dequant_matmul_emi8_tile"
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
