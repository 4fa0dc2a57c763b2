"""The tensor-core GEMVs' host side and their arithmetic, on the CPU.

- ``dequant_matmul.gemv_plan`` (``csrc/dequant_gemv.cu``'s ``gemv_tc``) for
  every decode, every block the packers take and the Llama-3-8B shapes
  plus the lm_head: within the 227 KB (232,448 bytes) a block may use, a K
  split and stage that do not depend on M, every K-block in exactly one
  split; ``gemv_route`` names a kernel for every block; the plan's
  constants and formulas are the kernel source's.
- The K order of an mma step (``kpos``, mirrored here from the kernel) is a
  permutation of each block, and it is the order in which ``decode_step``
  reads the packed rows.
- A CPU model of ``gemv_tc``'s arithmetic (per K-block dots of the bf16 x
  with the block's unscaled decoded weights, then the block's 2^(se -
  fold), the f32 sums added split by split in the plan's order) agrees
  with the JAX ``dequant_matmul_sad`` (Pallas interpret mode, as
  tests/test_pallas_kernels.py runs it) within the GEMV tolerance, 1e-5 of
  max |kernel|, for every decode: exact products, f32 sums in another
  order.
- ``outlier_matmul.nb_gemv_plan`` (``csrc/nb_matmul.cu``'s ``nb_gemv``)
  likewise, and a CPU model of its arithmetic (the bf16 weight, f32 sums
  restarted every 128-column stage and added up) against the JAX
  ``dequant_matmul_nb``, within 1e-5.

The CUDA kernels themselves are held to their twins on a card by
tests/test_torch_kernels_gpu.py (``-k "tc_gemv or nb_gemv"``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul_nb as j_nb, dequant_matmul_sad as j_sad)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

CSRC = Path(dm.__file__).resolve().parent / "csrc"
# Llama-3-8B's linears (K, N) and the lm_head
SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
          "down": (14336, 4096), "lm_head": (4096, 128256)}
PLAN_M = (1, 7, 8, 9, 16, 33, 64)
# the blocks the packers make: the multiples of 16 take gemv_tc (up to 256
# for the one-byte decodes, 128 for the 16-bit containers, whose ring of two
# 256-row stages would not fit), the rest gemv_any.cu's kernel
TC_BLOCKS = (16, 32, 48, 64, 96, 128, 256)


def tc_blocks(decode):
    return TC_BLOCKS[:-1] if decode in ("bf16", "fp16") else TC_BLOCKS
CC_BLOCKS = (2, 4, 6, 8, 12, 20, 24, 40, 100)
# (format, transport, block) of every decode of _DECODES
DECODE_CASES = [("fp6_e3m2", "emi8", 32), ("int8", "native", 32),
                ("int4", "sb4", 32), ("int2", "sb2", 16),
                ("fp4_e2m1", "pf4", 32), ("fp6_e3m2", "pf6", 32),
                ("fp6_e2m3", "pf6", 64), ("bfloat16", "native", 32),
                ("fp16", "native", 16), ("fp8_e4m3", "native", 32),
                ("fp8_e5m2", "native", 16), ("fp6_e3m2", "native", 64),
                ("int4", "sb4", 64), ("fp6_e3m2", "emi8", 16)]


def _check_plan(plan, decode, N, K, B, M):
    NB = -(-K // B)
    sb, nbps = plan["stage_blocks"], plan["split_blocks"]
    assert plan["smem_bytes"] <= 232448
    assert 2 <= plan["stages"] <= 8
    assert nbps % sb == 0
    assert plan["ksplit"] * nbps >= NB > (plan["ksplit"] - 1) * nbps
    rows = tpk.transport_rows_per_block(dm._TRANSPORT_OF[decode], B)
    cb = 2 if decode in ("bf16", "fp16") else 1
    assert sb * rows <= 256                         # one TMA box of rows
    assert sb * rows * cb <= 128 or sb == 1
    assert plan["n8_tiles"] * 8 >= M > plan["n8_tiles"] * 4 or M <= 8
    assert plan["col_tiles"] == -(-N // 256)
    assert plan["tiles"] == plan["col_tiles"] * plan["ksplit"]
    assert plan["ctas"] == min(plan["tiles"], 132)
    assert plan["tma"] == (N % 16 == 0)
    assert plan["x_pitch"] == nbps * B * 2 + 16
    x_bytes = -(-8 * plan["n8_tiles"] * plan["x_pitch"] // 128) * 128
    assert plan["smem_bytes"] == (2048 + x_bytes
                                  + plan["stages"] * plan["stage_bytes"])


@pytest.mark.parametrize("decode", sorted(dm._DECODES))
@pytest.mark.parametrize("lin", sorted(SHAPES))
def test_gemv_plan_fits_and_its_split_ignores_m(decode, lin):
    K, N = SHAPES[lin]
    for B in tc_blocks(decode):
        assert dm.gemv_route(decode, B) == "tc"
        plans = [dm.gemv_plan(decode, N, K, B, M) for M in PLAN_M]
        for M, plan in zip(PLAN_M, plans):
            _check_plan(plan, decode, N, K, B, M)
        split = {(p["ksplit"], p["split_blocks"], p["stage_blocks"],
                  p["stage_bytes"]) for p in plans}
        assert len(split) == 1, split


@pytest.mark.parametrize("decode", sorted(dm._DECODES))
def test_gemv_route_names_a_kernel_for_every_block(decode):
    """Every block 1..256 has a kernel: gemv_tc for the multiples of 16
    that it takes, gemv_any.cu's kernel ("any", counted apart) for the
    others of whole packed rows, gemv_partial ("cc") for what is left (pf4
    and pf6, whose packers make multiples of 16 alone, and sb4 and sb2 at
    blocks no packer makes); no tc block lacks a plan, and another block
    has none."""
    whole = dm._FIELDS.get(decode, 1)
    for B in range(1, 257):
        route = dm.gemv_route(decode, B)
        counter = dm.gemv_counter(decode, B)
        assert route != "tc" or B % 16 == 0
        if B in tc_blocks(decode):
            assert route == "tc"
        if route != "tc":
            want = ("any" if decode in dm._ANY_DECODES and B % whole == 0
                    else "cc")
            assert route == want, (B, route)
        assert counter == f"dequant_gemv_{decode}" + {
            "tc": "", "any": "_any", "cc": "_cc"}[route]
        assert counter in dm.launch_counts
        if route == "tc":
            dm.gemv_plan(decode, 1040, 520, B, 8)
        else:
            with pytest.raises(ValueError, match="no tensor-core"):
                dm.gemv_plan(decode, 1040, 520, B, 8)
    for B in CC_BLOCKS:
        assert dm.gemv_route(decode, B) == (
            "any" if decode in dm._ANY_DECODES and B % whole == 0 else "cc")
    with pytest.raises(ValueError, match="unknown GEMV decode"):
        dm.gemv_route("emi8m", 16)


def test_gemv_plan_at_the_main_path_shape():
    """emi8 at gate_up, block 32, M = 8: 4 blocks (128 rows) a stage in two
    16 KB sub-tiles and a 1 KB exponent box, 8 splits of 512 rows, six
    stages, 896 tiles over 132 persistent CTAs."""
    plan = dm.gemv_plan("emi8", 28672, 4096, 32, 8)
    assert plan == {"n8_tiles": 1, "stage_blocks": 4, "sub_stride": 16384,
                    "se_off": 32768, "stage_bytes": 33792, "ksplit": 8,
                    "split_blocks": 16, "x_pitch": 1040, "stages": 6,
                    "smem_bytes": 2048 + 8320 + 6 * 33792,
                    "col_tiles": 112, "tiles": 896, "ctas": 132,
                    "tma": True}


def test_gemv_plan_mirrors_the_kernel_source():
    src = (CSRC / "dequant_gemv.cu").read_text()
    hdr = (CSRC / "gemv_tc.cuh").read_text()
    s8 = (CSRC / "dequant_gemv_s8.cu").read_text()
    # the stage layout and the ring's copier are gemv_tc.cuh's, shared with
    # the W8A8 GEMV; the x pitch is each kernel's own
    for line in ("p.x_pitch = p.nbps * p.B * 2 + 16;", "p.tma = N % 16 == 0",
                 "stage_layout<mxq::code_bytes<D>()>(p);"):
        assert line in src, line
    for line in ("p.x_pitch = p.nbps * p.B + 16;", "p.tma = N % 16 == 0",
                 "stage_layout<1>(p);"):
        assert line in s8, line
    for line in ("constexpr int kTN = 256;", "constexpr int kSubW = 128;",
                 "p.sub_stride = align_up(p.sb * p.rows * kSubW, 1024);",
                 "p.se_off = 2 * CB * p.sub_stride;",
                 "p.stage_bytes = p.se_off + align_up(p.sb * kTN, 1024);",
                 "return kAlign + kBarBytes + p.stages * p.stage_bytes\n"
                 "         + align_up(8 * nt * p.x_pitch, 128);"):
        assert line in hdr, line
    for line in ("constexpr int kAlign = 1024;",
                 "constexpr int kBarBytes = 1024;",
                 "constexpr int kMaxStages = 8;",
                 "return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;"):
        assert line in hdr, line
    assert dm.GEMV_TC_TN == 256 and dm.GEMV_SMS == 132
    assert dm.GEMV_MAX_STAGES == 8 and dm._GEMV_FIXED_SMEM == 2048
    assert [dm.gemv_n8_tiles(M) for M in (1, 8, 9, 16, 17, 32, 33, 64)] == \
        [1, 1, 2, 2, 4, 4, 8, 8]


# ---------------------------------------------------------------------------
# the K order of an mma step
# ---------------------------------------------------------------------------
def kpos(decode, kb, B):
    """dequant_gemv.cu's kpos: the mma-order position of K row kb of a
    block."""
    F = {"sb4": 2, "pf4": 2, "sb2": 4, "pf6": 4}.get(decode, 1)
    if F == 1:
        return kb
    if F == 2:
        P = B // 2
        h, p = divmod(kb, P)
        r = p & 7
        return 16 * (p >> 3) + (r & 6) + h + 8 * (r & 1)
    P = B // 4
    f, p = divmod(kb, P)
    return 16 * (p >> 2) + 2 * (p & 3) + (f & 1) + 8 * (f >> 1)


def step_rows(decode, B):
    """{mma position: K row} as decode_step reads them: for step s, thread
    t, value i (K position 16s + 2t + (i & 1) + 8 (i >> 1)), the packed
    row and field it decodes, mapped to their K row by the transport's
    interleave (packing._subbyte_pack: field f of packed row p is K row
    p + f * B / F; pf6's group g, field f is K row g + f * B / 4)."""
    out = {}
    for s in range(B // 16):
        for t in range(4):
            for i in range(4):
                h, q = i & 1, i >> 1
                pos = 16 * s + 2 * t + h + 8 * q
                if decode in ("sb4", "pf4"):
                    krow = 8 * s + 2 * t + q + h * (B // 2)
                elif decode in ("sb2", "pf6"):
                    krow = 4 * s + t + i * (B // 4)
                else:
                    krow = 16 * s + 2 * t + h + 8 * q
                out[pos] = krow
    return out


@pytest.mark.parametrize("decode", sorted(dm._DECODES))
def test_mma_order_is_a_permutation_read_by_decode_step(decode):
    for B in tc_blocks(decode):
        pos = [kpos(decode, kb, B) for kb in range(B)]
        assert sorted(pos) == list(range(B))
        rows = step_rows(decode, B)
        assert all(pos[krow] == p for p, krow in rows.items())


def test_kpos_mirrors_the_kernel_source():
    src = (CSRC / "dequant_gemv.cu").read_text()
    for line in ("return 16 * (p >> 3) + (r & 6) + h + 8 * (r & 1);",
                 "return 16 * (p >> 2) + 2 * (p & 3) + (f & 1) + 8 * (f >> 1);",
                 "row_word(sub, brow + 8 * s + 2 * t + q, byte);",
                 "row_word(sub, brow + 4 * s + t, byte);",
                 "const int gi = brow + 4 * s + t;",
                 "const int row = brow + 16 * s + 2 * t + (i & 1) + 8 * "
                 "(i >> 1);"):
        assert line in src, line


# ---------------------------------------------------------------------------
# the arithmetic against the JAX kernel
# ---------------------------------------------------------------------------
def _weights(K, N, fmt, seed):
    rng = np.random.default_rng(seed)
    if fmt == "bfloat16":          # block exponents above the 2^-126 floor
        return (rng.standard_normal((K, N)) * 8.0).astype(np.float32)
    return (rng.standard_normal((K, N))
            * np.exp(rng.uniform(-2, 2, (1, N)))).astype(np.float32)


def _pair(fmt, transport, B, K, N, seed):
    W = _weights(K, N, fmt, seed)
    j = jpk.to_serving_layout(jpk.pack_mx(jnp.asarray(W), 8, fmt, B, axis=0,
                                          transport=transport))
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, fmt, B,
                                          axis=0, transport=transport))
    return j, t


def _exp2(e):
    return torch.exp2(torch.clamp(e, -126, 127).to(torch.float32))


def tc_gemv_model(x, w, M):
    """gemv_tc's arithmetic in float32: for each split of the plan, for
    each K-block, the dot of the bf16 x with the block's decoded weights
    before the scale (in the mma step's K order), times the column's
    2^(se - fold), added to the split's sum; the splits added in order."""
    decode, fold, _, _ = dm.sad_decode_params(w)
    NB, _, N = w.codes.shape
    B = w.block_size
    K = x.shape[1]
    plan = dm.gemv_plan(decode, N, K, B, M)
    # the twin's bf16 weight (the fp16 container rounded to bf16, as the
    # kernel's decode), (K, N)
    dense = tpk.dequantize_mx(w, dtype=torch.bfloat16).float()
    dense = torch.nn.functional.pad(dense, (0, 0, 0, NB * B - dense.shape[0]))
    se = w.scale_exp.to(torch.int32) - fold
    exact = torch.exp2(se.to(torch.float32))                    # (NB, N)
    codes = dense / exact.repeat_interleave(B, 0)       # the decoded values
    xb = torch.nn.functional.pad(x.to(torch.bfloat16).to(torch.float32),
                                 (0, NB * B - K))
    perm = torch.tensor([kpos(decode, kb, B) for kb in range(B)])
    order = torch.empty_like(perm)
    order[perm] = torch.arange(B)                # mma position -> K row
    out = torch.zeros((M, N), dtype=torch.float32)
    for sp in range(plan["ksplit"]):
        part = torch.zeros((M, N), dtype=torch.float32)
        for nb in range(sp * plan["split_blocks"],
                        min(NB, (sp + 1) * plan["split_blocks"])):
            rows = nb * B + order
            acc = xb[:, rows] @ codes[rows]
            part += acc * _exp2(se[nb])[None, :]
        out += part
    return out


@pytest.mark.parametrize("fmt,transport,B", DECODE_CASES)
@pytest.mark.parametrize("M", [1, 9])
def test_tc_gemv_model_matches_the_jax_kernel(fmt, transport, B, M):
    K, N = 160, 96
    j, t = _pair(fmt, transport, B, K, N, seed=B + M)
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    got = tc_gemv_model(torch.from_numpy(x), t, M).double().numpy()
    want = np.asarray(j_sad(jnp.asarray(x), j, interpret=True), np.float64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the NB GEMV
# ---------------------------------------------------------------------------
NB_PLAN_M = (1, 8, 9, 64, 65, 200, 255)


def _check_nb_plan(plan, Np, K, budget, M):
    assert plan["smem_bytes"] <= 232448
    assert 2 <= plan["stages"] <= 8
    stages = -(-K // 128)
    assert plan["ksplit"] * plan["split_stages"] >= stages > (
        plan["ksplit"] - 1) * plan["split_stages"]
    assert plan["stage_bytes"] == -(-(6144 + 1024 * budget) // 1024) * 1024
    assert plan["n8_tiles"] == dm.gemv_n8_tiles(M)
    assert plan["m_groups"] * 8 * plan["n8_tiles"] >= M
    assert plan["n_tiles"] == -(-Np // 128)
    assert plan["tiles"] == (plan["m_groups"] * plan["n_tiles"]
                             * plan["ksplit"])
    assert plan["ctas"] == min(plan["tiles"], 132)
    assert plan["tma"] == (K % 16 == 0)
    x_bytes = -(-8 * plan["n8_tiles"] * plan["x_pitch"] // 128) * 128
    assert plan["smem_bytes"] == (2048 + 8 * 2048 + x_bytes
                                  + plan["stages"] * plan["stage_bytes"])


@pytest.mark.parametrize("lin", sorted(SHAPES))
def test_nb_gemv_plan_fits_and_its_split_ignores_m(lin):
    K, N = SHAPES[lin]
    Np = -(-N // 16) * 16
    for budget in range(18):
        plans = [om.nb_gemv_plan(Np, K, budget, M) for M in NB_PLAN_M]
        for M, plan in zip(NB_PLAN_M, plans):
            _check_nb_plan(plan, Np, K, budget, M)
        assert len({(p["ksplit"], p["split_stages"]) for p in plans}) == 1


def test_nb_gemv_plan_mirrors_the_kernel_source():
    src = (CSRC / "nb_matmul.cu").read_text()
    for line in ("constexpr int kK = 128;", "constexpr int kBlocks = 8;",
                 "constexpr int kSeOff = 4 * kBlocks * kK;",
                 "constexpr int kObOff = kSeoOff + kBlocks * kK;",
                 "constexpr int kSlotBytes = kBlocks * kK;",
                 "constexpr int kTileBytes = kRows * 128;",
                 "return align_up(kObOff + budget * kSlotBytes, 1024);",
                 "+ (kConsumers / 32) * kTileBytes + align_up(8 * nt * "
                 "p.x_pitch, 128);",
                 "p.x_pitch = sps * gv::kK * 2 + 16;",
                 "p.tma = K % 16 == 0"):
        assert line in src, line
    assert (om.NB_GEMV_K, om.NB_GEMV_BLOCKS, om._NB_GEMV_SLOT0,
            om._NB_GEMV_SLOT, om._NB_GEMV_TILE) == (128, 8, 6144, 1024,
                                                    2048)


def nb_gemv_model(x, w, M):
    """nb_gemv's arithmetic in float32: the bf16 weight (exact: int2 and
    fp4 values times powers of two), the dot restarted every 128-column
    stage and added to the split's sum, the splits added in order."""
    K = x.shape[1]
    Np = 4 * w.codes.shape[0]
    plan = om.nb_gemv_plan(Np, K, w.budget, M)
    dense = tpk.dequantize_outlier_nb(w, dtype=torch.bfloat16).float()
    xb = x.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((M, dense.shape[0]), dtype=torch.float32)
    span = plan["split_stages"] * 128
    for sp in range(plan["ksplit"]):
        part = torch.zeros_like(out)
        for k0 in range(sp * span, min(K, (sp + 1) * span), 128):
            part += xb[:, k0:k0 + 128] @ dense[:, k0:k0 + 128].T
        out += part
    return out


@pytest.mark.parametrize("cap,M,K", [(2, 3, 128), (1, 8, 384), (2, 9, 200)])
def test_nb_gemv_model_matches_the_jax_kernel(cap, M, K):
    from test_torch_outlier_matmul import _nb_pair

    j, t = _nb_pair(cap, 160, K, cap)
    x = np.random.default_rng(M).standard_normal((M, K)).astype(np.float32)
    got = nb_gemv_model(torch.from_numpy(x), t, M).double().numpy()
    want = np.asarray(j_nb(jnp.asarray(x), j, interpret=True), np.float64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
