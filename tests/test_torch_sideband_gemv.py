"""The side-band GEMV's host side and its arithmetic, on the CPU.

- ``outlier_gemv_plan`` (ring stages, shared memory, K split) at every
  Llama-3-8B shape, every budget 0-8 and the blocks 8-128: within the
  227 KB a block may use, a split count and stage size that do not depend
  on M, every K-block in exactly one split; a plan for the small blocks
  the packer also takes; its constants are the kernel's.
- The kernel's decomposition of the weight, emulated in float32: the
  inlier sweep (code · 2^(se - fold), bf16) plus, for each row that slots
  name, (the bf16 sum of the inlier and its slots in slot order) minus the
  inlier. Inlier plus correction is the plain twin's dense bf16 weight bit
  for bit (duplicate positions included), and x against it agrees with the
  JAX kernel (Pallas interpret mode) within the GEMV tolerance, 1e-5 of
  max |kernel|: exact products, f32 sums in another order.

The CUDA kernel itself is held to the twin on a card by
tests/test_torch_kernels_gpu.py (``-k sideband_gemv``).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul_outlier as j_outlier)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om

CSRC = Path(om.__file__).resolve().parent / "csrc"
# Llama-3-8B's linears (gate and up unfused, and fused) and the lm_head
SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gate": (4096, 14336),
          "gate_up": (4096, 28672), "down": (14336, 4096),
          "lm_head": (4096, 128256)}
PLAN_M = (1, 2, 3, 5, 8, 64, 130, 255)


def _check(plan, N, K, B, M):
    NB = -(-K // B)
    sb, nbps = plan["stage_blocks"], plan["split_blocks"]
    assert plan["smem_bytes"] <= 232448
    assert 2 <= plan["stages"] <= 8
    assert sb in (1, 2, 4, 8, 16, 32) and nbps % sb == 0
    assert plan["ksplit"] * nbps >= NB > (plan["ksplit"] - 1) * nbps
    assert nbps * B <= 1024 or nbps == sb            # x of a split: <= 32 KB
    assert plan["rows_per_group"] * (32 // sb) >= B  # every row of a block
    assert plan["rows_per_tile"] == (8 if M >= 8 else 4 if M >= 4
                                     else 2 if M >= 2 else 1)
    assert plan["m_groups"] * plan["rows_per_tile"] >= M
    assert plan["col_tiles"] == -(-N // 128)
    assert plan["tiles"] == (plan["m_groups"] * plan["col_tiles"]
                             * plan["ksplit"])
    assert plan["ctas"] == min(plan["tiles"], 132)
    assert plan["tma"] == (N % 16 == 0 and sb * B <= 256)


@pytest.mark.parametrize("block", [8, 16, 24, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("lin", sorted(SHAPES))
def test_gemv_plan_fits_and_its_split_ignores_m(lin, block):
    K, N = SHAPES[lin]
    for budget in range(9):
        plans = [om.outlier_gemv_plan(N, K, block, budget, M)
                 for M in PLAN_M]
        for M, plan in zip(PLAN_M, plans):
            _check(plan, N, K, block, M)
        split = {(p["ksplit"], p["split_blocks"], p["stage_blocks"],
                  p["rows_per_group"]) for p in plans}
        assert len(split) == 1, split


def test_gemv_plan_at_the_main_path_shape():
    """gate_up, block 16, 4 slots, M = 8: 8 K-blocks (128 rows) a stage,
    the ring as deep as it fits (4 stages of 38 KB), 4 splits of 1024 rows
    and 896 tiles over 132 persistent CTAs."""
    plan = om.outlier_gemv_plan(28672, 4096, 16, 4, 8)
    assert plan == {"rows_per_tile": 8, "stage_blocks": 8,
                    "rows_per_group": 4, "ksplit": 4, "split_blocks": 64,
                    "stage_bytes": 128 * (128 + 16 + 160), "stages": 4,
                    "smem_bytes": 384 + 32768 + 40960 + 4 * 38912,
                    "m_groups": 1, "col_tiles": 224, "tiles": 896,
                    "ctas": 132, "tma": True}


@pytest.mark.parametrize("block", [2, 3, 4, 5, 6, 7, 12, 20, 200])
def test_gemv_plan_takes_the_packer_s_other_blocks(block):
    """The packer takes any block (budget <= block): every one has a plan,
    with plain copies where a stage's rows exceed one TMA box."""
    for budget in range(min(block, 8) + 1):
        for M in (1, 8, 200):
            plan = om.outlier_gemv_plan(4096, 1000, block, budget, M)
            _check(plan, 4096, 1000, block, M)
    with pytest.raises(ValueError, match="budget 9"):
        om.outlier_gemv_plan(4096, 1000, block, 9, 8)


def test_gemv_plan_mirrors_the_kernel_source():
    src = (CSRC / "outlier_matmul.cu").read_text()
    for line in ("constexpr int kTN = 128;", "constexpr int kRowGroups = 32;",
                 "constexpr int kBarBytes = 256;",
                 "constexpr int kAlign = 128;",
                 "return (8 + 2) * mt * kTN * 4;",
                 "return kAlign + kBarBytes + p.x_pad + red_bytes(mt)\n"
                 "         + p.stages * p.stage_bytes;",
                 "p.x_pad = (mt * nbps * B * 4 + 127) / 128 * 128;",
                 "p.stage_bytes = gemv::kTN * (sb * B + 2 * sb + 5 * sb * "
                 "budget);",
                 "p.tma = N % 16 == 0 && sb * B <= 256",
                 "const int mt = M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;"):
        assert line in src, line
    assert om.GEMV_TN == 128 and om.GEMV_SMS == 132


# ---------------------------------------------------------------------------
# the kernel's weight decomposition
# ---------------------------------------------------------------------------
def _exp2(e):
    return torch.exp2(torch.clamp(e, -126, 127).to(torch.float32))


def _bf16(v):
    return v.to(torch.bfloat16).to(torch.float32)


def kernel_parts(w):
    """(inliers, corrections), (K, N) float32, as the GEMV forms them: the
    sweep's code · 2^(se - fold) in bf16, and for each row that slots name
    (its first slot) bf16(inlier + the row's slots in slot order) -
    bf16(inlier); the outlier code scaled by 2^(seo - se) with no fold, as
    the TPU kernel."""
    inl = w.inlier
    B = inl.block_size
    fold = om._scale_fold(inl.elem_format)
    codes = inl.codes.to(torch.float32)
    NB, N = inl.scale_exp.shape
    se = inl.scale_exp.to(torch.int32)
    sc_in = _exp2(se - fold)
    sc_out = _exp2(w.out_scale_exp.to(torch.int32) - se)
    inliers = _bf16(codes * sc_in.repeat_interleave(B, 0))
    corr = torch.zeros_like(inliers)
    pos = w.out_pos.tolist()
    oc = w.out_codes.to(torch.float32)
    for nb in range(NB):
        for n in range(N):
            pr = pos[nb][n]
            for s1, r in enumerate(pr):
                if not 0 <= r < B or r in pr[:s1]:
                    continue
                v0 = codes[nb * B + r, n] * sc_in[nb, n]
                v = v0.clone()
                for s2 in range(s1, len(pr)):
                    if pr[s2] == r:
                        v = v + oc[nb, n, s2] * sc_out[nb, n]
                corr[nb * B + r, n] = _bf16(v) - _bf16(v0)
    return inliers, corr


def _pair(ifmt, ofmt, K, N, block, budget, seed):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((K, N))
         * np.exp(rng.uniform(-1, 1, (1, N)))).astype(np.float32)
    W.ravel()[rng.integers(0, K * N, K * N // 16)] *= 25.0
    kw = dict(std_dev=2.0, block_size=block, outlier_budget=budget, axis=0)
    return (jpk.pack_mx_outlier(jnp.asarray(W), 8, 8, ifmt, ofmt, **kw),
            tpk.pack_mx_outlier(torch.from_numpy(W), 8, 8, ifmt, ofmt,
                                **kw))


CASES = [("int2", "fp4_e2m1", 16, 4), ("int2", "fp4_e2m1", 8, 8),
         ("int2", "fp4_e2m1", 32, 1), ("fp6_e3m2", "fp8_e4m3", 16, 2),
         ("fp6_e3m2", "fp8_e4m3", 48, 8), ("int2", "fp4_e2m1", 64, 4)]


@pytest.mark.parametrize("ifmt,ofmt,block,budget", CASES)
def test_inliers_plus_corrections_are_the_twin_s_weight(ifmt, ofmt, block,
                                                         budget):
    _, t = _pair(ifmt, ofmt, 96, 40, block, budget, seed=block + budget)
    inliers, corr = kernel_parts(t)
    dense = tpk.dequantize_mx_outlier(t, torch.bfloat16).float()
    assert corr.abs().sum() > 0                      # slots were taken
    K = dense.shape[0]
    assert torch.equal(inliers[:K] + corr[:K], dense)


def test_duplicate_positions_add_in_slot_order():
    """Two slots naming one row: the row's weight is the inlier plus both,
    in slot order, rounded once (the twin's), corrected once."""
    _, t = _pair("int2", "fp4_e2m1", 64, 24, 16, 4, seed=5)
    pos = t.out_pos.clone()
    pos[..., 1] = torch.where(pos[..., 0] >= 0, pos[..., 0], pos[..., 1])
    t = dataclasses.replace(t, out_pos=pos)
    inliers, corr = kernel_parts(t)
    dense = tpk.dequantize_mx_outlier(t, torch.bfloat16).float()
    K = dense.shape[0]
    assert torch.equal(inliers[:K] + corr[:K], dense)


# the JAX kernel's tiles take blocks that divide 128 (block 48 goes to the
# twin's weight test above)
JAX_CASES = [c if c[2] != 48 else c[:2] + (32,) + c[3:] for c in CASES]


@pytest.mark.parametrize("ifmt,ofmt,block,budget", JAX_CASES)
@pytest.mark.parametrize("M", [1, 5])
def test_decomposed_gemv_matches_the_jax_kernel(ifmt, ofmt, block, budget,
                                                M):
    j, t = _pair(ifmt, ofmt, 96, 40, block, budget, seed=3 * block + M)
    x = np.random.default_rng(M).standard_normal((M, 96)).astype(np.float32)
    inliers, corr = kernel_parts(t)
    xb = torch.from_numpy(x).to(torch.bfloat16).to(torch.float64)
    got = (xb @ inliers[:96].double() + xb @ corr[:96].double()).numpy()
    want = np.asarray(j_outlier(jnp.asarray(x), j, interpret=True),
                      np.float64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
