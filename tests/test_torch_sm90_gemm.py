"""The host side of the wgmma + TMA GEMM (``csrc/gemm_sm90.cuh``) that the
pf6 and side-band GEMMs run on: its plan (tile, stages, shared memory,
padding of x) at every Llama-3-8B shape, and the zero-padding of x to a
multiple of 8 columns, which must leave the plain versions' results bit for
bit as they are, against the JAX twins on the same numpy inputs. The kernel
itself is held to the plain versions on a card by
tests/test_torch_kernels_gpu.py (``-k sm90``).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
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


def test_plan_pads_ragged_k_and_refuses_other_blocks():
    plan = dm.sm90_plan("pf6", 203, 130, 32)
    assert plan["pad_x"] and plan["k_x"] == 208 and not plan["tma"]
    assert not dm.sm90_plan("sideband", 200, 384, 16, 4)["pad_x"]
    for args in (("pf6", 256, 128, 8), ("sideband", 256, 128, 64, 4),
                 ("sideband", 256, 128, 16, 9), ("pf4", 256, 128, 32)):
        with pytest.raises(ValueError):
            dm.sm90_plan(*args)


def test_plan_mirrors_the_kernel_sources():
    """The plan's constants are the ones the CUDA sources compile with."""
    head = (CSRC / "gemm_sm90.cuh").read_text()
    assert "kBM = 256, kBN = 128, kBK = 64" in head
    assert f"kMaxSmem = {dm.SM90_MAX_SMEM}" in head
    assert "1024 + kBarOff + (2 * STAGES + RAWBUFS) * 8" in head
    pf6 = (CSRC / "dequant_matmul.cu").read_text()
    assert "kStages = 4, kRawBufs = 3" in pf6
    sb = (CSRC / "outlier_matmul.cu").read_text()
    assert "kStages = 3, kRawBufs = MAXB <= 4 ? 3 : 2;" in sb


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
