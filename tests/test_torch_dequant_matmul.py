"""y = x @ dequant(W): the port's plain twin against the JAX kernels run as
the JAX tests run them (Pallas interpret mode) and the launch-grid
arithmetic that surrounds the CUDA kernels. The kernels themselves are held
against the twin on a card by tests/test_torch_kernels_gpu.py.

Tolerances (relative to max |reference|):
- GEMV vs JAX ``dequant_matmul_sad``: 1e-5, the bound of
  tests/test_pallas_kernels.py::test_sad_matches_reference. Both sum exact
  float32 products of bf16-rounded x and the emi8 integers; only the
  summation order differs.
- GEMM vs JAX ``dequant_matmul``: 2e-3, the bound of
  tests/test_pallas_kernels.py::test_dq_matmul_prefill_fused_decode (bf16
  MMA with float32 accumulation).
- plain twin vs JAX twin: 1e-6, the same dequantized bf16 weights and the
  same exact products summed in float32 by two libraries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul as j_dequant_matmul,
    dequant_matmul_reference as j_reference,
    dequant_matmul_sad as j_sad,
)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm


def _pair(K, N, seed, fmt="fp6_e3m2", scale=1.0):
    """The same weight packed by both packages (serving layout, emi8)."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((K, N)) * scale
         * np.exp(rng.uniform(-2, 2, (1, N)))).astype(np.float32)
    j = jpk.to_serving_layout(jpk.pack_mx(jnp.asarray(W), 8, fmt, 32, axis=0,
                                          transport="emi8"))
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, fmt, 32,
                                          axis=0, transport="emi8"))
    return j, t


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _x(M, K, seed):
    return np.random.default_rng(seed).standard_normal((M, K)
                                                       ).astype(np.float32)


@pytest.mark.parametrize("M", [1, 3, 8, 64])
@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1"])
def test_gemv_twin_matches_jax_sad(M, fmt):
    j, t = _pair(256, 384, M, fmt)
    x = _x(M, 256, 100 + M)
    y_t = dm.dequant_gemv(torch.from_numpy(x), t).numpy()
    y_j = np.asarray(j_sad(jnp.asarray(x), j, interpret=True))
    assert y_t.shape == (M, 384)
    assert _rel(y_t, y_j) < 1e-5
    assert _rel(y_t, j_reference(jnp.asarray(x), j)) < 1e-6


def test_gemv_twin_ragged_shape():
    j, t = _pair(200, 130, 5)
    x = _x(3, 200, 6)
    y_t = dm.dequant_matmul(torch.from_numpy(x), t).numpy()
    y_j = np.asarray(j_sad(jnp.asarray(x), j, interpret=True))
    assert y_t.shape == (3, 130)
    assert _rel(y_t, y_j) < 1e-5


@pytest.mark.parametrize("M", [128, 513])
def test_gemm_twin_matches_jax_prefill_kernel(M):
    j, t = _pair(256, 384, M, scale=0.5)
    x = _x(M, 256, M)
    y_t = dm.dequant_matmul(torch.from_numpy(x), t).numpy()
    y_j = np.asarray(j_dequant_matmul(jnp.asarray(x), j, interpret=True))
    assert _rel(y_t, y_j) < 2e-3
    assert _rel(y_t, j_reference(jnp.asarray(x),
                                 jpk.from_serving_layout(j))) < 1e-6


def test_batched_input_and_out_dtype():
    j, t = _pair(128, 256, 9)
    x = np.random.default_rng(9).standard_normal((2, 3, 128)
                                                 ).astype(np.float32)
    y = dm.dequant_matmul(torch.from_numpy(x), t, out_dtype=torch.bfloat16)
    assert y.shape == (2, 3, 256) and y.dtype == torch.bfloat16
    want = np.asarray(j_reference(jnp.asarray(x), j, out_dtype=jnp.float32))
    assert _rel(y.float().numpy(), want) < 2 ** -8


def test_cpu_path_launches_no_kernel():
    _, t = _pair(64, 64, 0)
    dm.reset_launch_counts()
    dm.dequant_matmul(torch.zeros(4, 64), t)
    dm.dequant_matmul(torch.zeros(100, 64), t)
    assert {"dequant_gemv_emi8", "dequant_matmul_emi8"} <= set(
        dm.launch_counts)
    assert not any(dm.launch_counts.values())


@pytest.mark.parametrize("K,N", [(4096, 6144), (4096, 4096), (4096, 28672),
                                 (14336, 4096), (4096, 128256), (200, 130)])
def test_gemv_ksplit_covers_k_and_ignores_m(K, N):
    NB = -(-K // 32)
    ks, per = dm.gemv_ksplit(N, NB)
    assert ks * per >= NB > (ks - 1) * per          # every block, once
    assert per >= min(NB, 4)     # partials of 8 rows: <= 1/4 of the codes


def test_unported_transport_has_no_kernel():
    """The float8 containers have a CUDA decode of their own, fold 0 (JAX
    sends 2-D float8 codes to its native2d kernel); the emi8 decode keeps
    the format's field split and fold."""
    W = torch.randn(64, 32)
    p = tpk.pack_mx(W, 8, "fp8_e4m3", 32, axis=0)
    assert dm.sad_decode_params(p) == ("fp8_e4m3", 0, 0, 0)
    assert dm.sad_decode_params(tpk.to_serving_layout(p))[0] == "fp8_e4m3"
    assert dm.sad_decode_params(tpk.pack_mx(
        W, 8, "fp6_e3m2", 32, axis=0, transport="emi8")) == ("emi8", 4, 4, 0)


def _edge_pair():
    """A weight with one block column of tiny values whose shared exponent
    clamps to -127: there se - fold = -131 and the TPU kernel's _exp2_i32
    (and the CUDA kernels) clamp the scale to 2^-126, while the twins'
    mul_pow2 applies 2^-131 exactly (ROADMAP queue 3). The same weight is
    built in tests/test_torch_kernels_gpu.py::_edge_weight."""
    rng = np.random.default_rng(11)
    W = rng.standard_normal((64, 8)).astype(np.float32)
    W[:32, 3] = np.float32(2.0 ** -125) * (1 + np.arange(32) % 5)
    j = jpk.to_serving_layout(jpk.pack_mx(jnp.asarray(W), 8, "fp6_e3m2", 32,
                                          axis=0, transport="emi8"))
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8,
                                          "fp6_e3m2", 32, axis=0,
                                          transport="emi8"))
    x = np.zeros((2, 64), np.float32)
    x[:, :32] = 1.0                   # only the tiny block feeds column 3
    return W, j, t, x


def test_exponent_floor_edge_twin_matches_jax_twin():
    _, j, t, x = _edge_pair()
    assert int(t.scale_exp[0, 3]) == -127
    assert tpk.emi8_fold("fp6_e3m2") == 4
    y_t = dm.dequant_gemv(torch.from_numpy(x), t).numpy()
    np.testing.assert_array_equal(y_t, np.asarray(
        j_reference(jnp.asarray(x), j)))
    # the TPU kernel clamps: 2^(-126 - (-131)) = 32x the twin in column 3
    y_k = np.asarray(j_sad(jnp.asarray(x), j, interpret=True))
    np.testing.assert_allclose(y_k[:, 3], 32 * y_t[:, 3], rtol=1e-6)
