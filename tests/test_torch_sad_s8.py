"""W8A8 in the port against JAX: ``quantize_activations_int8`` bit for bit,
and the plain twin ``dequant_matmul_sad_s8_reference`` against the TPU
kernel ``dequant_matmul_sad_s8`` run in Pallas interpret mode. The CUDA
kernel is held against the twin on a card by
tests/test_torch_kernels_gpu.py.

Tolerance: 3e-6 of max |reference|, the bound of
tests/test_pallas_kernels.py::test_sad_s8_matches_reference (exact s32 block
sums, float32 sums of the scaled partials in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul_sad_s8 as j_sad_s8,
    dequant_matmul_sad_s8_reference as j_sad_s8_reference,
    quantize_activations_int8 as j_quantize_activations,
)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

CASES = [("int8", "native", 32), ("int4", "sb4", 16), ("int2", "sb2", 16)]


def _pair(K, N, fmt, transport, bs, seed=0):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    j = jpk.pack_mx(jnp.asarray(W), 8, fmt, bs, axis=0, transport=transport)
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, fmt, bs,
                                          axis=0, transport=transport))
    return j, t


@pytest.mark.parametrize("shape,spread", [((4, 256), 1.0), ((3, 7, 130), 3.0),
                                          ((1, 4096), 0.0), ((5, 64), 30.0)])
def test_activation_quantizer_is_bit_exact(shape, spread):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape)
         * np.exp(rng.uniform(-spread, spread, shape[:-1] + (1,)))
         ).astype(np.float32)
    x.reshape(-1)[:3] = [0.5, -0.5, 2.5]          # ties at some scale
    codes, scale = dm.quantize_activations_int8(torch.from_numpy(x))
    jc, js = j_quantize_activations(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def test_activation_quantizer_rounds_half_to_even_and_takes_zeros():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -2.5, 0.0],
                      [0.0] * 6])
    codes, scale = dm.quantize_activations_int8(x)
    assert codes[0].tolist() == [127, 0, 2, 2, -2, 0]
    assert scale[0, 0] == 1.0 and codes[1].abs().sum() == 0
    assert scale[1, 0] == np.float32(1e-30) / np.float32(127.0)


@pytest.mark.parametrize("fmt,transport,bs", CASES)
@pytest.mark.parametrize("M", [1, 4, 8])
def test_twin_matches_jax_kernel(fmt, transport, bs, M):
    j, t = _pair(256, 256, fmt, transport, bs)
    x = np.random.default_rng(M).standard_normal((M, 256)).astype(np.float32)
    y_ref = dm.dequant_matmul_sad_s8_reference(torch.from_numpy(x), t).numpy()
    y_k = np.asarray(j_sad_s8(jnp.asarray(x), j, interpret=True))
    np.testing.assert_allclose(y_ref, y_k, rtol=0,
                               atol=3e-6 * np.abs(y_ref).max())
    y_jref = np.asarray(j_sad_s8_reference(jnp.asarray(x), j))
    np.testing.assert_allclose(y_ref, y_jref, rtol=0,
                               atol=1e-6 * np.abs(y_ref).max())


def test_wrapper_on_cpu_is_the_twin_and_checks_formats():
    j, t = _pair(128, 96, "int4", "sb4", 32)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 128)).astype(np.float32))
    dm.reset_launch_counts()
    y = dm.dequant_matmul_sad_s8(x, t, out_dtype=torch.bfloat16)
    assert y.shape == (2, 3, 96) and y.dtype == torch.bfloat16
    assert torch.equal(y, dm.dequant_matmul_sad_s8_reference(
        x, t, out_dtype=torch.bfloat16))
    assert not any(dm.launch_counts.values())
    W = torch.randn(64, 32)
    for fmt, tr in (("fp6_e3m2", "emi8"), ("fp4_e2m1", "pf4")):
        p = tpk.pack_mx(W, 8, fmt, 32, axis=0, transport=tr)
        with pytest.raises(ValueError, match="integer weight codes"):
            dm.dequant_matmul_sad_s8(torch.zeros(1, 64), p)
    p = tpk.pack_mx(W, 8, "int4", 32, axis=1)
    with pytest.raises(ValueError, match="axis 0"):
        dm.dequant_matmul_sad_s8(torch.zeros(1, 32), p)


@pytest.mark.parametrize("decode", ["native", "sb4", "sb2"])
def test_s8_route_takes_multiples_of_16(decode):
    """The int8 tensor-core GEMV takes every block that is a multiple of 16
    (its mma step) up to 256 for one-byte codes; gemv_any.cu's W8A8 kernel
    ("any") the others that the W8A8 path takes, the CUDA-core kernel
    ("cc") none of them."""
    for block in (16, 32, 48, 64, 128, 256):
        assert dm.s8_route(decode, block) == "tc"
    for block in (4, 8, 12, 20, 24):
        assert dm.s8_route(decode, block) == "any"
    assert dm.s8_counter(decode, 32) == f"dequant_gemv_s8_{decode}"
    assert dm.s8_counter(decode, 8) == f"dequant_gemv_s8_{decode}_any"
    with pytest.raises(ValueError, match="no tensor-core W8A8"):
        dm.s8_gemv_plan(decode, 256, 256, 8, 1)


@pytest.mark.parametrize("decode,block", [("native", 32), ("sb4", 16),
                                          ("sb2", 16), ("sb4", 32)])
def test_s8_gemv_plan_is_the_bf16_gemv_s_with_int8_x(decode, block):
    """The W8A8 plan has the bf16-activation GEMV's stage (the same packed
    code rows) and a split that depends on the weight alone; x takes one
    byte a K row, so its pitch is the split's K plus 16 and the ring fits
    227 KB beside 64 rows."""
    for K, N in ((4096, 28672), (4096, 6144), (14336, 4096), (200, 130)):
        plans = [dm.s8_gemv_plan(decode, N, K, block, M)
                 for M in (1, 8, 13, 64)]
        bf16 = dm.gemv_plan(decode, N, K, block, 8)
        for p in plans:
            for key in ("stage_blocks", "sub_stride", "se_off",
                        "stage_bytes", "ksplit", "split_blocks",
                        "col_tiles", "tiles", "ctas", "tma"):
                assert p[key] == plans[0][key], key
            assert p["stage_bytes"] == bf16["stage_bytes"]
            assert p["x_pitch"] == p["split_blocks"] * block + 16
            assert 2 <= p["stages"] <= dm.GEMV_MAX_STAGES
            assert p["smem_bytes"] == (
                2048 + p["stages"] * p["stage_bytes"]
                + -(-8 * p["n8_tiles"] * p["x_pitch"] // 128) * 128)
            assert p["smem_bytes"] <= dm.SM90_MAX_SMEM
            NB = -(-K // block)
            assert p["ksplit"] * p["split_blocks"] >= NB
        assert [p["n8_tiles"] for p in plans] == [1, 1, 2, 8]


def test_quantize_x_int8_on_cpu_is_the_twin():
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (3, 70)).astype(np.float32))
    dm.reset_launch_counts()
    codes, scale = dm.quantize_x_int8(x)
    want = dm.quantize_activations_int8(x)
    assert torch.equal(codes, want[0]) and torch.equal(scale, want[1])
    assert dm.launch_counts["quantize_x_int8"] == 0
