"""Every transport of the TPU GEMV and GEMM in the port: the port's packing
and plain twin against the JAX kernels run as the JAX tests run them
(Pallas interpret mode), and the operand checks around the CUDA kernels.
The kernels themselves are held against the twin on a card by
tests/test_torch_kernels_gpu.py.

Tolerances:
- twin vs JAX ``dequant_matmul_sad``: rtol 2e-5, atol 1e-4, the bound of
  tests/test_pallas_kernels.py::test_dequant_matmul_matches_reference (exact
  float32 products of bf16-rounded x and the decoded codes; only the
  summation order differs);
- twin vs JAX ``dequant_matmul`` (M > 64): 2e-3 of max |reference|, the
  bound of tests/test_pallas_kernels.py::test_dq_matmul_prefill_fused_decode
  (bf16 MMA with float32 accumulation);
- packing: bit-exact.
"""

import dataclasses

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

# the (format, transport) pairs of tests/test_pallas_kernels.py::
# test_sad_matches_reference, with the decode each maps to
SAD_PAIRS = [
    ("int8", "native", "native"), ("int4", "native", "native"),
    ("int2", "native", "native"), ("fp6_e3m2", "emi8", "emi8"),
    ("fp6_e2m3", "emi8", "emi8"), ("fp4_e2m1", "emi8", "emi8"),
    ("int4", "sb4", "sb4"), ("int2", "sb2", "sb2"),
    ("fp6_e3m2", "pf6", "pf6"), ("fp6_e2m3", "pf6", "pf6"),
    ("fp4_e2m1", "pf4", "pf4"),
]


def _weights_kn(k, n, seed, scale_spread=3.0):
    """(K, N) weight with per-output-channel magnitude spread, as
    tests/test_pallas_kernels.py::_weights_kn."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n))
            * np.exp(rng.uniform(-scale_spread, scale_spread, (1, n)))
            ).astype(np.float32)


def _pair(W, fmt, transport, bs=32, serving=True):
    """The same weight packed by both packages, bit-identical."""
    j = jpk.pack_mx(jnp.asarray(W), 8, fmt, bs, axis=0, transport=transport)
    t = tpk.pack_mx(torch.from_numpy(W), 8, fmt, bs, axis=0,
                    transport=transport)
    if serving:
        j, t = jpk.to_serving_layout(j), tpk.to_serving_layout(t)
    jc = np.asarray(j.codes)
    tc = t.codes
    if tc.dtype in (torch.bfloat16, torch.float16):
        jc, tc = jc.view(np.uint16), tc.view(torch.int16).numpy().view(
            np.uint16)
    else:
        tc = tc.numpy()
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(t.scale_exp.numpy(), np.asarray(j.scale_exp))
    return j, t


def _x(M, K, seed):
    return np.random.default_rng(seed).standard_normal((M, K)
                                                       ).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


@pytest.mark.parametrize("fmt,transport,decode", SAD_PAIRS)
def test_gemv_twin_matches_jax_sad_in_every_transport(fmt, transport, decode):
    j, t = _pair(_weights_kn(256, 384, 7), fmt, transport)
    assert dm.sad_decode_params(t)[0] == decode
    x = _x(8, 256, 8)
    y_t = dm.dequant_matmul(torch.from_numpy(x), t).numpy()
    y_j = np.asarray(j_sad(jnp.asarray(x), j, interpret=True))
    np.testing.assert_allclose(y_t, y_j, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("fmt,transport,fold,mw,ebits", [
    ("int8", "native", 6, 0, 0), ("int4", "native", 2, 0, 0),
    ("int2", "native", 0, 0, 0), ("int4", "sb4", 2, 0, 0),
    ("int2", "sb2", 0, 0, 0), ("fp6_e3m2", "pf6", 4, 2, 3),
    ("fp6_e2m3", "pf6", 3, 3, 2), ("fp4_e2m1", "pf4", 1, 1, 2),
    ("fp6_e3m2", "emi8", 4, 4, 0)])
def test_decode_params_follow_the_tpu_wrapper(fmt, transport, fold, mw,
                                              ebits):
    """(fold, mw, ebits) as the TPU wrapper's _sad_fold and ebits: the int
    folds 6/2/0, pf with the stored mantissa bits and emi8_fold."""
    from microscopiq_tpu.ops.pallas.dequant_matmul import _sad_fold

    j, t = _pair(_weights_kn(64, 32, 1), fmt, transport)
    dec, f, m, e = dm.sad_decode_params(t)
    assert (f, m, e) == (fold, mw, ebits)
    assert (dec, f, m) == _sad_fold(j)


def container_weight(fmt, seed):
    """(256, 384) weights for a container format. bfloat16's shared
    exponent is floor(log2 amax) - 127, so N(0, 64) weights keep every
    block's exponent above -127, where the TPU kernels' scale floor of
    2^-126 would depart from the twin's exact scale."""
    if fmt == "bfloat16":
        return _weights_kn(256, 384, seed, 0.0) * 8.0
    return _weights_kn(256, 384, seed)


@pytest.mark.parametrize("fmt,bs", [("bfloat16", 32), ("fp16", 32),
                                    ("int8", 16)])
def test_gemv_twin_matches_jax_sad_in_containers(fmt, bs):
    """The bf16 and fp16 containers (the TPU kernel casts fp16 codes to
    bf16, as the twin's bf16 dequantization does) and a 16-block int8,
    held relative to max |y| (bf16 weights dequantize to ~1e-32)."""
    j, t = _pair(container_weight(fmt, 9), fmt, "native", bs)
    x = _x(5, 256, 10)
    y_t = dm.dequant_gemv(torch.from_numpy(x), t).numpy()
    y_j = np.asarray(j_sad(jnp.asarray(x), j, interpret=True))
    assert _rel(y_t, y_j) < 1e-5


@pytest.mark.parametrize("layout", ["serving", "native2d"])
@pytest.mark.parametrize("M", [128, 513])
def test_gemm_twin_matches_jax_int8_prefill_kernel(layout, M):
    """The int8 container at M > 64 through the TPU GEMM, pre-blocked and
    2-D: the port's kernel takes the 2-D codes through a view of them in
    the serving layout (the same memory)."""
    W = _weights_kn(256, 384, M, 1.0) * 0.5
    j, t = _pair(W, "int8", "native", serving=layout == "serving")
    if layout == "native2d":
        assert t.codes.ndim == 2
        view = tpk.to_serving_layout(t)
        assert view.codes.data_ptr() == t.codes.data_ptr()
        assert view.codes.shape == (8, 32, 384)
    x = _x(M, 256, M)
    y_t = dm.dequant_matmul(torch.from_numpy(x), t).numpy()
    y_j = np.asarray(j_dequant_matmul(jnp.asarray(x), j, interpret=True))
    assert _rel(y_t, y_j) < 2e-3
    assert _rel(y_t, j_reference(jnp.asarray(x),
                                 jpk.from_serving_layout(j))) < 1e-6


@pytest.mark.parametrize("fmt", ["bfloat16", "fp16"])
def test_gemm_twin_matches_jax_native2d_container_kernel(fmt):
    """2-D bf16/fp16 containers reach the TPU kernel's native2d branch."""
    j, t = _pair(container_weight(fmt, 3), fmt, "native", serving=False)
    x = _x(200, 256, 4)
    y_t = dm.dequant_matmul(torch.from_numpy(x), t).numpy()
    y_j = np.asarray(j_dequant_matmul(jnp.asarray(x), j, interpret=True))
    assert _rel(y_t, y_j) < 2e-3


@pytest.mark.parametrize("fmt,transport", [("int4", "sb4"), ("int2", "sb2"),
                                           ("fp4_e2m1", "pf4"),
                                           ("fp6_e3m2", "pf6")])
def test_gemm_transports_that_jax_leaves_to_xla(fmt, transport):
    """JAX sends these to XLA's dequantize-then-dot at M > 64; the port's
    twin is the same computation."""
    j, t = _pair(_weights_kn(256, 384, 5), fmt, transport)
    x = _x(130, 256, 6)
    y_t = dm.dequant_matmul(torch.from_numpy(x), t).numpy()
    y_j = np.asarray(j_dequant_matmul(jnp.asarray(x), j, interpret=True))
    assert _rel(y_t, y_j) < 1e-6


def test_transport_rows_and_bits_per_weight():
    W = torch.from_numpy(_weights_kn(256, 64, 2))
    for fmt, tr, rows, bits in (("int4", "sb4", 16, 4.25),
                                ("int2", "sb2", 8, 2.25),
                                ("int8", "native", 32, 8.25),
                                ("fp6_e3m2", "pf6", 24, 6.25),
                                ("fp4_e2m1", "pf4", 16, 4.25)):
        p = tpk.to_serving_layout(tpk.pack_mx(W, 8, fmt, 32, axis=0,
                                              transport=tr))
        assert p.codes.shape == (8, rows, 64)
        assert p.bits_per_element == bits


def test_kernel_operand_checks():
    """The CUDA path's operand checks, reached through tensors on the meta
    device (no kernel runs): a transport whose rows do not match its
    block, misaligned codes; float8 containers reach the device check as
    every other transport does."""
    W = torch.from_numpy(_weights_kn(64, 32, 3))
    x = torch.zeros(2, 64, device="meta")
    p = tpk.to_serving_layout(tpk.pack_mx(W, 8, "int4", 32, axis=0,
                                          transport="sb4"))
    meta = lambda q: dataclasses.replace(
        q, codes=q.codes.to("meta"), scale_exp=q.scale_exp.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        dm.dequant_gemv(x, meta(p))
    with pytest.raises(ValueError, match="one CUDA device"):
        dm.dequant_gemm(x, meta(tpk.to_serving_layout(
            tpk.pack_mx(W, 8, "fp4_e2m1", 32, axis=0))))
    with pytest.raises(ValueError, match="blocked on axis 0"):
        dm.dequant_gemv(x, dataclasses.replace(meta(p), axis=1))
