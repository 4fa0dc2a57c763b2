"""The float8 containers (``float8_e4m3fn`` from fp8_e4m3 and from fp6/fp4
packed ``native``; ``float8_e5m2`` from fp8_e5m2): the port's decode
parameters, routing and plain version against the JAX kernels run as the JAX
tests run them, and a tiny float8 Llama against JAX. The CUDA decode itself
is held against the plain version on a card by
tests/test_torch_kernels_gpu.py.

Tolerances:
- plain version vs JAX ``dequant_matmul_reference``: rtol 2e-5, atol 1e-4,
  the bound of tests/test_pallas_kernels.py::
  test_dequant_matmul_matches_reference (the same bf16 weights, f32 sums in
  another order);
- plain version vs JAX ``dequant_matmul(..., interpret=True)`` on 2-D codes,
  which reaches ``_dq_matmul_kernel``'s ``native2d`` branch: 2e-3 of max
  |reference| (bf16 MMA with f32 accumulation, as the GEMM tests);
- the tiny Llama: float32 logits within 1e-4 of max |logit|, greedy tokens
  identical, as tests/test_torch_int_llama.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.eval.generate import generate as j_generate
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul as j_dequant_matmul,
    dequant_matmul_reference as j_reference,
)
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval.generate import generate
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
from test_torch_int_llama import jax_params, model_pair, port_params
from test_torch_outlier_llama import _leaves, _rel, _same_leaf, to_numpy

# (format, the CUDA decode its container takes)
FLOAT8 = [("fp8_e4m3", "fp8_e4m3"), ("fp8_e5m2", "fp8_e5m2"),
          ("fp6_e3m2", "fp8_e4m3"), ("fp4_e2m1", "fp8_e4m3")]


def _weights_kn(k, n, seed):
    """(K, N) weight with per-output-channel magnitude spread, as
    tests/test_pallas_kernels.py::_weights_kn."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n))
            * np.exp(rng.uniform(-3, 3, (1, n)))).astype(np.float32)


def _pair(W, fmt, serving):
    """The same weight packed natively by both packages, bit-identical."""
    j = jpk.pack_mx(jnp.asarray(W), 8, fmt, 32, axis=0)
    t = tpk.pack_mx(torch.from_numpy(W), 8, fmt, 32, axis=0)
    if serving:
        j, t = jpk.to_serving_layout(j), tpk.to_serving_layout(t)
    np.testing.assert_array_equal(t.codes.view(torch.uint8).numpy(),
                                  np.asarray(j.codes).view(np.uint8))
    np.testing.assert_array_equal(t.scale_exp.numpy(), np.asarray(j.scale_exp))
    return j, t


def _x(M, K, seed):
    return np.random.default_rng(seed).standard_normal((M, K)
                                                       ).astype(np.float32)


def _relerr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


@pytest.mark.parametrize("fmt,decode", FLOAT8)
def test_decode_params_are_the_container_with_no_fold(fmt, decode):
    """Float8 codes decode as they are: fold 0, as the TPU wrapper's
    _scale_fold gives every float format."""
    from microscopiq_tpu.ops.pallas.dequant_matmul import _scale_fold

    _, t = _pair(_weights_kn(64, 32, 1), fmt, serving=False)
    assert t.codes.dtype == dict(fp8_e5m2=torch.float8_e5m2).get(
        fmt, torch.float8_e4m3fn)
    assert dm.sad_decode_params(t) == (decode, 0, 0, 0)
    assert _scale_fold(fmt) == 0
    assert {f"dequant_gemv_{decode}", f"dequant_matmul_{decode}"} <= set(
        dm.launch_counts)


@pytest.mark.parametrize("fmt,decode", FLOAT8)
@pytest.mark.parametrize("M", [8, 130])
def test_plain_matches_jax_native2d_kernel(fmt, decode, M):
    """2-D float8 codes: JAX's dequant_matmul runs the native2d Pallas
    kernel at every M; the port's GEMV (M <= 64) and GEMM take them through
    a view in the serving layout, and on the CPU their plain version."""
    j, t = _pair(_weights_kn(256, 512, M), fmt, serving=False)
    assert t.codes.ndim == 2
    x = _x(M, 256, M + 1)
    dm.reset_launch_counts()
    y_t = dm.dequant_matmul(torch.from_numpy(x), t).numpy()
    assert not any(dm.launch_counts.values())
    y_r = np.asarray(j_reference(jnp.asarray(x), j))
    np.testing.assert_allclose(y_t, y_r, rtol=2e-5, atol=1e-4)
    y_k = np.asarray(j_dequant_matmul(jnp.asarray(x), j, interpret=True))
    assert y_t.shape == y_k.shape == (M, 512)
    assert _relerr(y_t, y_k) < 2e-3


@pytest.mark.parametrize("fmt,decode", FLOAT8)
def test_plain_matches_jax_on_serving_layout(fmt, decode):
    """Serving-layout float8 codes: JAX sends them to XLA's
    dequantize-then-dot; the port's GEMV and GEMM decode them."""
    j, t = _pair(_weights_kn(256, 384, 3), fmt, serving=True)
    for M in (5, 100):
        x = _x(M, 256, M)
        y_t = dm.dequant_matmul(torch.from_numpy(x), t).numpy()
        y_j = np.asarray(j_dequant_matmul(jnp.asarray(x), j, interpret=True))
        np.testing.assert_allclose(y_t, y_j, rtol=2e-5, atol=1e-4)


def test_float8_routing_reaches_the_kernels_operand_check():
    """On tensors that are not on the CPU the wrappers take float8 weights
    to the kernels (here the meta device stops them at the operand check,
    before any launch): no NotImplementedError at any M or layout."""
    W = torch.from_numpy(_weights_kn(64, 32, 3))
    x = torch.zeros(2, 64, device="meta")
    for fmt in ("fp8_e4m3", "fp8_e5m2", "fp4_e2m1"):
        for serving in (True, False):
            p = tpk.pack_mx(W, 8, fmt, 32, axis=0)
            p = tpk.to_serving_layout(p) if serving else p
            meta = dataclasses.replace(p, codes=p.codes.to("meta"),
                                       scale_exp=p.scale_exp.to("meta"))
            for fn in (dm.dequant_gemv, dm.dequant_gemm, dm.dequant_matmul):
                with pytest.raises(ValueError, match="one CUDA device"):
                    fn(x, meta)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
def test_pack_params_float8_match_jax(fmt):
    """pack_params gives the float8 formats the native container in the
    serving layout, bit-identical in both packages, fused alike."""
    mine = port_params(fmt)
    theirs = params_from_jax(to_numpy(jax_params(fmt)), device="cpu")
    a, b = dict(_leaves(mine)), dict(_leaves(theirs))
    assert a.keys() == b.keys()
    for path in a:
        _same_leaf(a[path], b[path], "/".join(path))
    for p in a:
        if p[-1] == "kernel":
            w = a[p]
            assert isinstance(w, tpk.PackedMX) and w.transport == "native"
            assert w.codes.ndim == 3
            assert dm.sad_decode_params(w)[0] == fmt


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
def test_float8_llama_logits_and_greedy_tokens_match_jax(fmt):
    jm, jp, tm = model_pair(fmt)
    assert tm.lm_head.kernel.codes.dtype == {
        "fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}[fmt]
    ids = np.random.default_rng(1).integers(0, 256, (2, 12))
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(ids)), np.float32)
    with torch.inference_mode():
        got = tm(torch.as_tensor(ids))
    assert _rel(got.numpy(), want) < 1e-4
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (5, 9, 7)]
    np.testing.assert_array_equal(
        generate(tm, prompts, 16),
        j_generate(jm, jp, prompts, 16, cache_kind="dense"))
