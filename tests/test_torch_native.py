"""Port host codec (microscopiq_tpu_torch.native, its own mx_codec.cpp
built with g++ into its own directory) against the port's pack_mx with
exact_scale=True; mirrors tests/test_native.py. Every comparison is
bit-exact. A failed build fails these tests: the port raises where the JAX
module returns None."""

import time

import numpy as np
import pytest
import torch

from microscopiq_tpu_torch import native
from microscopiq_tpu_torch.ops import packing as pk


def _want(W, fmt, block=32):
    p = pk.pack_mx(torch.as_tensor(W), 8, fmt, block, exact_scale=True)
    return p.codes.view(torch.uint8).numpy(), p.scale_exp.numpy(), p


def test_builds_into_the_port():
    assert native.available()
    assert "/microscopiq_tpu_torch/native/_build/" in native.lib_path()


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1", "int8", "int4",
                                 "int2", "fp6_e2m3", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("shape", [(1, 32), (3, 64), (127, 96), (64, 256)])
def test_pack_bit_exact_vs_pack_mx(fmt, shape):
    rng = np.random.default_rng(sum(shape))
    W = (rng.standard_normal(shape) *
         np.exp(rng.uniform(-4, 4, (shape[0], 1)))).astype(np.float32)
    codes, scales = native.pack_mx_native(W, 8, fmt, 32)
    want_c, want_s, p = _want(W, fmt)
    np.testing.assert_array_equal(scales, want_s)
    np.testing.assert_array_equal(codes, want_c)
    deq = native.dequant_mx_native(codes, scales, fmt, 32)
    np.testing.assert_array_equal(deq, pk.dequantize_mx(p).numpy())


def test_takes_and_returns_cpu_tensors():
    W = torch.randn(16, 64, generator=torch.Generator().manual_seed(1))
    codes, scales = native.pack_mx_native(W, 8, "fp6_e3m2", 32)
    assert isinstance(codes, torch.Tensor) and codes.dtype == torch.uint8
    want_c, want_s, p = _want(W.numpy(), "fp6_e3m2")
    assert np.array_equal(codes.numpy(), want_c)
    # float8 codes of pack_mx go back in by their bits
    deq = native.dequant_mx_native(p.codes, p.scale_exp, "fp6_e3m2", 32)
    assert torch.equal(deq, pk.dequantize_mx(p))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="CPU tensors"):
            native.pack_mx_native(W.cuda(), 8, "fp6_e3m2", 32)


def test_threading_deterministic_and_fast():
    rng = np.random.default_rng(9)
    W = rng.standard_normal((257, 512)).astype(np.float32)
    c1, s1 = native.pack_mx_native(W, 8, "fp6_e3m2", 32, nthreads=1)
    c16, s16 = native.pack_mx_native(W, 8, "fp6_e3m2", 32, nthreads=16)
    assert np.array_equal(c1, c16) and np.array_equal(s1, s16)
    assert np.array_equal(
        native.dequant_mx_native(c1, s1, "fp6_e3m2", 32, nthreads=1),
        native.dequant_mx_native(c1, s1, "fp6_e3m2", 32, nthreads=16))
    W = rng.standard_normal((2048, 4096)).astype(np.float32)
    t0 = time.perf_counter()
    native.pack_mx_native(W, 8, "fp6_e3m2", 32)
    assert time.perf_counter() - t0 < 2.0


def test_edge_values():
    W = np.zeros((4, 64), np.float32)
    W[1] = 1e30
    W[2] = -1e-30
    W[3, ::2] = -3.5
    codes, scales = native.pack_mx_native(W, 8, "fp6_e3m2", 32)
    deq = native.dequant_mx_native(codes, scales, "fp6_e3m2", 32)
    np.testing.assert_array_equal(
        deq, pk.dequantize_mx(_want(W, "fp6_e3m2")[2]).numpy())
    assert (deq[0] == 0).all()


def test_fp6_transport_matches_pack_fp6():
    grid = pk.decode_fp_bits(torch.arange(64, dtype=torch.uint8), "fp6_e3m2")
    vals = grid[torch.randint(0, 64, (8, 32),
                              generator=torch.Generator().manual_seed(11))]
    codes = pk.encode_fp_bits(vals, "fp6_e3m2")
    got = native.pack_fp6_transport_native(codes)
    assert torch.equal(got, pk.pack_fp6(vals).reshape(-1))
    with pytest.raises(ValueError, match="four at a time"):
        native.pack_fp6_transport_native(np.zeros(6, np.uint8))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """Where the JAX module returns None, the port raises, naming g++."""
    bad = tmp_path / "mx_codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    assert not native.available()
