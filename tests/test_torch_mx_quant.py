"""The MX block quantizer in the port: its plain version (``pack_mx`` with
the exact scale, on the last axis) against the TPU kernel
``quantize_mx_pallas`` run in Pallas interpret mode, bit for bit, as
tests/test_pallas_kernels.py holds the TPU kernel against the JAX
``pack_mx``. The CUDA kernel is held bit-exact against the plain version on
a card by tests/test_torch_kernels_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops.pallas import quantize_mx_pallas
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import mx_quant as mq


def _raw(a):
    """Bit patterns of a code array (int8, float8 or 16-bit)."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16}[a.dtype.itemsize])


def _torch_raw(t):
    return _raw(t.view(torch.uint8 if t.element_size() == 1
                       else torch.int16).numpy())


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp(rng.uniform(-3, 3, shape[:-1] + (1,)))
            ).astype(np.float32)


def _check(x, fmt, bs):
    got = mq.quantize_mx_block(torch.from_numpy(x), 8, fmt, bs)
    want = quantize_mx_pallas(jnp.asarray(x), 8, fmt, bs, interpret=True)
    assert got.codes.shape == tuple(want.codes.shape)
    assert got.codes.dtype == tpk.container_dtype(fmt)
    np.testing.assert_array_equal(_torch_raw(got.codes), _raw(want.codes))
    np.testing.assert_array_equal(got.scale_exp.numpy(),
                                  np.asarray(want.scale_exp))
    assert (got.orig_dim, got.axis, got.block_size) == (
        x.shape[-1], -1, bs)
    return got


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1", "int8", "int2",
                                 "int4", "fp8_e4m3"])
def test_plain_version_matches_tpu_kernel_bit_for_bit(fmt):
    _check(_weights((64, 512), 7), fmt, 32)


def test_ragged_block16_and_zero_blocks():
    x = _weights((10, 200), 8)
    x[3, :16] = 0.0                      # a zero block: amax + 2^-126
    x[4, 16:32] = 1e-40                  # a subnormal amax
    got = _check(x, "fp6_e3m2", 16)
    assert got.codes.shape == (10, 208) and got.scale_exp.shape == (10, 13)
    assert int(got.scale_exp[3, 0]) == -127


def test_leading_dims_and_cpu_counts_nothing():
    x = _weights((2, 3, 96), 9)
    mq.reset_launch_counts()
    got = _check(x, "int8", 32)
    assert got.codes.shape == (2, 3, 96) and got.scale_exp.shape == (2, 3, 3)
    assert mq.launch_counts["quantize_mx"] == 0


def test_block_sizes_the_kernel_takes():
    assert all(mq.block_size_ok(b) for b in (2, 8, 16, 32, 64, 96, 256))
    assert not any(mq.block_size_ok(b) for b in (12, 48, 320))
    with pytest.raises(ValueError, match="block size 48"):
        mq.quantize_mx_block(torch.zeros(2, 96, device="meta"), 8, "int8", 48)


def _pow2(e):
    """Exact 2^e in float32 for integer e in [-149, 127], as the kernel's
    pow2f builds it from bits."""
    e = e.to(torch.int32)
    normal = ((e + 127).clamp(min=0) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 30)).view(torch.float32)
    return torch.where(e >= -126, normal, sub)


def _kernel_arithmetic(blocked, scale_bits, fmt):
    """A CPU model of csrc/mx_quant.cu's quant_elem and block_exp: each
    power of two one multiply, except x * 2^-se where its first half
    product could be subnormal, and a float format's rounding on the bits
    of |x| in its normal range. Returns (q, se) before the container."""
    from microscopiq_tpu_torch.formats import get_format_params
    from microscopiq_tpu_torch.ops.elemwise import floor_log2

    ebits, mbits, emax, max_norm, _ = get_format_params(fmt)
    amax = blocked.abs().amax(-1, keepdim=True)
    amax = torch.where(amax == 0, amax + 2.0 ** -126, amax)
    sem = 2 ** (scale_bits - 1) - 1
    se = (floor_log2(amax).to(torch.int32) - emax).clamp(-sem, sem)
    e = -se
    half = torch.div(e, 2, rounding_mode="trunc")
    thr = torch.where(se > 0, _pow2(-126 - half), torch.zeros_like(amax))
    xs = torch.where((e < 0) & (blocked.abs() < thr) & (blocked != 0),
                     (blocked * _pow2(half)) * _pow2(e - half),
                     blocked * _pow2(e))

    def sign(t):
        return torch.where(t > 0, torch.ones_like(t),
                           torch.where(t < 0, -torch.ones_like(t), t))

    grid, ungrid = 2.0 ** (mbits - 2), 2.0 ** (2 - mbits)
    if ebits > 0:
        # three paths: a fixed grid below 2^pe_min, the mantissa rounded on
        # its bits up to 2^127, the plain version's steps above
        pe_min = 2 - 2 ** (ebits - 1)
        a = xs.abs()
        lo = 2.0 ** pe_min
        t = (a * 2.0 ** -pe_min) * grid
        sub = ((torch.floor(t + 0.5) * ungrid) * lo).copysign(xs)
        drop = 23 - (mbits - 2)
        bits = a.view(torch.int32)
        normal = ((bits + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(
            torch.float32).copysign(xs)
        pe = floor_log2(a).clamp(min=pe_min).to(torch.int32)
        t = (xs * _pow2(-pe)) * grid
        big = ((sign(t) * torch.floor(t.abs() + 0.5)) * ungrid) * _pow2(pe)
        q = torch.where(a < lo, sub, torch.where(a < 2.0 ** 127, normal, big))
    else:
        t = xs * grid
        q = (sign(t) * torch.floor(t.abs() + 0.5)) * ungrid
    return q.clamp(-max_norm, max_norm), se


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1", "int8", "int4",
                                 "int2", "fp8_e5m2", "float16", "bfloat16"])
def test_kernel_one_multiply_arithmetic_is_the_plain_versions(fmt):
    """The kernel replaces the plain version's two half-factor powers of two
    by one multiply where that is provably the same rounding; the model of
    that arithmetic is bit-equal to pack_mx(exact_scale=True)'s steps on
    magnitudes from 2^-149 to 2^127, zero blocks and subnormal maxima."""
    from microscopiq_tpu_torch.formats import get_format_params
    from microscopiq_tpu_torch.ops.elemwise import (mul_pow2,
                                                    quantize_elemwise_core)
    from microscopiq_tpu_torch.ops.mx import shared_exponents

    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2048, 16))
         * np.exp2(rng.integers(-149, 128, (2048, 1))
                   - rng.integers(0, 40, (2048, 16)).astype(np.float64)))
    x = np.clip(x, -3e38, 3e38).astype(np.float32)
    x[::7] = 0.0
    x[1::11, 3] = 1e-45
    x[2::13] = np.float32(3.3e38)
    blocked = torch.from_numpy(x)
    ebits, mbits, emax, max_norm, _ = get_format_params(fmt)
    for scale_bits in (8, 5):
        sem = 2 ** (scale_bits - 1) - 1
        se = torch.clamp(shared_exponents(blocked, "max", axes=[1]) - emax,
                         -sem, sem)
        want = quantize_elemwise_core(mul_pow2(blocked, -se), mbits, ebits,
                                      max_norm, allow_denorm=True,
                                      saturate_normals=True)
        got, got_se = _kernel_arithmetic(blocked, scale_bits, fmt)
        assert torch.equal(got_se.float(), se)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
