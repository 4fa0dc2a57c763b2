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
