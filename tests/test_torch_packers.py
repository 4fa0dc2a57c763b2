"""Port standalone transport packers (microscopiq_tpu_torch.ops.packing
pack_int4/int2/fp4/fp6 and their unpackers) and ``quantize_elemwise``
against the JAX functions on the same seeded numpy inputs; mirrors
tests/test_packing.py:19-28, :104 and :125-151. Every comparison is
bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import elemwise as je
from microscopiq_tpu.ops import packing as jp
from microscopiq_tpu_torch.ops import elemwise as te
from microscopiq_tpu_torch.ops import packing as tp

RNG = np.random.default_rng(0)


_jit = {}


def _j(name, *static):
    """The JAX packer ``name`` under jit (one compile, not one a op)."""
    key = (name,) + static
    if key not in _jit:
        fn = getattr(jp, name)
        _jit[key] = jax.jit(lambda x: fn(x, *static))
    return _jit[key]


def _grid(fmt, nbits):
    return np.asarray(jp.decode_fp_bits(
        jnp.arange(2 ** nbits, dtype=jnp.uint8), fmt))


@pytest.mark.parametrize("name,lo,hi", [("int4", -8, 7), ("int2", -2, 1)])
@pytest.mark.parametrize("shape", [(16, 64), (3, 5, 8)])
def test_int_packers_bit_exact(name, lo, hi, shape):
    codes = RNG.integers(lo, hi + 1, size=shape).astype(np.int8)
    pack, unpack = (getattr(tp, f"pack_{name}"),
                    getattr(tp, f"unpack_{name}"))
    got = pack(torch.as_tensor(codes))
    want = _j(f"pack_{name}")(jnp.asarray(codes))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = unpack(got)
    assert out.dtype == torch.int8                 # sign-extended
    np.testing.assert_array_equal(out.numpy(), codes)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(_j(f"unpack_{name}")(want)))
    # every byte value unpacks as JAX's
    every = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        unpack(torch.as_tensor(every)).numpy(),
        np.asarray(_j(f"unpack_{name}")(jnp.asarray(every))))


@pytest.mark.parametrize("fmt,nbits,width", [
    ("fp4_e2m1", 4, 32), ("fp6_e3m2", 6, 48), ("fp6_e2m3", 6, 48)])
def test_fp_packers_bit_exact(fmt, nbits, width):
    vals = RNG.choice(_grid(fmt, nbits), size=(8, width)).astype(np.float32)
    if nbits == 4:
        got = tp.pack_fp4(torch.as_tensor(vals))
        want = _j("pack_fp4")(jnp.asarray(vals))
        back, jback = tp.unpack_fp4(got), _j("unpack_fp4")(want)
    else:
        got = tp.pack_fp6(torch.as_tensor(vals), fmt)
        want = _j("pack_fp6", fmt)(jnp.asarray(vals))
        assert tuple(got.shape) == (8, width // 4 * 3)
        back, jback = tp.unpack_fp6(got, fmt), _j("unpack_fp6", fmt)(want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    # every byte decodes as JAX's
    every = np.arange(256 if nbits == 4 else 255, dtype=np.uint8)
    if nbits == 6:
        every = every[:255 // 3 * 3]
        t, j = (tp.unpack_fp6(torch.as_tensor(every), fmt),
                _j("unpack_fp6", fmt)(jnp.asarray(every)))
    else:
        t, j = (tp.unpack_fp4(torch.as_tensor(every)),
                _j("unpack_fp4")(jnp.asarray(every)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("fmt", ["int8", "int4", "int2", "fp8_e4m3",
                                 "fp8_e5m2", "fp6_e3m2", "fp6_e2m3",
                                 "fp4_e2m1", "float16", "bfloat16", None])
@pytest.mark.parametrize("saturate", [False, True])
def test_quantize_elemwise_bit_exact(fmt, saturate):
    x = (RNG.standard_normal(4096) * np.exp(RNG.uniform(-8, 8, 4096))
         ).astype(np.float32)
    x[:4] = [np.inf, -np.inf, np.nan, 0.0]
    got = te.quantize_elemwise(torch.as_tensor(x), fmt,
                               saturate_normals=saturate).numpy()
    want = np.asarray(je.quantize_elemwise(jnp.asarray(x), fmt,
                                           saturate_normals=saturate))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
