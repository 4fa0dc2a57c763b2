"""Port codec (microscopiq_tpu_torch.ops) against the JAX package and the
golden fixtures: floor_log2, exp2_exact, mul_pow2, the element and MX
quantizers, pack_mx (native and emi8, both exact_scale modes), the serving
layout and dequantize_mx. Every comparison is bit-exact; the only allowance
is the FTZ rule of helpers.assert_bitexact (XLA flushes subnormal float32
outputs, torch keeps them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_bitexact
from microscopiq_tpu.formats import get_format_params
from microscopiq_tpu.ops import elemwise as jel
from microscopiq_tpu.ops import mx as jmx
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu_torch.ops import elemwise as tel
from microscopiq_tpu_torch.ops import mx as tmx
from microscopiq_tpu_torch.ops import packing as tpk

FORMATS = ["int8", "int4", "int2", "fp8_e5m2", "fp8_e4m3", "fp6_e3m2",
           "fp6_e2m3", "fp4_e2m1", "fp16", "bf16"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(k, n, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((k, n))
         * np.exp(rng.uniform(-spread, spread, (1, n)))).astype(np.float32)
    W[0, :4] = [0.0, -0.0, 1e-9, 27.5]
    return W


def _same_as_jax(port, jax_val, msg):
    """Bit-exact, except that XLA may flush a subnormal that torch keeps:
    the JAX value goes in the FTZ slot of assert_bitexact."""
    assert_bitexact(np.asarray(jax_val), np.asarray(port), msg)


def _codes_bits(codes):
    """Raw bytes/bits of a code array, numpy or torch, for exact compare."""
    if isinstance(codes, torch.Tensor):
        it = codes.element_size()
        raw = codes.contiguous().view({1: torch.uint8, 2: torch.int16}[it])
        return raw.numpy().astype(np.int64) & ((1 << 8 * it) - 1)
    a = np.asarray(codes)
    return a.view({1: np.uint8, 2: np.uint16}[a.dtype.itemsize]
                  ).astype(np.int64)


def test_floor_log2_exhaustive_exponents():
    exps = np.arange(0, 255, dtype=np.uint32)
    mants = np.array([0, 1, 2, 3, 0x400000, 0x7FFFFF], dtype=np.uint32)
    x = ((exps[:, None] << 23) | mants[None, :]).view(np.float32).ravel()
    x = x[x > 0]
    want = np.floor(np.log2(x.astype(np.float64))).astype(np.float32)
    got = tel.floor_log2(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jel.floor_log2(
        jnp.asarray(x))))


def test_floor_log2_specials():
    x = np.array([np.inf, np.nan, 0.0, -np.inf], np.float32)
    got = tel.floor_log2(_t(x)).numpy()
    want = np.asarray(jel.floor_log2(jnp.asarray(x)))
    assert_bitexact(got, want, "specials", ftz_ok=False)
    assert got[2] == -150


def test_exp2_exact_and_mul_pow2():
    e = np.concatenate([np.arange(-130, 131), [np.inf, -np.inf, np.nan]]
                       ).astype(np.float32)
    assert_bitexact(tel.exp2_exact(_t(e)).numpy(),
                    np.asarray(jel.exp2_exact(jnp.asarray(e))), "exp2",
                    ftz_ok=False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    ee = rng.integers(-254, 255, 4096).astype(np.float32)
    _same_as_jax(tel.mul_pow2(_t(x), _t(ee)).numpy(),
                 jel.mul_pow2(jnp.asarray(x), jnp.asarray(ee)), "mul_pow2")


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_elemwise_core_golden(golden_elemwise, fmt):
    x = golden_elemwise["x"]
    ebits, mbits, _, max_norm, _ = get_format_params(fmt)
    fmt_key = "fp4_e2m1" if fmt == "fp4_e2m1" else fmt
    for rnd in ("nearest", "floor", "even"):
        for sat in (False, True):
            for dn in (False, True):
                key = f"{fmt_key}|{rnd}|sat{int(sat)}|dn{int(dn)}"
                got = tel.quantize_elemwise_core(
                    _t(x), mbits, ebits, max_norm, round=rnd,
                    saturate_normals=sat, allow_denorm=dn).numpy()
                assert_bitexact(got, golden_elemwise[key], key)
                _same_as_jax(got, jel.quantize_elemwise_core(
                    jnp.asarray(x), mbits, ebits, max_norm, round=rnd,
                    saturate_normals=sat, allow_denorm=dn), f"vs jax {key}")


@pytest.mark.parametrize("fmt", ["int8", "fp6_e3m2", "fp4_e2m1", "int2"])
def test_quantize_mx_golden(golden_mx, fmt):
    keys = [k for k in golden_mx.files if k.split("|")[1:2] == [fmt]]
    assert keys
    for key in keys:
        name, _, sb, bs, ax = key.split("|")
        a = golden_mx[f"in_{name}"]
        got = tmx.quantize_mx(_t(a), int(sb[2:]), fmt, axes=[int(ax[2:])],
                              block_size=int(bs[2:])).numpy()
        assert_bitexact(got, golden_mx[key], key)


def test_quantize_mx_flush_subnormal_blocks_vs_jax():
    a = _weights(16, 64, seed=4)
    a[:, :8] *= np.float32(1e-39)               # blocks of subnormals
    for flush in (False, True):
        got = tmx.quantize_mx(_t(a), 8, "fp6_e3m2", axes=[-1], block_size=8,
                              flush_fp32_subnorms=flush).numpy()
        want = jmx.quantize_mx(jnp.asarray(a), 8, "fp6_e3m2", axes=[-1],
                               block_size=8, flush_fp32_subnorms=flush)
        _same_as_jax(got, want, f"flush={flush}")


@pytest.mark.parametrize("shape,axes,bs", [
    ((64, 96), [1], 16), ((7, 13), [0], 16), ((4, 33, 20), [1], 32),
    ((5, 3), [0, 1], 4)])
def test_reshape_to_blocks_matches_jax(shape, axes, bs):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    tb, tax, to, tpad = tmx.reshape_to_blocks(_t(a), axes, bs)
    jb, jax_, jo, jpad = jmx.reshape_to_blocks(jnp.asarray(a), axes, bs)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert (tax, tuple(to), tuple(tpad)) == (jax_, tuple(jo), tuple(jpad))
    back = tmx.undo_reshape_to_blocks(tb, tpad, to, tax)
    np.testing.assert_array_equal(back.numpy(), a)


@pytest.mark.parametrize("fmt,transport", [
    ("fp6_e3m2", "emi8"), ("fp6_e2m3", "emi8"), ("fp4_e2m1", "emi8"),
    ("fp6_e3m2", "native"), ("fp4_e2m1", "native"), ("fp8_e4m3", "native"),
    ("int8", "native"), ("int4", "native"), ("bf16", "native")])
@pytest.mark.parametrize("exact_scale", [False, True])
def test_pack_mx_bitexact_vs_jax(fmt, transport, exact_scale):
    W = _weights(96, 130)
    for axis in (0, -1):
        j = jpk.pack_mx(jnp.asarray(W), 8, fmt, 32, axis=axis,
                        transport=transport, exact_scale=exact_scale)
        t = tpk.pack_mx(_t(W), 8, fmt, 32, axis=axis, transport=transport,
                        exact_scale=exact_scale)
        assert t.codes.dtype == {"emi8": torch.int8}.get(
            transport, tpk.container_dtype(fmt))
        np.testing.assert_array_equal(_codes_bits(t.codes),
                                      _codes_bits(j.codes))
        np.testing.assert_array_equal(t.scale_exp.numpy(),
                                      np.asarray(j.scale_exp))
        assert (t.orig_dim, t.axis, t.block_size) == (j.orig_dim, j.axis,
                                                      j.block_size)
        _same_as_jax(tpk.dequantize_mx(t).numpy(), jpk.dequantize_mx(j),
                     f"{fmt} {axis}")


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1", "int4"])
def test_dequantize_pack_equals_quantize_mx(fmt):
    """The reference identity dequantize(pack_mx(A)) == quantize_mx(A)
    (both keep the +1e-6 scale quirk)."""
    W = _weights(64, 48, seed=3)
    got = tpk.dequantize_mx(tpk.pack_mx(_t(W), 8, fmt, 16, axis=0))
    want = tmx.quantize_mx(_t(W), 8, fmt, axes=[0], block_size=16)
    assert_bitexact(got.numpy(), want.numpy(), fmt, ftz_ok=False)


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp6_e2m3", "fp4_e2m1"])
def test_emi8_decodes_to_native_values(fmt):
    W = _weights(64, 96, seed=1)
    a = tpk.dequantize_mx(tpk.pack_mx(_t(W), 8, fmt, 16, axis=0))
    b = tpk.dequantize_mx(tpk.pack_mx(_t(W), 8, fmt, 16, axis=0,
                                      transport="emi8"))
    assert_bitexact(b.numpy(), a.numpy(), fmt, ftz_ok=False)
    assert tpk.emi8_params(fmt) == jpk.emi8_params(fmt)
    assert tpk.emi8_fold(fmt) == jpk.emi8_fold(fmt)


def test_serving_layout_roundtrip_and_dequant():
    W = _weights(200, 130, seed=2)          # ragged K: padded to 224
    t = tpk.pack_mx(_t(W), 8, "fp6_e3m2", 32, axis=0, transport="emi8")
    s = tpk.to_serving_layout(t)
    assert tuple(s.codes.shape) == (7, 32, 130)
    assert tuple(s.scale_exp.shape) == (7, 130)
    j = jpk.to_serving_layout(jpk.pack_mx(jnp.asarray(W), 8, "fp6_e3m2", 32,
                                          axis=0, transport="emi8"))
    np.testing.assert_array_equal(s.codes.numpy(), np.asarray(j.codes))
    back = tpk.from_serving_layout(s)
    assert torch.equal(back.codes, t.codes)
    assert torch.equal(back.scale_exp, t.scale_exp)
    assert_bitexact(tpk.dequantize_mx(s, torch.float32).numpy(),
                    tpk.dequantize_mx(t).numpy(), "serving", ftz_ok=False)
    assert tpk.dequantize_mx(s, torch.bfloat16).dtype == torch.bfloat16
    assert s.bits_per_element == 8 + 8 / 32


def test_unported_transports_raise():
    """Every pack_mx transport is ported (tests/test_torch_outlier.py holds
    them bit-exact) and every one has a CUDA decode, the float8 containers
    included (fp6 codes packed "native" sit in float8_e4m3fn); a transport
    that pack_mx does not make (emi8m comes from merge_outlier_emi8) or a
    format that does not match its transport raises as in JAX."""
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    W = _t(_weights(64, 32))
    for fmt, tr in (("int4", "sb4"), ("fp6_e3m2", "pf6"), ("int8", "native")):
        p = tpk.to_serving_layout(tpk.pack_mx(W, 8, fmt, 32, axis=0,
                                              transport=tr))
        assert dm.sad_decode_params(p)[0] == tr
    for fmt, decode in (("fp6_e3m2", "fp8_e4m3"), ("fp8_e5m2", "fp8_e5m2")):
        p = tpk.to_serving_layout(tpk.pack_mx(W, 8, fmt, 32, axis=0))
        assert dm.sad_decode_params(p) == (decode, 0, 0, 0)
    with pytest.raises(ValueError, match="unknown transport"):
        tpk.pack_mx(W, 8, "int4", 32, axis=0, transport="emi8m")
    with pytest.raises(ValueError, match="matching fp format"):
        tpk.pack_mx(W, 8, "int4", 32, axis=0, transport="pf6")
