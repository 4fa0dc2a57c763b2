"""The port's posit codec (microscopiq_tpu_torch.posit) against the JAX
package's on the same numpy inputs: codes, values, arithmetic, the fast
sigmoid and the wrapper bit for bit (NaN as NaN), with (nbits, es) in
{(8,0), (8,1), (8,2), (16,1), (16,2)}, and the cases of tests/test_posit.py
on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu import posit as jposit
from microscopiq_tpu.posit.posit import _sorted_table
from microscopiq_tpu_torch import posit as tposit

CONFIGS = [(8, 0), (8, 1), (8, 2), (16, 1), (16, 2)]


def _inputs(nbits, es, seed=0):
    """Ties (midpoints of adjacent posits), the posits themselves, +-0,
    NaN, +-inf, values past maxpos and below minpos, and random values
    over the whole range, as float32."""
    vals, _ = _sorted_table(nbits, es)
    v = vals.astype(np.float32)
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    pos = v[v > 0]
    rng = np.random.default_rng(seed)
    rand = (rng.standard_normal(4096) * np.exp(rng.uniform(
        np.log(pos.min()) * 1.2, np.log(pos.max()) * 1.2, 4096))
            ).astype(np.float32)
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf,
                        pos.max() * 4, -pos.max() * 4, pos.min() / 4,
                        -pos.min() / 4, pos.min() / 2, -pos.min() / 2,
                        np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                       np.float32)
    return np.concatenate([v, mids, rand, special])


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    na, nb = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(na, nb)
    np.testing.assert_array_equal(a[~na].view(np.uint8),
                                  b[~nb].view(np.uint8))


@pytest.mark.parametrize("nbits,es", CONFIGS)
def test_table_is_jax_table(nbits, es):
    a, b = tposit.posit_table(nbits, es), jposit.posit_table(nbits, es)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nbits,es", CONFIGS)
def test_quantize_encode_decode_bit_exact(nbits, es):
    x = _inputs(nbits, es)
    q_j = np.asarray(jposit.quantize_posit(jnp.asarray(x), nbits, es))
    q_t = tposit.quantize_posit(torch.from_numpy(x), nbits, es).numpy()
    _bits_equal(q_t, q_j)
    c_j = np.asarray(jposit.encode_posit(jnp.asarray(x), nbits, es))
    c_t = tposit.encode_posit(torch.from_numpy(x), nbits, es)
    assert c_t.dtype == (torch.uint8 if nbits == 8 else torch.uint16)
    np.testing.assert_array_equal(c_t.to(torch.int64).numpy(),
                                  c_j.astype(np.int64))
    # every encoding decodes alike, NaR as NaN
    codes = np.arange(1 << nbits, dtype=np.int32)
    d_j = np.asarray(jposit.decode_posit(jnp.asarray(codes), nbits, es))
    d_t = tposit.decode_posit(torch.from_numpy(codes), nbits, es).numpy()
    _bits_equal(d_t, d_j)
    # the codes the port made decode to its fake-quant values
    _bits_equal(tposit.decode_posit(c_t, nbits, es).numpy(), q_t)


@pytest.mark.parametrize("nbits,es", CONFIGS)
def test_quantize_keeps_the_input_dtype(nbits, es):
    x = _inputs(nbits, es)[:512]
    for jd, td in ((jnp.bfloat16, torch.bfloat16),
                   (jnp.float16, torch.float16)):
        xj = jnp.asarray(x).astype(jd)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)
        got = tposit.quantize_posit(xt, nbits, es)
        assert got.dtype == td
        _bits_equal(got.float().numpy(), np.asarray(
            jposit.quantize_posit(xj, nbits, es).astype(jnp.float32)))


@pytest.mark.parametrize("nbits,es", CONFIGS)
def test_arithmetic_bit_exact(nbits, es):
    rng = np.random.default_rng(nbits + es)
    a = np.concatenate([rng.standard_normal(512) * 4,
                        [0.0, 1.0, -1.0, np.inf, np.nan, 3.0]]
                       ).astype(np.float32)
    b = np.concatenate([rng.standard_normal(512) * 4,
                        [0.0, 0.0, -0.0, 1.0, 2.0, np.inf]]
                       ).astype(np.float32)
    for name in ("posit_add", "posit_sub", "posit_mul", "posit_div"):
        want = np.asarray(getattr(jposit, name)(jnp.asarray(a),
                                                jnp.asarray(b), nbits, es))
        got = getattr(tposit, name)(torch.from_numpy(a), torch.from_numpy(b),
                                    nbits, es).numpy()
        _bits_equal(got, want)


@pytest.mark.parametrize("nbits,es", CONFIGS)
def test_sigmoid_bit_exact(nbits, es):
    x = _inputs(nbits, es)
    want = np.asarray(jposit.posit_sigmoid(jnp.asarray(x), nbits, es))
    got = tposit.posit_sigmoid(torch.from_numpy(x), nbits, es).numpy()
    _bits_equal(got, want)


@pytest.mark.parametrize("nbits,es", CONFIGS)
def test_wrapper_bit_exact(nbits, es):
    x = np.linspace(-5, 5, 41)                       # float64, as numpy
    pj, pt = jposit.Posit(nbits, es), tposit.Posit(nbits, es, device="cpu")
    _bits_equal(pt(x).numpy(), np.asarray(pj(x)))
    cj, ct = np.asarray(pj.set_float(x)), pt.set_float(x)
    np.testing.assert_array_equal(ct.to(torch.int64).numpy(),
                                  cj.astype(np.int64))
    _bits_equal(pt.to_float(ct).numpy(), np.asarray(pj.to_float(cj)))


# --- the cases of tests/test_posit.py, on the port ---------------------
@pytest.mark.parametrize("nbits,es", [(8, 0), (8, 1), (8, 2), (16, 1),
                                      (6, 1), (4, 0)])
def test_table_monotonic_in_twos_complement(nbits, es):
    vals = tposit.posit_table(nbits, es)
    n = 1 << nbits
    signed = np.arange(n)
    signed = np.where(signed >= n // 2, signed - n, signed)
    v = vals[np.argsort(signed)]
    v = v[~np.isnan(v)]
    assert (np.diff(v) > 0).all()


def test_known_posit8_values():
    vals = tposit.posit_table(8, 0)
    assert vals[0] == 0.0 and np.isnan(vals[128])
    assert np.nanmax(vals) == 64.0
    assert vals[vals > 0].min() == 2.0 ** -6
    assert vals[1] == 2.0 ** -6 and vals[127] == 64.0
    assert np.nanmax(tposit.posit_table(8, 1)) == 4096.0


@pytest.mark.parametrize("nbits,es", [(8, 1), (16, 1), (8, 0)])
def test_roundtrip(nbits, es):
    vals = tposit.posit_table(nbits, es)
    vals = vals[~np.isnan(vals)].astype(np.float32)
    codes = tposit.encode_posit(torch.from_numpy(vals), nbits, es)
    back = tposit.decode_posit(codes, nbits, es).numpy()
    np.testing.assert_array_equal(back, vals)


def test_quantize_picks_nearest():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(512).astype(np.float32) * 10
    q = tposit.quantize_posit(torch.from_numpy(x), 8, 1).numpy()
    vals = tposit.posit_table(8, 1)
    vals = np.sort(vals[~np.isnan(vals)])
    d = np.abs(x[:, None] - vals[None, :].astype(np.float32))
    nearest = vals[np.argmin(d, 1)].astype(np.float32)
    np.testing.assert_allclose(np.abs(q - x), np.abs(nearest - x),
                               rtol=1e-6, atol=0)


def test_arithmetic_closed_on_grid():
    rng = np.random.default_rng(1)
    a = tposit.quantize_posit(torch.from_numpy(
        rng.standard_normal(64).astype(np.float32)), 8, 1)
    b = tposit.quantize_posit(torch.from_numpy(
        rng.standard_normal(64).astype(np.float32)), 8, 1)
    grid = tposit.posit_table(8, 1)
    grid = set(np.round(grid[~np.isnan(grid)], 10).tolist())
    for r in (tposit.posit_add(a, b, 8, 1), tposit.posit_mul(a, b, 8, 1)):
        assert all(np.round(float(v), 10) in grid for v in r)


def test_fast_sigmoid_approximates():
    x = torch.linspace(-6, 6, 25)
    y = tposit.posit_sigmoid(x, 8, 0).numpy()
    ref = 1 / (1 + np.exp(-x.numpy()))
    assert np.abs(y - ref).max() < 0.08
    assert (np.diff(y) >= 0).all()


def test_posify_wrapper():
    p = tposit.Posit(8, 1, device="cpu")
    x = torch.linspace(-5, 5, 11)
    q = p(x)
    assert q.shape == x.shape
    codes = p.set_float(x)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(p.to_float(codes).numpy(), q.numpy())
