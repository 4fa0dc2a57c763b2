"""Port GEAR/KIVI codecs (microscopiq_tpu_torch.kv.gear) and
CompressionConfig against the JAX functions and tests/golden/gear.npz, on
the same seeded numpy inputs; mirrors tests/test_kv.py:41-147.

Tolerances:
- group, channel and uniform codecs: the golden's rtol/atol 1e-5 (and
  1e-4 for the true codecs), and against JAX within one f32 ulp of the
  scale (eager JAX divides by 2^bits - 1, as the port does);
- codes of the true codecs: equal, but for one code step where (x - mn) /
  scale lies within an ulp of a rounding boundary;
- power iterations: the port starts from JAX's uniform(PRNGKey(7)) matrix
  (a patched ``lowrank_start``); the low-rank products q @ p^T
  and the restored tensors agree within atol 2e-5 / rtol 1e-4 (QR may pick
  other column signs, so the factors are never compared);
- top-k (GEAR-S and the outlier side-band): restored values and sorted
  outlier values are equal; the inputs have no ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.kv import config as jconfig
from microscopiq_tpu.kv import gear as jg
from microscopiq_tpu_torch.kv import CompressionConfig
from microscopiq_tpu_torch.kv import gear as tg

LR = dict(atol=2e-5, rtol=1e-4)


def _x(seed, shape=(1, 2, 32, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.tensor(np.array(a))


def _jstart(B, F, rank):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (B, F, rank),
                                         jnp.float32))


@pytest.fixture
def jax_start(monkeypatch):
    """The port's power iterations start from JAX's matrix."""
    monkeypatch.setattr(tg, "lowrank_start",
                        lambda B, F, r, device: _t(_jstart(B, F, r)))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(tol or dict(rtol=1e-6, atol=1e-6)))


# ---------------- golden fixtures ----------------
def test_golden_group_codecs(golden_gear):
    x = _t(golden_gear["x"])
    for key, got in (("token4_g32", tg.fake_token_group_quant(x, 4, 32)),
                     ("token2_g64", tg.fake_token_group_quant(x, 2, 64)),
                     ("chan4_g32", tg.fake_channel_group_quant(x, 4, 32)),
                     ("uniform4", tg.fake_uniform_quant(x, 4))):
        np.testing.assert_allclose(got.numpy(), golden_gear[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_golden_dense_sparse_and_true_uniform(golden_gear):
    x = _t(golden_gear["x"])
    got = tg.fake_dense_sparse_quant(x, 4, 0.05).numpy()
    want = golden_gear["densesparse4"]
    assert np.abs(got - want).max() <= (want.max() - want.min()) / 15 + 1e-5
    for bits, key in ((4, "true_u4_dec"), (8, "true_u8_dec")):
        dec = tg.true_uniform_decompress(tg.true_uniform_compress(x, bits))
        np.testing.assert_allclose(dec.numpy(), golden_gear[key], rtol=1e-5,
                                   atol=1e-4)


# ---------------- simulated codecs against JAX ----------------
@pytest.mark.parametrize("name,args", [
    ("fake_token_group_quant", (4, 32)),
    ("fake_token_group_quant", (2, 16)),
    ("fake_channel_group_quant", (4, 8)),
    ("fake_channel_group_quant", (8, 32)),
    ("fake_uniform_quant", (4,)),
    ("fake_dense_sparse_quant", (4, 0.05)),
    ("gears_token_quant", (2, 16, 0.05)),
    ("gears_channel_quant", (4, 8, 0.05)),
])
def test_simulated_codec_matches_jax(name, args):
    x = _x(1)
    want = getattr(jg, name)(jnp.asarray(x), *args)
    got = getattr(tg, name)(_t(x), *args)
    scale = (x.max() - x.min()) / (2 ** args[0] - 1)
    diff = np.abs(got.numpy() - np.asarray(want))
    # equal but where a value sits within an ulp of a rounding boundary
    assert (diff <= 1e-5).mean() > 0.999
    assert diff.max() <= scale + 1e-5


@pytest.mark.parametrize("name,args", [
    ("gearl_token_quant", (4, 32, 2, 3)),
    ("gearl_channel_quant", (4, 8, 3, 2)),
    ("gearsl_token_quant", (2, 16, 0.05, 2, 3)),
    ("gearsl_channel_quant", (4, 8, 0.05, 2, 3)),
])
def test_gear_lowrank_codecs_match_jax(name, args, jax_start):
    x = _x(2)
    want = getattr(jg, name)(jnp.asarray(x), *args)
    got = getattr(tg, name)(_t(x), *args)
    _close(got, want, **LR)


def test_power_iteration_product_matches_jax(monkeypatch):
    err = _x(3, (2, 2, 24, 8))
    want = jg.power_iteration_lowrank(jnp.asarray(err), 3, 4)
    # the port's own start: a rank-4 fit of the same quality
    own = tg.power_iteration_lowrank(_t(err), 3, 4)
    res = lambda a: float(np.linalg.norm(err - np.asarray(a)))
    assert res(own) <= 1.05 * res(want)
    monkeypatch.setattr(tg, "lowrank_start",
                        lambda B, F, r, device: _t(_jstart(B, F, r)))
    _close(tg.power_iteration_lowrank(_t(err), 3, 4), want, **LR)


@pytest.mark.parametrize("method", [
    "channelQfixed", "tokenQfixed", "kcvtQfixed", "KIVI", "GEARL-KIVI",
    "GEARS-KIVI", "Flexgen", None, "None"])
@pytest.mark.parametrize("preserve", [False, True])
def test_compress_insert_matches_jax(method, preserve, jax_start):
    kw = dict(compress_method=method, attention_number=2, quantize_bit=4,
              group_size=16, rank=2, loop=2, left=0.05)
    if preserve:
        kw.update(token_preserving=True, start_saving=0.125,
                  locality_saving=0.125)
    jcfg = jconfig.CompressionConfig(**kw).copy_for_all_attention()
    tcfg = CompressionConfig(**kw).copy_for_all_attention()
    k, v = _x(4, (1, 2, 64, 16)), _x(5, (1, 2, 64, 16))
    if preserve and method in ("channelQfixed", "kcvtQfixed"):
        # the window is shorter than the group of seq_len tokens: both raise
        with pytest.raises(ValueError):
            jg.compress_insert(jnp.asarray(k), jnp.asarray(v), jcfg, 1)
        with pytest.raises(ValueError):
            tg.compress_insert(_t(k), _t(v), tcfg, 1)
        return
    jk, jv = jg.compress_insert(jnp.asarray(k), jnp.asarray(v), jcfg, 1)
    tk, tv = tg.compress_insert(_t(k), _t(v), tcfg, 1)
    _close(tk, jk, **LR)
    _close(tv, jv, **LR)
    if method in (None, "None"):
        assert np.array_equal(tk.numpy(), k)


def test_compress_insert_unknown_method_raises():
    cfg = CompressionConfig(compress_method="H2O",
                            attention_number=1).copy_for_all_attention()
    with pytest.raises(ValueError, match="unknown compress_method"):
        tg.compress_insert(_t(_x(6)), _t(_x(7)), cfg, 0)


# ---------------- true compression against JAX ----------------
def test_pack_halves_match_jax():
    u = np.random.default_rng(8).integers(0, 16, 128).astype(np.uint8)
    got = tg.pack_4bit_halves(_t(u))
    assert np.array_equal(got.numpy(),
                          np.asarray(jg.pack_4bit_halves(jnp.asarray(u))))
    assert np.array_equal(tg.unpack_4bit_halves(got).numpy(), u)


@pytest.mark.parametrize("bits", [4, 8])
def test_true_uniform_matches_jax(bits):
    x = _x(9)
    jc = jg.true_uniform_compress(jnp.asarray(x), bits)
    tc = tg.true_uniform_compress(_t(x), bits)
    assert tc.codes.dtype == torch.uint8 and tc.shape == jc.shape
    codes = lambda c: (tg.unpack_4bit_halves(_t(c)) if bits == 4
                       else _t(c)).numpy().astype(int)
    assert np.abs(codes(tc.codes) - codes(jc.codes)).max() <= 1
    assert (codes(tc.codes) == codes(jc.codes)).mean() > 0.999
    assert float(tc.mn) == float(jc.mn) and float(tc.scale) == float(
        jc.scale)
    with pytest.raises(ValueError):
        tg.true_uniform_compress(_t(x), 2)


@pytest.mark.parametrize("bits", [4, 8])
def test_true_batchwise_matches_jax(bits):
    x = _x(10, (3, 2, 8, 8))
    jc = jg.true_uniform_compress_batchwise(jnp.asarray(x), bits)
    tc = tg.true_uniform_compress_batchwise(_t(x), bits)
    assert tc.codes.shape == jc.codes.shape
    np.testing.assert_array_equal(tc.mn.numpy(), np.asarray(jc.mn))
    step = float(np.asarray(jc.scale).max())
    np.testing.assert_allclose(
        tg.true_uniform_decompress_batchwise(tc).numpy(),
        np.asarray(jg.true_uniform_decompress_batchwise(jc)), atol=step)


def test_true_outlier_matches_jax():
    x = _x(11, (1, 2, 16, 8))
    jb, jv, ji = jg.true_outlier_compress(jnp.asarray(x), 4, 0.1)
    tb, tv, ti = tg.true_outlier_compress(_t(x), 4, 0.1)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(tv.numpy()), np.sort(np.asarray(jv)))
    np.testing.assert_array_equal(np.sort(ti.numpy()), np.sort(np.asarray(ji)))
    got = tg.true_outlier_decompress(tb, tv, ti).numpy()
    want = np.asarray(jg.true_outlier_decompress(jb, jv, ji))
    np.testing.assert_allclose(got, want, atol=float(jb.scale) + 1e-6)
    # preserved outliers are exact
    flat = x.ravel()
    np.testing.assert_array_equal(got.ravel()[ti.numpy()], flat[ti.numpy()])


def test_true_poweriteration_product_matches_jax(jax_start):
    err = _x(12, (2, 2, 16, 8))
    jp, jq = jg.true_poweriteration(jnp.asarray(err), 3, 2)
    tp, tq = tg.true_poweriteration(_t(err), 3, 2)
    assert tp.dtype == torch.float16 and tp.shape == jp.shape
    prod = lambda p, q: np.asarray(q, np.float32) @ np.swapaxes(
        np.asarray(p, np.float32), 1, 2)
    np.testing.assert_allclose(prod(tp.numpy(), tq.numpy()), prod(jp, jq),
                               atol=2e-3, rtol=2e-3)   # float16 factors


@pytest.mark.parametrize("left", [0.0, 0.05])
def test_true_gear_roundtrip_matches_jax(left, jax_start):
    x = _x(13, (1, 2, 32, 16))
    jgc = jg.true_gear_compress(jnp.asarray(x), 4, left=left, rank=4, loop=3)
    tgc = tg.true_gear_compress(_t(x), 4, left=left, rank=4, loop=3)
    np.testing.assert_array_equal(np.sort(tgc.out_values.numpy()),
                                  np.sort(np.asarray(jgc.out_values)))
    got = tg.true_gear_decompress(tgc).numpy()
    want = np.asarray(jg.true_gear_decompress(jgc))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    rel = np.linalg.norm(got - x) / np.linalg.norm(x)
    base = tg.true_uniform_decompress(tg.true_uniform_compress(_t(x), 4))
    assert rel < np.linalg.norm(base.numpy() - x) / np.linalg.norm(x)


# ---------------- functional properties (port alone) ----------------
def test_power_iteration_improves_error():
    rng = np.random.default_rng(14)
    B, H, S, D = 1, 2, 32, 16
    u = rng.standard_normal((B, S, 4)).astype(np.float32)
    v = rng.standard_normal((B, 4, H * D)).astype(np.float32)
    err = (u @ v).reshape(B, S, H, D).transpose(0, 2, 1, 3)
    err = err + 0.01 * rng.standard_normal(err.shape).astype(np.float32)
    approx = tg.power_iteration_lowrank(_t(err), loop=4, rank=4)
    assert np.linalg.norm(err - approx.numpy()) / np.linalg.norm(err) < 0.1


def test_gear_codecs_reduce_error_vs_plain():
    x = _t(_x(15, (1, 4, 64, 32)))
    plain = tg.fake_token_group_quant(x, 2, 64)
    gl = tg.gearl_token_quant(x, 2, 64, rank=4, loop=3)
    assert torch.linalg.norm(x - gl) < torch.linalg.norm(x - plain)
    xo = x.clone()
    xo[0, 0, 5, 3] = 40.0
    gs = tg.gears_token_quant(xo, 2, 64, sparsity=0.01)
    assert abs(float(gs[0, 0, 5, 3]) - 40.0) < 1e-4


def test_top_k_ties_take_the_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    vals, idx = tg._top_k(x, 2)
    assert idx.tolist() == [[1, 2]] and vals.tolist() == [[3.0, 3.0]]


# ---------------- CompressionConfig ----------------
@pytest.mark.parametrize("kw", [
    dict(),
    dict(compress_method="KIVI", quantize_bit=2, group_size=32),
    dict(compress_method="GEARL-KIVI", rank=0.02, group_size=64),
    dict(compress_method="GEARS-KIVI", left=0.02, rank=4),
    dict(compress_method="Flexgen", quantize_bit=8, group_size=0),
])
@pytest.mark.parametrize("per_layer", [False, True])
def test_compression_config_matches_jax(kw, per_layer):
    j = jconfig.CompressionConfig(attention_number=3, **kw)
    t = CompressionConfig(attention_number=3, **kw)
    if per_layer:
        j.copy_for_all_attention()
        t.copy_for_all_attention()
        assert t["quantize_bit"] == j["quantize_bit"] == [
            kw.get("quantize_bit", 4)] * 3
    for seq, dim in ((2048, 4096), (3072, 1024)):
        assert t.compress_ratio(seq, dim) == j.compress_ratio(seq, dim)
