"""The decode-GEMV experiments of the port (``ops/cuda/exp_gemv.py``,
``scripts/exp_decode_variants.py``, ``exp_sad_tiles.py``,
``exp_nb_variants.py``) on the CPU, against the JAX package.

The TPU kernels of those scripts are closures behind a TPU check, so the
port's plain versions are held to what the scripts hold their kernels to,
on the same weights packed by both packages:
- the decode variants (i32, i16, ebf8, f32dot) and the tile sweep: JAX's
  ``dequant_matmul_sad`` in interpret mode (1e-5 of max |y|: exact f32
  products, sums in another order) and ``dequant_matmul_reference`` (1e-6,
  the same bf16 weights);
- the ebf8 re-encode: bit for bit the script's numpy (a copy of
  ``scripts/exp_decode_variants.py:58-68`` below);
- the NB modes: JAX's ``dequant_matmul_nb`` in interpret mode (3e-6 of max
  |y|, tests/test_packing.py's bound) and ``dequant_matmul_nb_reference``
  (1e-6); each ablation the same computation in ``jnp`` on the JAX-packed
  arrays (1e-6).
On the CPU each wrapper runs its plain version and counts no launch; the
kernels are held to these plain versions on a card by
tests/test_torch_kernels_gpu.py.
"""

import contextlib
import dataclasses
import io
import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.outlier import (
    quantize_mx_outlier_hessian_decisions as j_decisions)
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul_nb as j_nb, dequant_matmul_nb_reference as j_nb_ref,
    dequant_matmul_reference as j_reference, dequant_matmul_sad as j_sad)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
from microscopiq_tpu_torch.ops.cuda import exp_gemv as eg
from microscopiq_tpu_torch.scripts import (_gemv, _prefill,
                                           exp_decode_variants,
                                           exp_nb_variants, exp_sad_tiles)

K, N, M = 256, 512, 8
NB_K = NB_N = 256
SCRIPTS = {m.NAME: m for m in (exp_decode_variants, exp_sad_tiles,
                               exp_nb_variants)}
SMALL = {exp_decode_variants.NAME: dict(K=K, N=N),
         exp_sad_tiles.NAME: dict(K=K, N=N),
         exp_nb_variants.NAME: dict(K=NB_K, N=NB_N)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def numpy_ebf8(codes, mw):
    """scripts/exp_decode_variants.py:58-68, as the script has it."""
    cn = np.asarray(codes).astype(np.int32)
    mhat = cn >> (8 - mw)
    eprime = cn & ((1 << (8 - mw)) - 1)
    val = (mhat << eprime).astype(np.float64)      # integer values, exact
    m48, e48 = np.frexp(np.abs(val))               # |val| = m48 * 2^e48
    frac = np.where(val != 0, np.round((m48 * 2 - 1) * 4), 0).astype(np.int32)
    E = np.where(val != 0, e48, 0).astype(np.int32)  # 1..18 -> 5 bits
    assert E.max() < 32 and frac.max() < 4
    sgn = (val < 0).astype(np.int32)
    return ((sgn << 7) | (E << 2) | frac).astype(np.uint8).view(np.int8)


@pytest.fixture(scope="module")
def emi8_pair():
    """The decode script's weight at a small shape (W ~ N(0, 0.02), MX-FP6
    emi8, block 32), packed by both packages, and x."""
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    j = jpk.to_serving_layout(jpk.pack_mx(jnp.asarray(W), 8, "fp6_e3m2", 32,
                                          axis=0, transport="emi8"))
    t = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, "fp6_e3m2",
                                          32, axis=0, transport="emi8"))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.scale_exp.numpy(), np.asarray(j.scale_exp))
    x = rng.standard_normal((M, K)).astype(np.float32)
    return j, t, x


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "fp4_e2m1"])
def test_ebf8_reencode_is_the_scripts_numpy(fmt):
    rng = np.random.default_rng(1)
    W = (rng.standard_normal((128, 96))
         * np.exp(rng.uniform(-3, 3, (1, 96)))).astype(np.float32)
    w = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, fmt, 32,
                                          axis=0, transport="emi8"))
    mw = tpk.emi8_params(fmt)[0]
    got = eg.ebf8_encode(w.codes, mw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), numpy_ebf8(w.codes, mw))
    wb = eg.ebf8_weight(w)
    assert wb.transport == "ebf8" and wb.transport_mw == mw
    assert wb.transport_fold == tpk.emi8_fold(fmt) - 126
    # the bytes' bf16 values are the emi8 weight times 2^-126; the fold
    # puts the 2^126 back, bit for bit
    assert torch.equal(eg.variant_weight(wb, "ebf8"),
                       eg.variant_weight(w, "i32"))


def test_ebf8_reencode_refuses_what_two_fraction_bits_cannot_hold():
    """fp6_e2m3's emi8 mantissas reach 4 significant bits: the script's
    numpy asserts there, the port raises."""
    W = np.random.default_rng(2).standard_normal((64, 32)).astype(np.float32)
    w = tpk.to_serving_layout(tpk.pack_mx(torch.from_numpy(W), 8, "fp6_e2m3",
                                          32, axis=0, transport="emi8"))
    mw = tpk.emi8_params("fp6_e2m3")[0]
    with pytest.raises(AssertionError):
        numpy_ebf8(w.codes, mw)
    with pytest.raises(ValueError, match="fraction bits"):
        eg.ebf8_encode(w.codes, mw)


@pytest.mark.parametrize("variant", ["i32", "i16", "ebf8", "f32dot"])
def test_variant_plain_matches_jax_sad(emi8_pair, variant):
    j, t, x = emi8_pair
    w = eg.ebf8_weight(t) if variant == "ebf8" else t
    eg.reset_launch_counts()
    y = eg.gemv_variant(torch.from_numpy(x), w, variant).numpy()
    assert not any(eg.launch_counts.values())
    assert y.shape == (M, N) and y.dtype == np.float32
    assert _rel(y, j_sad(jnp.asarray(x), j, interpret=True)) < 1e-5
    assert _rel(y, j_reference(jnp.asarray(x), j)) < 1e-6
    np.testing.assert_array_equal(
        y, eg.gemv_variant(torch.from_numpy(x), t, "i32").numpy())


def test_zero_variant_is_the_codes_as_values(emi8_pair):
    """The floor multiplies the codes themselves, scaled per block: wrong
    numerics on purpose, held to that computation in numpy."""
    _, t, x = emi8_pair
    codes = t.codes.numpy().astype(np.float64)               # (NB, B, N)
    scale = np.exp2(t.scale_exp.numpy().astype(np.float64)
                    - tpk.emi8_fold("fp6_e3m2"))
    dense = (codes * scale[:, None, :]).reshape(K, N)
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    y = eg.gemv_variant(torch.from_numpy(x), t, "zero").numpy()
    assert _rel(y, xb @ dense) < 1e-6
    assert _rel(y, eg.gemv_variant(torch.from_numpy(x), t, "i32")) > 0.1


def test_tiles_plain_matches_jax_sad(emi8_pair):
    j, t, x = emi8_pair
    y_j = np.asarray(j_sad(jnp.asarray(x), j, interpret=True))
    eg.reset_launch_counts()
    for mt, tn, kb in eg.TILES:
        y = eg.gemv_tiles(torch.from_numpy(x), t, mt=mt, tn=tn, kb=kb)
        assert torch.equal(y, dm.dequant_matmul_reference(
            torch.from_numpy(x), t))
        assert _rel(y.numpy(), y_j) < 1e-5
    assert not any(eg.launch_counts.values())


def test_compiled_tiles_are_the_sources():
    """exp_gemv.TILES lists what csrc/exp_gemv.cu compiles, the shipped
    GEMV's (8, 512, 7) among them, 256-2048 columns and 4-128 K blocks."""
    src = (pathlib.Path(eg.build.CSRC) / "exp_gemv.cu").read_text()
    block = src[src.index("#define MXQ_EXP_TILES"):]
    block = block[:block.index("\n\n")]
    got = tuple(tuple(int(v) for v in m) for m in
                re.findall(r"X\((\d+), (\d+), (\d+)\)", block))
    assert got == eg.TILES
    assert (8, 512, 7) in eg.TILES and len(set(eg.TILES)) == len(eg.TILES)
    assert {t[1] for t in eg.TILES} == {256, 512, 1024, 2048}
    assert min(t[2] for t in eg.TILES) == 4 and max(t[2] for t in eg.TILES) \
        == 128
    assert "exp_gemv" in eg.build.SOURCES


def test_split_of_each_tile_depends_on_shape_only():
    """The shipped GEMV's K split at (4096, 28672) is (8, 512, 7)'s."""
    assert dm.gemv_ksplit(28672, 128) == (19, 7)
    assert -(-128 // 7) == 19


def test_wrappers_refuse_bad_configurations(emi8_pair):
    _, t, x = emi8_pair
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="not compiled"):
        eg.gemv_variant(xt, t, "i8")
    with pytest.raises(ValueError, match="ebf8_weight"):
        eg.gemv_variant(xt, t, "ebf8")
    with pytest.raises(ValueError, match="emi8"):
        eg.gemv_variant(xt, eg.ebf8_weight(t), "i32")
    with pytest.raises(ValueError, match="not compiled"):
        eg.gemv_tiles(xt, t, mt=8, tn=64, kb=7)
    with pytest.raises(ValueError, match="emi8"):
        eg.gemv_tiles(xt, tpk.to_serving_layout(tpk.pack_mx(
            torch.randn(K, N), 8, "int8", 32, axis=0)), mt=8, tn=512, kb=7)
    # block 64: (8, 2048, 128) stages 8 x 8192 f32 of x, past 227 KB
    w64 = tpk.to_serving_layout(tpk.pack_mx(torch.randn(8192, 64), 8,
                                            "fp6_e3m2", 64, axis=0,
                                            transport="emi8"))
    assert eg.tiles_smem(8, 128, 64) > eg.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        eg.gemv_tiles(torch.zeros(8, 8192), w64, mt=8, tn=2048, kb=128)
    with pytest.raises(ValueError, match="x must be"):
        eg.gemv_tiles(xt[:, :128], t, mt=8, tn=512, kb=7)


# ---------------------------------------------------------------------------
# the compact NB modes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nb_pair():
    """The NB script's weight at a small shape: N(0, 0.02) with 3% x10,
    int2 + fp4 at block 16, 2-sigma "max" decisions from the JAX package on
    the (N, K) transpose, budget 2, packed by both packages; and x."""
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((NB_K, NB_N)) * 0.02).astype(np.float32)
    W[rng.random((NB_K, NB_N)) < 0.03] *= 10.0
    _, _, dec = j_decisions(jnp.asarray(W.T), 8, 8, "int2", "fp4_e2m1", "max",
                            2.0, [0], 16, max_outliers_per_block=2)
    dec["block_size"] = 16
    j = jpk.pack_outlier_nb(dec, budget=2)
    t = tpk.pack_outlier_nb({k: (torch.from_numpy(np.array(v))
                                 if hasattr(v, "shape") else v)
                             for k, v in dec.items()}, budget=2)
    for f in ("codes", "scale_exp", "out_byte", "out_scale_exp"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    x = rng.standard_normal((M, NB_K)).astype(np.float32)
    return j, t, x


def jnp_parts(j):
    """The (N, K) codes, inliers and outliers of a JAX-packed NB weight, as
    the TPU kernel _fd_kernel decodes them (scripts/exp_nb_variants.py:
    77-114): field i of code byte row 4b + r is row 16b + 4i + r; a slot
    byte is pos << 4 | fp4, its value 2 * fp4 * 2^(seo - se - 1)."""
    c = jnp.asarray(j.codes).astype(jnp.int32)                  # (Np/4, K)
    nb, k = c.shape[0] // 4, c.shape[1]
    c4 = c.reshape(nb, 4, k)                                    # [b, r, k]
    fields = [lax.shift_right_arithmetic(lax.shift_left(c4, 30 - 2 * i), 30)
              for i in range(4)]
    codes = jnp.stack(fields, axis=1).reshape(nb * 16, k).astype(jnp.float32)
    se = jnp.asarray(j.scale_exp).astype(jnp.int32)             # (nb, k)
    seo = jnp.asarray(j.out_scale_exp).astype(jnp.int32)
    sc = jnp.repeat(jnp.exp2(se.astype(jnp.float32)), 16, axis=0)
    osc = jnp.exp2((seo - se - 1).astype(jnp.float32))
    row = jnp.arange(16)[None, :, None]
    out = jnp.zeros((nb, 16, k), jnp.float32)
    for s in range(j.out_byte.shape[0]):
        b = jnp.asarray(j.out_byte)[s].astype(jnp.int32) & 0xFF
        pos, e, m, sgn = b >> 4, (b >> 1) & 3, b & 1, (b >> 3) & 1
        mag = lax.shift_left(m + 2 * jnp.minimum(e, 1), jnp.maximum(e - 1, 0))
        val = (mag * (1 - 2 * sgn)).astype(jnp.float32) * osc
        out = out + jnp.where(row == pos[:, None, :], val[:, None, :], 0.0)
    n = j.orig_n
    return {"codes": codes[:n], "inliers": (codes * sc)[:n],
            "outliers": out.reshape(nb * 16, k)[:n]}


def test_nb_parts_are_the_jax_decode(nb_pair):
    j, t, _ = nb_pair
    mine, theirs = tpk.outlier_nb_parts(t), jnp_parts(j)
    for part in ("codes", "inliers", "outliers"):
        np.testing.assert_array_equal(mine[part].numpy(),
                                      np.asarray(theirs[part]))
    assert (mine["outliers"] != 0).sum() > 0
    np.testing.assert_array_equal(
        (mine["inliers"] + mine["outliers"]).numpy(),
        np.asarray(jpk.dequantize_outlier_nb(j)))


@pytest.mark.parametrize("mode", eg.FULL_MODES)
def test_full_mode_plain_matches_jax_nb_kernel(nb_pair, mode):
    j, t, x = nb_pair
    eg.reset_launch_counts()
    y = eg.fd_matmul(torch.from_numpy(x), t, mode).numpy()
    assert not any(eg.launch_counts.values())
    assert y.shape == (M, NB_N)
    y_j = np.asarray(j_nb(jnp.asarray(x), j, interpret=True))
    assert np.abs(y - y_j).max() <= 3e-6 * np.abs(y_j).max()
    assert _rel(y, j_nb_ref(jnp.asarray(x), j)) < 1e-6


@pytest.mark.parametrize("mode", sorted(eg.ABLATIONS))
def test_ablation_plain_matches_jnp(nb_pair, mode):
    """Each ablation is x (bf16-rounded) times its part of the weight:
    in_only the scaled inliers, in_dot1 the raw codes, out_* the outliers,
    each done in jnp on the JAX-packed arrays."""
    j, t, x = nb_pair
    y = eg.fd_matmul(torch.from_numpy(x), t, mode, tk0=1024).numpy()
    xb = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    part = jnp_parts(j)[eg.ABLATIONS[mode]]
    want = np.asarray(jnp.dot(xb, part.T, precision=lax.Precision.HIGHEST))
    assert _rel(y, want) < 1e-6
    full = np.asarray(j_nb_ref(jnp.asarray(x), j))
    assert _rel(y, full) > 1e-3             # wrong on purpose


def test_nb_wrapper_refuses_bad_configurations(nb_pair):
    _, t, x = nb_pair
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="not compiled"):
        eg.fd_matmul(xt, t, "pdot4")
    with pytest.raises(ValueError, match="not compiled"):
        eg.fd_reference(xt, t, "cur")
    with pytest.raises(ValueError, match="multiple of 4"):
        eg.fd_matmul(xt, t, "pdot", tk0=130)
    with pytest.raises(ValueError, match="budget 9"):
        eg.fd_matmul(xt, dataclasses.replace(
            t, out_byte=t.out_byte.repeat(5, 1, 1)[:9]), "pdot")
    with pytest.raises(ValueError, match="int2 \\+ fp4"):
        eg.fd_matmul(xt, dataclasses.replace(t, elem_format="int4"), "fd")
    with pytest.raises(ValueError, match="one device"):
        eg.fd_matmul(xt, dataclasses.replace(
            t, out_byte=t.out_byte.to("meta")), "fd")


def test_k_span_halves_as_the_tpu_wrapper(nb_pair):
    _, t, _ = nb_pair
    assert eg._nb_checks(t, "pdot", 512) == 256
    assert eg._nb_checks(t, "pdot", 1024) == 256
    assert eg._nb_checks(t, "pdot", 128) == 128


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------
def _run_main(mod):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recs = mod.main([], device="cpu", M=M, **SMALL[mod.NAME])
    return recs, [json.loads(ln) for ln in buf.getvalue().splitlines()]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_main_on_cpu_prints_one_line_per_arm(name):
    mod = SCRIPTS[name]
    recs, lines = _run_main(mod)
    assert [ln for ln in lines if "arm" in ln] == recs
    assert [r["arm"] for r in recs] == [a.name for a in mod.arms()]
    assert recs[0]["arm"] == "dense" and recs[0]["rel_err"] is None
    K_, N_ = SMALL[name]["K"], SMALL[name]["N"]
    for r in recs:
        assert r["script"] == name and r["card"] == "cpu"
        assert (r["M"], r["K"], r["N"]) == (M, K_, N_)
        assert r["ms"] is None and r["codes_GBps"] is None
        assert r["bound_by"] == "bytes" and r["bound_ms"] > 0
        if r["arm"] != "dense":
            assert r["rel_err"] == 0.0 and r["out"] == "f32"
    kernels = {r["kernel"] for r in recs}
    assert kernels >= {k for k in eg.launch_counts
                       if k.startswith({"exp_decode_variants": "exp_gemv_",
                                        "exp_sad_tiles": "exp_gemv_tiles",
                                        "exp_nb_variants": "exp_nb_fd"}[name])
                       and (name != "exp_decode_variants"
                            or "tiles" not in k)}


def test_decode_variants_prints_parity():
    recs, lines = _run_main(exp_decode_variants)
    par = lines[-1]["parity"]
    assert par["exact"] and set(par["max_delta"]) == {"i16", "ebf8",
                                                      "f32dot"}
    assert all(v == 0.0 for v in par["max_delta"].values())
    assert {r["arm"] for r in recs if "parity_exact" in r} == {
        "i16", "ebf8", "f32dot"}


def test_nb_script_runs_every_mode_and_the_k1024_arms():
    arms = {a.name: a for a in exp_nb_variants.arms()}
    assert set(eg.MODES) | {"pdot_k1024", "pdot3_k1024", "cur", "dense"} \
        == set(arms)
    assert arms["pdot_k1024"].tiles == {"tk0": 1024}
    assert {a.plain_key for a in arms.values() if a.compared} == (
        {"nb"} | set(eg.ABLATIONS))


@pytest.fixture(scope="module")
def nb_records():
    return _run_main(exp_nb_variants)[0]


@pytest.mark.parametrize("mode", sorted(eg.MODES))
def test_nb_bound_counts_the_streams_the_mode_reads(nb_pair, nb_records,
                                                    mode):
    _, t, _ = nb_pair
    size = {f: getattr(t, f).numel() for f in ("codes", "scale_exp",
                                                "out_scale_exp", "out_byte")}
    want = {"in_only": size["codes"] + size["scale_exp"],
            "in_dot1": size["codes"],
            "out_only": t.nbytes() - size["codes"],
            "out_pdot": t.nbytes() - size["codes"]}.get(mode, t.nbytes())
    assert eg.fd_bytes(t, mode) == want
    rec = next(r for r in nb_records if r["arm"] == mode)
    M_, K_, N_ = rec["M"], rec["K"], rec["N"]
    setup = _gemv.nb_setup("cpu", M=M_, **SMALL["exp_nb_variants"])
    nb = setup.weights["nb"][0]
    moved = M_ * K_ * 2 + eg.fd_bytes(nb, mode) + M_ * N_ * 4
    assert rec["bound_ms"] == pytest.approx(
        moved / _prefill.HBM_BYTES_PER_S * 1e3, rel=1e-12)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_main_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRIPTS[name].main([])
