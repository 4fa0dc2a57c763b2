"""The port's outlier formats against the JAX package and the golden
fixtures, bit for bit: the two-level outlier quantizers
(``tests/golden/outlier.npz``), the raw fp-bit codec, sub-byte packing,
the side-band ``pack_mx_outlier``, the emi8m merge/absolute/rebase encoders
and the compact ``pack_outlier_nb`` transport. Every comparison is exact;
the only allowance is the FTZ rule of helpers.assert_bitexact (XLA flushes
subnormal float32 outputs, torch keeps them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_bitexact
from microscopiq_tpu.ops import outlier as jol
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu_torch import specs as tspecs
from microscopiq_tpu_torch.ops import outlier as tol
from microscopiq_tpu_torch.ops import packing as tpk

INPUTS = ["w2d", "w2d_outliers", "mat"]
CASES = [(ifmt, ofmt, bs)
         for (ifmt, ofmt) in [("int2", "fp4_e2m1"), ("fp6_e3m2", "fp8_e4m3")]
         for bs in [16, 32]]


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    """Raw bytes of a code array (numpy or torch) as int64, for exact
    compares of float8 and integer codes alike."""
    if isinstance(a, torch.Tensor):
        it = a.element_size()
        raw = a.contiguous().view({1: torch.uint8, 2: torch.int16,
                                   4: torch.int32}[it]).numpy()
        return raw.astype(np.int64) & ((1 << 8 * it) - 1)
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize]
                  ).astype(np.int64)


def _weights(k, n, seed, frac=0.03, gain=10.0):
    """N(0, 0.02) weights with a fraction of elements scaled up, as
    scripts/bench_outlier_gemv.py makes its outlier mass."""
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    W[rng.random((k, n)) < frac] *= gain
    return W


@pytest.mark.parametrize("variant", ["h", "v1", "op"])
@pytest.mark.parametrize("ifmt,ofmt,bs", CASES)
def test_outlier_quantizers_match_golden(golden_outlier, variant, ifmt, ofmt,
                                         bs):
    fn = {"h": tol.quantize_mx_outlier_hessian,
          "v1": tol.quantize_mx_outlier_v1,
          "op": tol.quantize_mx_outlier_op_v1}[variant]
    for name in INPUTS:
        key = f"{name}|{ifmt}|{ofmt}|bs{bs}"
        out = fn(_t(golden_outlier[f"in_{name}"]), 8, 8, ifmt, ofmt,
                 std_dev=2, axes=[0], block_size=bs)
        if variant == "h":
            out, n = out
            np.testing.assert_array_equal(n.numpy(),
                                          golden_outlier[f"hn|{key}"])
        assert_bitexact(out.numpy(), golden_outlier[f"{variant}|{key}"],
                        f"{variant}|{key}")


@pytest.mark.parametrize("cap", [0, 1, 2])
def test_decisions_match_jax(cap):
    A = _weights(64, 48, seed=cap)
    jq, jn, jd = jol.quantize_mx_outlier_hessian_decisions(
        jnp.asarray(A), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0], 16,
        max_outliers_per_block=cap)
    tq, tn, td = tol.quantize_mx_outlier_hessian_decisions(
        _t(A), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0], 16,
        max_outliers_per_block=cap)
    assert_bitexact(tq.numpy(), np.asarray(jq), "q")
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for k in ("inl_code", "out_code", "mask", "se_in", "se_out"):
        assert_bitexact(td[k].numpy(), np.asarray(jd[k]), k)
    if cap:
        assert (td["mask"].reshape(-1, 16, 48).sum(1) <= cap).all()


def test_op_wrapper_and_none_passthrough():
    A = _weights(32, 24, seed=3)
    spec = tspecs.finalize_mx_specs({"w_elem_format": "int2",
                                     "scale_bits": 8, "block_size": 16})
    got = tol.quantize_mx_outlier_op(_t(A), spec, "int2", "fp4_e2m1",
                                     axes=[-1])
    from microscopiq_tpu.specs import finalize_mx_specs as j_finalize
    want = jol.quantize_mx_outlier_op(
        jnp.asarray(A), j_finalize({"w_elem_format": "int2", "scale_bits": 8,
                                    "block_size": 16}),
        "int2", "fp4_e2m1", axes=[-1])
    assert_bitexact(got.numpy(), np.asarray(want), "op wrapper")
    a = _t(A)
    assert tol.quantize_mx_outlier_v1(a, 8, 8, None, "fp4", axes=[0],
                                      block_size=16) is a


def test_mx_assert_nan_guard(monkeypatch):
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((128, 4)) * 1000).astype(np.float32)
    A[0, 0] = 1e8
    monkeypatch.setattr(tspecs, "_ASSERT_MODE", "True")
    with pytest.raises(FloatingPointError, match="shared_exp_out"):
        tol.quantize_mx_outlier_hessian(_t(A), 8, 3, "int2", "fp4", "max",
                                        2.0, [0], 16)
    monkeypatch.setattr(tspecs, "_ASSERT_MODE", "False")
    tol.quantize_mx_outlier_hessian(_t(A), 8, 3, "int2", "fp4", "max", 2.0,
                                    [0], 16)


@pytest.mark.parametrize("fmt", ["fp4_e2m1", "fp6_e3m2", "fp6_e2m3",
                                 "fp8_e4m3", "fp8_e5m2"])
def test_fp_bits_codec_matches_jax(fmt):
    from microscopiq_tpu.ops.elemwise import quantize_elemwise_core
    from microscopiq_tpu.formats import get_format_params

    ebits, mbits, _, max_norm, _ = get_format_params(fmt)
    x = np.random.default_rng(1).standard_normal(2048).astype(np.float32) * 4
    x[:4] = [0.0, -0.0, 1e-6, -1e-6]
    q = np.asarray(quantize_elemwise_core(jnp.asarray(x), mbits, ebits,
                                          max_norm, saturate_normals=True))
    jc = np.asarray(jpk.encode_fp_bits(jnp.asarray(q), fmt))
    tc = tpk.encode_fp_bits(_t(q), fmt)
    assert tc.dtype == torch.uint8
    np.testing.assert_array_equal(tc.numpy(), jc)
    back = tpk.decode_fp_bits(tc, fmt).numpy()
    assert_bitexact(back, np.asarray(jpk.decode_fp_bits(jnp.asarray(jc),
                                                        fmt)), fmt)
    np.testing.assert_array_equal(np.abs(back), np.abs(q))


@pytest.mark.parametrize("per,bits", [(4, 2), (2, 4)])
def test_subbyte_pack_matches_jax(per, bits):
    rng = np.random.default_rng(per)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1))
    c = rng.integers(lo, hi, (5, 64)).astype(np.int8)
    t = tpk._subbyte_pack(_t(c), 16, per, bits)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jpk._subbyte_pack(jnp.asarray(c), 16, per,
                                                bits)))
    np.testing.assert_array_equal(tpk._subbyte_unpack(t, 16, per,
                                                      bits).numpy(), c)


@pytest.mark.parametrize("fmt,transport", [("int4", "sb4"), ("int2", "sb2"),
                                           ("fp4_e2m1", "pf4"),
                                           ("fp6_e3m2", "pf6"),
                                           ("fp6_e2m3", "pf6")])
def test_subbyte_transports_match_jax(fmt, transport):
    W = _weights(64, 40, seed=7, frac=0.0)
    j = jpk.pack_mx(jnp.asarray(W), 8, fmt, 32, axis=0, transport=transport)
    t = tpk.pack_mx(_t(W), 8, fmt, 32, axis=0, transport=transport)
    np.testing.assert_array_equal(_bits(t.codes), _bits(j.codes))
    np.testing.assert_array_equal(t.scale_exp.numpy(), np.asarray(j.scale_exp))
    assert t.bits_per_element == j.bits_per_element
    assert_bitexact(tpk.dequantize_mx(t).numpy(),
                    np.asarray(jpk.dequantize_mx(j)), transport)


@pytest.mark.parametrize("ifmt,ofmt,budget", [("int2", "fp4_e2m1", 4),
                                              ("int2", "fp4_e2m1", 1),
                                              ("fp6_e3m2", "fp8_e4m3", 2),
                                              ("int4", "int8", 2)])
@pytest.mark.parametrize("axis", [0, -1])
def test_pack_mx_outlier_matches_jax(ifmt, ofmt, budget, axis):
    W = _weights(96, 40, seed=budget)
    W[5, 3] = 0.0
    j = jpk.pack_mx_outlier(jnp.asarray(W), 8, 8, ifmt, ofmt, std_dev=2.0,
                            block_size=16, outlier_budget=budget, axis=axis)
    t = tpk.pack_mx_outlier(_t(W), 8, 8, ifmt, ofmt, std_dev=2.0,
                            block_size=16, outlier_budget=budget, axis=axis)
    for name in ("codes", "scale_exp"):
        np.testing.assert_array_equal(_bits(getattr(t.inlier, name)),
                                      _bits(getattr(j.inlier, name)))
    for name in ("out_codes", "out_pos", "out_scale_exp"):
        assert tuple(getattr(t, name).shape) == getattr(j, name).shape
        np.testing.assert_array_equal(_bits(getattr(t, name)),
                                      _bits(getattr(j, name)))
    assert t.budget == budget and t.inlier.orig_dim == j.inlier.orig_dim
    assert_bitexact(tpk.dequantize_mx_outlier(t).numpy(),
                    np.asarray(jpk.dequantize_mx_outlier(j)), "dequant")


def test_pack_mx_outlier_row_chunks_give_the_same_bytes(monkeypatch):
    W = _t(_weights(64, 48, seed=9))
    whole = tpk.pack_mx_outlier(W, 8, 8, "int2", "fp4", axis=0)
    monkeypatch.setattr(tpk, "_CHUNK_ELEMS", 100)
    chunked = tpk.pack_mx_outlier(W, 8, 8, "int2", "fp4", axis=0)
    for a, b in ((whole.inlier.codes, chunked.inlier.codes),
                 (whole.out_pos, chunked.out_pos),
                 (whole.out_codes.view(torch.uint8),
                  chunked.out_codes.view(torch.uint8))):
        assert torch.equal(a, b)
    m = tpk.merge_outlier_emi8(whole)
    monkeypatch.setattr(tpk, "_CHUNK_ELEMS", 1 << 24)
    assert torch.equal(m.codes, tpk.merge_outlier_emi8(whole).codes)


def _merge_cases():
    """The cases of tests/test_packing.py::test_emi8m_merge_lossless: the
    two-level int2+fp4 side-band at budget 4 and 2, on both axes."""
    return [(64, 48, 4, 0), (64, 48, 2, 0), (48, 64, 4, -1), (80, 32, 3, 0)]


@pytest.mark.parametrize("K,N,budget,axis", _merge_cases())
def test_merge_outlier_emi8_matches_jax(K, N, budget, axis):
    W = _weights(K, N, seed=K + budget)
    j = jpk.pack_mx_outlier(jnp.asarray(W), 8, 8, "int2", "fp4", std_dev=2.0,
                            block_size=16, outlier_budget=budget, axis=axis)
    t = tpk.pack_mx_outlier(_t(W), 8, 8, "int2", "fp4", std_dev=2.0,
                            block_size=16, outlier_budget=budget, axis=axis)
    jm = jpk.merge_outlier_emi8(j)
    tm = tpk.merge_outlier_emi8(t)
    assert (tm.transport, tm.transport_mw, tm.transport_fold) == (
        "emi8m", jm.transport_mw, jm.transport_fold)
    np.testing.assert_array_equal(tm.codes.numpy(), np.asarray(jm.codes))
    np.testing.assert_array_equal(tm.scale_exp.numpy(),
                                  np.asarray(jm.scale_exp))
    # lossless: the merged stream decodes to the side-band's values
    assert_bitexact(tpk.dequantize_mx(tm).numpy(),
                    tpk.dequantize_mx_outlier(t).numpy(), "merge",
                    ftz_ok=False)
    # a forced field split that cannot hold the values raises in both
    with pytest.raises(ValueError, match="emi8m-representable"):
        tpk.merge_outlier_emi8(t, mw=2, fold=0)
    with pytest.raises(ValueError, match="emi8m-representable"):
        jpk.merge_outlier_emi8(j, mw=2, fold=0)


def test_pack_emi8m_absolute_matches_jax():
    W = _weights(64, 48, seed=2)
    q = np.asarray(jol.quantize_mx_outlier_v1(jnp.asarray(W.T), 8, 8, "int2",
                                              "fp4", "max", 2.0, [0], 16)).T
    j = jpk.pack_emi8m_absolute(jnp.asarray(q), block_size=16, axis=0)
    t = tpk.pack_emi8m_absolute(_t(q), block_size=16, axis=0)
    assert (t.transport_mw, t.transport_fold, t.orig_dim) == (
        j.transport_mw, j.transport_fold, j.orig_dim)
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.scale_exp.numpy(),
                                  np.asarray(j.scale_exp))
    assert_bitexact(tpk.dequantize_mx(t).numpy(), q, "absolute",
                    ftz_ok=False)
    # raw (unquantized) weights carry 24-bit mantissas: both raise
    with pytest.raises(ValueError, match="emi8m-representable"):
        tpk.pack_emi8m_absolute(_t(W), block_size=16, axis=0)
    with pytest.raises(ValueError, match="emi8m-representable"):
        jpk.pack_emi8m_absolute(jnp.asarray(W), block_size=16, axis=0)


def test_emi8m_rebase_matches_jax():
    W = _weights(64, 48, seed=5)
    j = jpk.merge_outlier_emi8(jpk.pack_mx_outlier(
        jnp.asarray(W), 8, 8, "int2", "fp4", block_size=16,
        outlier_budget=4, axis=0))
    t = tpk.merge_outlier_emi8(tpk.pack_mx_outlier(
        _t(W), 8, 8, "int2", "fp4", block_size=16, outlier_budget=4, axis=0))
    feasible = 0
    for mw in range(2, 8):
        for fold in range(t.transport_fold, t.transport_fold + 4):
            try:
                jr = jpk.emi8m_rebase(j, mw, fold)
            except ValueError:
                with pytest.raises(ValueError, match="infeasible"):
                    tpk.emi8m_rebase(t, mw, fold)
                continue
            tr = tpk.emi8m_rebase(t, mw, fold)
            np.testing.assert_array_equal(tr.codes.numpy(),
                                          np.asarray(jr.codes))
            assert (tr.transport_mw, tr.transport_fold) == (mw, fold)
            assert_bitexact(tpk.dequantize_mx(tr).numpy(),
                            tpk.dequantize_mx(t).numpy(), "rebase",
                            ftz_ok=False)
            feasible += 1
    assert 2 <= feasible < 24
    assert tpk.emi8m_rebase(t, t.transport_mw, t.transport_fold) is t


def _nb_decisions(N, K, cap, seed):
    """RTN decisions on the (N, K) layout from the JAX package, as
    scripts/nb_capacity.py makes them: numpy for JAX, numpy for the port."""
    W = _weights(K, N, seed=seed)
    _, _, dec = jol.quantize_mx_outlier_hessian_decisions(
        jnp.asarray(W.T), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0], 16,
        max_outliers_per_block=cap)
    dec = {k: np.asarray(v) for k, v in dec.items()}
    dec["block_size"] = 16
    return W, dec


@pytest.mark.parametrize("cap", [0, 1, 2])
@pytest.mark.parametrize("N,K", [(64, 48), (40, 32)])
def test_pack_outlier_nb_matches_jax(cap, N, K):
    _, dec = _nb_decisions(N, K, cap, seed=cap + N)
    budget = cap or 0
    j = jpk.pack_outlier_nb(dec, budget=budget)
    t = tpk.pack_outlier_nb({k: (_t(v) if isinstance(v, np.ndarray) else v)
                             for k, v in dec.items()}, budget=budget)
    for name in ("codes", "scale_exp", "out_byte", "out_scale_exp"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    assert (t.orig_n, t.orig_k, t.budget) == (j.orig_n, j.orig_k, j.budget)
    assert t.bits_per_element == j.bits_per_element
    dense = tpk.dequantize_outlier_nb(t).numpy()
    assert_bitexact(dense, np.asarray(jpk.dequantize_outlier_nb(j)), "nb")
    # lossless against the fake-quant output of the same decisions
    q = (dec["inl_code"] * np.exp2(np.repeat(dec["se_in"], 16, 0)[:N])
         + dec["out_code"] * np.exp2(np.repeat(dec["se_out"]
                                               - dec["se_in"], 16, 0)[:N]))
    np.testing.assert_array_equal(dense, q.astype(np.float32))


def test_pack_outlier_nb_budget_overflow_raises():
    _, dec = _nb_decisions(64, 48, 0, seed=11)
    counts = dec["mask"].reshape(-1, 16, 48).sum(1)
    assert counts.max() > 1
    tdec = {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in dec.items()}
    with pytest.raises(ValueError, match="exceed budget 1"):
        tpk.pack_outlier_nb(tdec, budget=1)
    with pytest.raises(ValueError, match="exceed budget 1"):
        jpk.pack_outlier_nb(dec, budget=1)
    assert tpk.pack_outlier_nb(tdec).budget == int(counts.max())


def test_pack_outlier_nb_from_port_decisions_equals_jax_decisions():
    W, dec = _nb_decisions(48, 64, 2, seed=4)
    _, _, tdec = tol.quantize_mx_outlier_hessian_decisions(
        _t(W.T), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0], 16,
        max_outliers_per_block=2)
    tdec["block_size"] = 16
    t = tpk.pack_outlier_nb(tdec, budget=2)
    j = jpk.pack_outlier_nb(dec, budget=2)
    np.testing.assert_array_equal(t.out_byte.numpy(), np.asarray(j.out_byte))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    assert t.bits_per_element == 4.0
