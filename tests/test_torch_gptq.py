"""The port's GPTQ engine (``microscopiq_tpu_torch.quant``) against the JAX
package's on the CPU, on the same numpy inputs.

Tolerances: the Hessian rtol 1e-5 (float32 sums in another order); against
the reference fixture ``tests/golden/gptq.npz`` JAX's own thresholds
(> 80% of entries on the same grid point, error <= 1.1x); against JAX's
``fasterquant`` in every mode >= 95% identical entries and a proxy loss
tr((W-Q) H (W-Q)^T) within 2% of JAX's, since ``torch.linalg.cholesky``
and XLA's differ in the last bits and a flipped rounding feeds forward;
given JAX's own Hinv, the column loop >= 99% identical entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.quant import GPTQ as JGPTQ
from microscopiq_tpu.quant import MXQuantizer as JMXQuantizer
from microscopiq_tpu.quant import UniformQuantizer as JUniformQuantizer
from microscopiq_tpu.quant.quantizer import quantize_uniform as jquantize
from microscopiq_tpu_torch.quant import (GPTQ, MXQuantizer, UniformQuantizer,
                                         quantize_uniform)
from microscopiq_tpu_torch.quant.gptq import StageTimer


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _mx(cls, fmt="int2", ofmt="fp4_e2m1", bs=16, cap=0):
    q = cls()
    q.configure(8, 8, fmt, ofmt, std_dev=2, axes=[0], block_size=bs)
    q.max_outliers_per_block = cap
    return q


def _pair(W, X, mode, quantizer):
    """The JAX and the port calibrator on the same W and batches."""
    gj, gt = JGPTQ(jnp.asarray(W), mode=mode), GPTQ(_t(W), mode=mode)
    gj.quantizer, gt.quantizer = quantizer
    for xb in X:
        gj.add_batch(jnp.asarray(xb))
        gt.add_batch(_t(xb))
    return gj, gt


def _proxy(Q, W, H):
    E = np.asarray(Q, np.float64) - W
    return float(np.trace(E @ np.asarray(H, np.float64) @ E.T))


def test_hessian_matches_golden_and_jax(golden_gptq):
    X, W = golden_gptq["X"], golden_gptq["W_orig"]
    gj, gt = _pair(W, X, "mx_prune", (None, None))
    np.testing.assert_allclose(gt.H.numpy(), golden_gptq["H"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gt.H.numpy(), np.asarray(gj.H), rtol=1e-5,
                               atol=1e-6)
    assert float(gt.nsamples) == float(gj.nsamples) == X.shape[0]


def test_fasterquant_close_to_reference_fixture(golden_gptq):
    """JAX's own thresholds against the reference's Q (test_gptq.py)."""
    W, X, Qref = golden_gptq["W_orig"], golden_gptq["X"], golden_gptq["Q"]
    g = GPTQ(_t(W), mode="mx_prune")
    g.quantizer = _mx(MXQuantizer)
    for xb in X:
        g.add_batch(_t(xb))
    Q, _ = g.fasterquant(blocksize=32, percdamp=0.01)
    Q = Q.numpy()
    agree = np.mean(np.isclose(Q, Qref, rtol=1e-4, atol=1e-6))
    assert agree > 0.8, agree
    assert np.sum((Q - W) ** 2) <= 1.1 * np.sum((Qref - W) ** 2)


def _inputs(seed, rows=48, cols=64, dead=False):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((rows, cols)) * 0.1).astype(np.float32)
    W[rng.random(W.shape) < 0.04] *= 8.0
    mix = np.eye(cols) + 0.3 * rng.standard_normal((cols, cols))
    X = (rng.standard_normal((4, 32, cols)) @ mix).astype(np.float32)
    if dead:
        X[..., 5] = 0.0
        X[..., 40] = 0.0
    return W, X


CASES = {
    "mx_prune": ("mx_prune", {}),
    "mx_prune_cap2": ("mx_prune", {"cap": 2}),
    "mx_prune_actorder": ("mx_prune", {"actorder": True}),
    "mx_prune_dead": ("mx_prune", {"dead": True}),
    "mx_hessian": ("mx_hessian", {}),
    "mx_v1": ("mx_v1", {}),
    "mx_v1_actorder_dead": ("mx_v1", {"actorder": True, "dead": True}),
    "uniform": ("uniform", {}),
    "uniform_groups": ("uniform", {"groupsize": 16}),
    "uniform_actorder_dead": ("uniform", {"actorder": True, "dead": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fasterquant_matches_jax(case):
    mode, kw = CASES[case]
    W, X = _inputs(len(case), dead=kw.get("dead", False))
    if mode == "uniform":
        qs = []
        for cls in (JUniformQuantizer, UniformQuantizer):
            q = cls()
            q.configure(4, perchannel=True, sym=False)
            qs.append(q)
    else:
        qs = [_mx(c, cap=kw.get("cap", 0))
              for c in (JMXQuantizer, MXQuantizer)]
    gj, gt = _pair(W, X, mode, qs)
    H = np.asarray(gj.H)
    args = dict(blocksize=32, actorder=kw.get("actorder", False),
                groupsize=kw.get("groupsize", -1))
    Qj, Lj = gj.fasterquant(**args)
    Qt, Lt = gt.fasterquant(**args)
    Qj, Qt = np.asarray(Qj), Qt.numpy()
    assert Qt.shape == W.shape and np.isfinite(Qt).all()
    same = np.mean(Qj == Qt)
    assert same >= 0.95, same
    pj, pt = _proxy(Qj, W, H), _proxy(Qt, W, H)
    assert abs(pt - pj) <= 0.02 * pj, (pt, pj)
    if kw.get("dead"):
        assert (Qt[:, 5] == 0).all() and (Qt[:, 40] == 0).all()


def _jax_hinv(H, percdamp=0.01):
    """JAX's Cholesky -> inverse -> upper Cholesky, as fasterquant runs it
    (no dead columns, no act order)."""
    import jax

    n = H.shape[0]
    H = H + percdamp * jnp.mean(jnp.diag(H)) * jnp.eye(n)
    L = jnp.linalg.cholesky(H)
    full = jax.scipy.linalg.cho_solve((L, True), jnp.eye(n))
    return np.asarray(jnp.linalg.cholesky(full).T)


@pytest.mark.parametrize("mode", ["mx_prune", "mx_v1"])
def test_column_loop_given_jax_hinv(mode):
    """With the Hinv that JAX computes, the port's column loops (with the
    block updates between them) give JAX's Q nearly everywhere."""
    W, X = _inputs(7, rows=64, cols=96)
    gj, gt = _pair(W, X, mode, [_mx(c) for c in (JMXQuantizer,
                                                 MXQuantizer)])
    Qj, _ = gj.fasterquant(blocksize=32)
    Hinv = _t(_jax_hinv(gj.H))
    Qt, _ = gt._fasterquant_mx(_t(W), Hinv, 32, False, StageTimer("cpu"))
    same = np.mean(np.asarray(Qj) == Qt.numpy())
    assert same >= 0.99, same


def test_fasterquant_collect_decisions_reconstructs_q():
    """The decisions collected in the column loop rebuild Q exactly (the
    contract of the compact NB packer), and agree with JAX's."""
    rng = np.random.default_rng(21)
    W = rng.standard_normal((64, 48)).astype(np.float32)
    W[rng.random(W.shape) < 0.05] *= 8.0
    X = rng.standard_normal((4, 16, 48)).astype(np.float32)
    qs = [c(8, 8, "int2", "fp4", std_dev=2.0, axes=(0,), block_size=16,
            max_outliers_per_block=2) for c in (JMXQuantizer, MXQuantizer)]
    gj, gt = _pair(W, X, "mx_prune", qs)
    Qt, _ = gt.fasterquant(blocksize=32, collect_decisions=True)
    Qj, _ = gj.fasterquant(blocksize=32, collect_decisions=True)
    d = gt.decisions
    assert d["block_size"] == 16
    rep = lambda se: np.repeat(se.numpy(), 16, axis=0)[:W.shape[0]]  # noqa
    recon = (d["inl_code"].numpy() * 2.0 ** rep(d["se_in"])
             + d["out_code"].numpy()
             * 2.0 ** (rep(d["se_out"]) - rep(d["se_in"])))
    np.testing.assert_array_equal(recon.astype(np.float32), Qt.numpy())
    assert d["mask"].dtype == torch.bool
    assert int(d["mask"].reshape(4, 16, -1).sum(1).max()) <= 2
    same = np.mean(np.asarray(gj.decisions["mask"]) == d["mask"].numpy())
    assert same >= 0.95, same


def test_quantizers_match_jax():
    """MXQuantizer's two quantizers bit-exact; UniformQuantizer's
    parameters (per channel, symmetric, MSE search) and quantize_uniform
    to float32 rounding."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 24)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] *= 9.0
    qj, qt = _mx(JMXQuantizer, cap=2), _mx(MXQuantizer, cap=2)
    np.testing.assert_array_equal(qt.quantize(_t(x)).numpy(),
                                  np.asarray(qj.quantize(jnp.asarray(x))))
    (aj, nj), (at, nt) = (qj.quantize_hessian(jnp.asarray(x)),
                          qt.quantize_hessian(_t(x)))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert qt.ready() and qt.enabled()
    for kw in (dict(perchannel=True, sym=False),
               dict(perchannel=True, sym=True, mse=True, grid=10),
               dict(perchannel=False, sym=True), dict(trits=True)):
        uj, ut = JUniformQuantizer(), UniformQuantizer()
        uj.configure(3, **kw)
        ut.configure(3, **kw)
        uj.find_params(jnp.asarray(x), weight=True)
        ut.find_params(_t(x), weight=True)
        np.testing.assert_allclose(ut.scale.numpy(), np.asarray(uj.scale),
                                   rtol=1e-6)
        np.testing.assert_allclose(ut.zero.numpy(), np.asarray(uj.zero),
                                   rtol=1e-6)
        np.testing.assert_allclose(ut.quantize(_t(x)).numpy(),
                                   np.asarray(uj.quantize(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    s, z = np.float32(0.25), np.float32(2.0)
    np.testing.assert_array_equal(
        quantize_uniform(_t(x), s, z, 7).numpy(),
        np.asarray(jquantize(jnp.asarray(x), s, z, 7)))


def test_stage_timer_sums_stages():
    t = StageTimer("cpu")
    for _ in range(2):
        with t("a"):
            pass
    with t("b"):
        pass
    assert set(t.seconds) == {"a", "b"} and t.seconds["a"] >= 0.0
