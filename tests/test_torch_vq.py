"""The port's vector quantizer (microscopiq_tpu_torch.quant.vq) against the
JAX package's on the same numpy inputs. The random draws of k-means++ are
JAX's: :func:`jax_kpp_draws` repeats JAX's loop with its key splits and
hands the first index and every step's candidates to the port, whose own
generator draws other samples (ROADMAP queue 3).

Tolerances: assignments equal; centroids within 1e-6 (the EM means sum in
another order: ``index_add_`` against JAX's one-hot einsums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.quant import vq as jvq
from microscopiq_tpu_torch.quant import vq as tvq

RNG = np.random.default_rng(11)


def jax_kpp_draws(X, k, key, n_candidates=8):
    """(first, (k-1, n_candidates) candidates) of ``jvq.kpp_init(X, k,
    key)``: the same jax.random calls on the same distances."""
    n = X.shape[0]
    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n)
    d2 = jnp.sum((X - X[first]) ** 2, 1)
    cands = []
    for _ in range(1, k):
        key, sub = jax.random.split(key)
        probs = d2 / jnp.maximum(d2.sum(), 1e-12)
        cand = jax.random.choice(sub, n, (n_candidates,), p=probs)
        cd2 = jnp.sum((X[None, :, :] - X[cand][:, None, :]) ** 2, -1)
        newd = jnp.minimum(d2[None, :], cd2)
        d2 = newd[jnp.argmin(newd.sum(1))]
        cands.append(np.asarray(cand))
    return int(first), np.stack(cands)


def quantizer_draws(W, q, key=None):
    """The kpp draws of each block of ``jvq.VQQuantizer.quantize``."""
    key = jax.random.PRNGKey(0) if key is None else key
    rows, cols = W.shape
    bs = q.block_size or cols
    out = []
    for b0 in range(0, cols, bs):
        blk = W[:, b0:b0 + bs]
        X = (blk / jnp.maximum(jnp.abs(blk).max(), 1e-12)).reshape(
            -1, q.vec_dim)
        key, sub = jax.random.split(key)
        out.append(jax_kpp_draws(X, q.codebook_size, sub))
    return out


def _clusters(n=64, scale=0.1):
    centers = np.array([[0, 0], [5, 5], [-5, 5], [5, -5]], np.float32)
    X = np.concatenate([c + scale * RNG.standard_normal((n, 2))
                        for c in centers]).astype(np.float32)
    return centers, X


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("chunk", [7, 1 << 20])
def test_get_assignments_equal_jax(weighted, chunk):
    X = RNG.standard_normal((300, 3)).astype(np.float32)
    C = RNG.standard_normal((16, 3)).astype(np.float32)
    W = (RNG.random((300, 3)) * 4).astype(np.float32) if weighted else None
    want = np.asarray(jvq.get_assignments(
        jnp.asarray(X), jnp.asarray(C), None if W is None else jnp.asarray(W)))
    got = tvq.get_assignments(torch.from_numpy(X), torch.from_numpy(C),
                              None if W is None else torch.from_numpy(W),
                              chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [50, 1 << 20])
def test_kpp_init_given_jax_draws(chunk):
    _, X = _clusters()
    key = jax.random.PRNGKey(5)
    want = np.asarray(jvq.kpp_init(jnp.asarray(X), 6, key))
    draws = jax_kpp_draws(jnp.asarray(X), 6, key)
    got, used = tvq.kpp_init(torch.from_numpy(X), 6, draws=draws,
                             chunk=chunk, return_draws=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert used[0] == draws[0] and np.array_equal(used[1], draws[1])


def test_kpp_init_generator_draws_replay():
    """A generator's draws, given back, rebuild the same centroids."""
    _, X = _clusters()
    Xt = torch.from_numpy(X)
    c1, draws = tvq.kpp_init(Xt, 5, torch.Generator().manual_seed(3),
                             return_draws=True)
    np.testing.assert_array_equal(tvq.kpp_init(Xt, 5, draws=draws).numpy(),
                                  c1.numpy())
    with pytest.raises(ValueError, match="candidates"):
        tvq.kpp_init(Xt, 6, draws=draws)


@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_vq_given_jax_draws(weighted):
    _, X = _clusters(scale=0.8)
    W = (RNG.random(X.shape) + 0.5).astype(np.float32) if weighted else None
    key = jax.random.PRNGKey(2)
    cj, aj = jvq.kmeans_vq(jnp.asarray(X), 8, iters=6,
                           weights=None if W is None else jnp.asarray(W),
                           key=key)
    draws = jax_kpp_draws(jnp.asarray(X), 8, key)
    ct, at = tvq.kmeans_vq(torch.from_numpy(X), 8, iters=6,
                           weights=None if W is None else torch.from_numpy(W),
                           draws=draws)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)


def test_mahalanobis_init_equal_jax():
    X = (RNG.standard_normal((1001, 2)) @ np.array([[2.0, 0.3], [0.0, 0.5]])
         ).astype(np.float32)
    X[::50] = X[1]                                    # ties in the order
    for k in (1, 7, 64):
        want = np.asarray(jvq.mahalanobis_init(jnp.asarray(X), k))
        got = tvq.mahalanobis_init(torch.from_numpy(X), k).numpy()
        np.testing.assert_array_equal(got, want)
    cj, aj = jvq.kmeans_vq(jnp.asarray(X), 8, iters=4, init="mahalanobis")
    ct, at = tvq.kmeans_vq(torch.from_numpy(X), 8, iters=4,
                           init="mahalanobis")
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tvq.kmeans_vq(torch.from_numpy(X), 4, init="other")


@pytest.mark.parametrize("hessian", [False, True])
@pytest.mark.parametrize("block_size", [0, 16])
def test_vq_quantizer_equal_jax(hessian, block_size):
    W = RNG.standard_normal((16, 32)).astype(np.float32)
    hd = (RNG.random(32) + 0.1).astype(np.float32) if hessian else None
    qj = jvq.VQQuantizer(vec_dim=2, bits=2, kmeans_iters=8,
                         block_size=block_size)
    want = np.asarray(qj.quantize(jnp.asarray(W), None if hd is None
                                  else jnp.asarray(hd)))
    draws = quantizer_draws(jnp.asarray(W), qj)
    qt = tvq.VQQuantizer(vec_dim=2, bits=2, kmeans_iters=8,
                         block_size=block_size)
    got = qt.quantize(torch.from_numpy(W), None if hd is None
                      else torch.from_numpy(hd), draws=draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(W).max())
    assert len(qt.draws) == len(draws)


def test_vq_quantizer_configure_and_checks():
    q = tvq.VQQuantizer()
    q.configure(bits=2, vec_dim=4, block_size=8, kmeans_iters=3,
                init="mahalanobis")
    assert (q.bits, q.vec_dim, q.block_size, q.kmeans_iters, q.init) == (
        2, 4, 8, 3, "mahalanobis")
    assert q.codebook_size == 256 and q.ready()
    with pytest.raises(ValueError):
        q.quantize(torch.zeros(4, 6))


# --- the cases of tests/test_utils_misc.py:19-48, on the port ----------
def test_kmeans_recovers_clusters():
    centers, X = _clusters()
    cents, _ = tvq.kmeans_vq(torch.from_numpy(X), 4, iters=12)
    d = np.abs(cents.numpy()[:, None, :] - centers[None]).sum(-1).min(1)
    assert (d < 0.5).all(), d


def test_weighted_assignments():
    X = torch.tensor([[1.0, 10.0]])
    C = torch.tensor([[1.0, 0.0], [0.0, 10.0]])
    w = torch.tensor([[100.0, 1.0]])
    assert int(tvq.get_assignments(X, C, w)[0]) == 0


def test_vq_quantizer_reduces_levels():
    W = RNG.standard_normal((16, 32)).astype(np.float32)
    q = tvq.VQQuantizer(vec_dim=2, bits=2, kmeans_iters=8)
    Wq = q.quantize(torch.from_numpy(W)).numpy()
    assert Wq.shape == W.shape
    vecs = np.unique(np.round(Wq.reshape(-1, 2), 6), axis=0)
    assert len(vecs) <= 16
    assert np.abs(Wq - W).mean() < np.abs(W).mean()
