"""Vector quantization (GPTVQ-style) in PyTorch.

Counterpart of ``microscopiq_tpu/quant/vq.py``: k-means++ initialization
with parallel candidate sampling, the Mahalanobis-ordered init,
(Hessian-weighted) nearest-centroid assignments, EM k-means and the
blockwise ``VQQuantizer``.

Random draws come from a ``torch.Generator`` or are given: ``kpp_init``
takes ``draws`` = (first index, (k-1, n_candidates) candidate indices), the
draws ``jax.random`` makes in JAX's loop, so that both packages can run on
the same draws (the generators themselves differ). With a generator the
draws are ``torch.randint`` and ``torch.multinomial`` (with replacement,
as ``jax.random.choice``), and ``kpp_init(..., return_draws=True)`` returns
them for a second run.

At full width (a 4096 x 14336 weight in 2-vectors is 29.4M points) the
(n, k) distance matrix and kpp's (candidates, n) distances would take
gigabytes, so both are formed ``chunk`` rows at a time; the functions are
the same (the first minimum wins in ``torch.argmin`` as in ``jnp.argmin``).
The EM step sums each cluster with ``index_add_`` in place of JAX's one-hot
einsums, and its loop is a Python loop where JAX scans.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

CHUNK = 1 << 20


def get_assignments(X: torch.Tensor, centroids: torch.Tensor,
                    weights: Optional[torch.Tensor] = None,
                    chunk: int = CHUNK) -> torch.Tensor:
    """Nearest-centroid assignment (int64) under the (optionally
    Hessian-weighted) squared distance. X (n, d), centroids (k, d),
    weights (n, d); ``chunk`` rows of the (n, k) distances at a time."""
    c2 = centroids * centroids
    out = []
    for s in range(0, X.shape[0], chunk):
        x = X[s:s + chunk]
        if weights is None:
            d2 = ((x * x).sum(1, keepdim=True) - 2 * x @ centroids.T
                  + c2.sum(1)[None, :])
        else:
            # sum_j w_ij (x_ij - c_kj)^2
            w = weights[s:s + chunk]
            d2 = ((w * x * x).sum(1, keepdim=True) - 2 * (w * x) @ centroids.T
                  + w @ c2.T)
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out) if out else X.new_zeros((0,), dtype=torch.int64)


def _candidate_d2(X: torch.Tensor, rows: torch.Tensor, d2: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """sum over n of min(d2, |X - X[row]|^2) for each candidate row."""
    tot = torch.zeros(rows.shape[0], dtype=X.dtype, device=X.device)
    C = X[rows]                                                # (c, d)
    for s in range(0, X.shape[0], chunk):
        cd2 = ((X[None, s:s + chunk, :] - C[:, None, :]) ** 2).sum(-1)
        tot += torch.minimum(d2[None, s:s + chunk], cd2).sum(1)
    return tot


def kpp_init(X: torch.Tensor, k: int,
             generator: Optional[torch.Generator] = None,
             n_candidates: int = 8,
             draws: Optional[Tuple[int, Sequence[Sequence[int]]]] = None,
             chunk: int = CHUNK, return_draws: bool = False):
    """k-means++ with parallel candidate sampling: each new centroid is the
    one of ``n_candidates`` points drawn in proportion to the squared
    distance that most reduces the total distance. ``draws`` (first index,
    candidates of each later centroid) replaces the generator's draws.
    Returns the (k, d) centroids, and with ``return_draws`` the draws."""
    n = X.shape[0]
    if draws is None:
        first = int(torch.randint(n, (), generator=generator,
                                  device=_gen_device(generator)))
        cands: List[List[int]] = []
    else:
        first, given = int(draws[0]), torch.as_tensor(draws[1])
        if tuple(given.shape) != (k - 1, n_candidates):
            raise ValueError(f"draws hold {tuple(given.shape)} candidates, "
                             f"want {(k - 1, n_candidates)}")
    centroids = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    centroids[0] = X[first]
    d2 = ((X - X[first]) ** 2).sum(1)
    for i in range(1, k):
        if draws is None:
            probs = d2 / torch.clamp(d2.sum(), min=1e-12)
            cand = torch.multinomial(probs.to(_gen_device(generator)),
                                     n_candidates, replacement=True,
                                     generator=generator).to(X.device)
            cands.append(cand.tolist())
        else:
            cand = given[i - 1].to(X.device)
        best = int(torch.argmin(_candidate_d2(X, cand, d2, chunk)))
        row = X[cand[best]]
        centroids[i] = row
        d2 = torch.minimum(d2, ((X - row) ** 2).sum(1))
    if return_draws:
        return centroids, (first, cands if draws is None
                           else given.tolist())
    return centroids


def _gen_device(generator: Optional[torch.Generator]):
    return "cpu" if generator is None else generator.device


def mahalanobis_init(X: torch.Tensor, k: int) -> torch.Tensor:
    """Mahalanobis-ordered init: sort the points by Mahalanobis distance
    (stable, as ``jnp.argsort``) and take k evenly spaced ones, their
    indices truncated from float32 ``linspace`` as JAX computes it."""
    n, d = X.shape
    mu = X.mean(0)
    Xc = X - mu
    cov = Xc.T @ Xc / n + 1e-6 * torch.eye(d, dtype=X.dtype, device=X.device)
    icov = torch.linalg.inv(cov)
    md = torch.einsum("nd,de,ne->n", Xc, icov, Xc)
    order = torch.argsort(md, stable=True)
    if k > 1:
        step = torch.arange(k - 1, dtype=torch.float32) / float(k - 1)
        pos = torch.cat([torch.tensor(float(n - 1)) * step,
                         torch.tensor([float(n - 1)])])
    else:
        pos = torch.zeros(1)
    idx = pos.to(torch.int32).to(torch.int64).to(X.device)
    return X[order[idx]]


def kmeans_vq(X: torch.Tensor, k: int, iters: int = 10,
              weights: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              init: str = "kpp", draws=None,
              chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """EM k-means; returns (centroids, assignments). ``draws`` go to
    :func:`kpp_init`."""
    if init == "kpp":
        if generator is None and draws is None:
            generator = torch.Generator().manual_seed(0)
        centroids = kpp_init(X, k, generator, draws=draws, chunk=chunk)
    elif init == "mahalanobis":
        centroids = mahalanobis_init(X, k)
    else:
        raise ValueError(init)
    return lloyd(X, centroids, iters, weights, chunk)


def lloyd(X: torch.Tensor, centroids: torch.Tensor, iters: int,
          weights: Optional[torch.Tensor] = None,
          chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` EM steps from ``centroids``: assign, then each cluster's
    (weighted) mean, an empty cluster keeping its centroid; returns
    (centroids, assignments)."""
    w = weights if weights is not None else torch.ones_like(X)
    wx = w * X
    for _ in range(iters):
        assign = get_assignments(X, centroids, weights, chunk)
        num = torch.zeros_like(centroids).index_add_(0, assign, wx)
        den = torch.zeros_like(centroids).index_add_(0, assign, w)
        centroids = torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                                centroids)
    return centroids, get_assignments(X, centroids, weights, chunk)


@dataclasses.dataclass
class VQQuantizer:
    """Blockwise vector quantizer: weights are grouped into vectors of
    ``vec_dim`` along the input axis, normalized per block, clustered into
    a 2^(bits·vec_dim)-entry codebook and rebuilt from the assignments.

    ``quantize`` takes a generator (one for all blocks, drawn in block
    order) or ``draws`` (a list, one :func:`kpp_init` draws pair a
    block); the draws it used are left in ``self.draws``, and its last
    block's assignments in ``self.assignments``."""

    vec_dim: int = 2
    bits: int = 3             # bits per dimension
    block_size: int = 0       # columns per codebook block (0 = whole row)
    kmeans_iters: int = 10
    init: str = "kpp"

    def __post_init__(self):
        self.draws: list = []
        self.assignments: Optional[torch.Tensor] = None
        self.centroids: Optional[torch.Tensor] = None

    def configure(self, bits=None, vec_dim=None, block_size=None,
                  kmeans_iters=None, init=None):
        if bits is not None:
            self.bits = bits
        if vec_dim is not None:
            self.vec_dim = vec_dim
        if block_size is not None:
            self.block_size = block_size
        if kmeans_iters is not None:
            self.kmeans_iters = kmeans_iters
        if init is not None:
            self.init = init

    @property
    def codebook_size(self) -> int:
        return 2 ** (self.bits * self.vec_dim)

    def find_params(self, x, weight=False):
        pass

    def ready(self):
        return True

    def quantize(self, W: torch.Tensor,
                 hessian_diag: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[list] = None) -> torch.Tensor:
        """Quantize a (rows, cols) weight matrix; cols % vec_dim == 0."""
        rows, cols = W.shape
        d = self.vec_dim
        if cols % d:
            raise ValueError(f"cols {cols} is no multiple of vec_dim {d}")
        bs = self.block_size or cols
        if cols % bs:
            raise ValueError(f"cols {cols} is no multiple of block {bs}")
        if generator is None and draws is None:
            generator = torch.Generator().manual_seed(0)
        out = torch.zeros_like(W)
        self.draws = []
        for j, b0 in enumerate(range(0, cols, bs)):
            blk = W[:, b0:b0 + bs]
            scale = torch.clamp(blk.abs().max(), min=1e-12)
            X = (blk / scale).reshape(-1, d)
            wts = None
            if hessian_diag is not None:
                hd = hessian_diag[b0:b0 + bs]
                wts = hd.reshape(-1, d).repeat(rows, 1)
            k = self.codebook_size
            if self.init == "kpp":
                init, used = kpp_init(
                    X, k, generator, draws=None if draws is None
                    else draws[j], return_draws=True)
                self.draws.append(used)
                centroids, assign = lloyd(X, init, self.kmeans_iters, wts)
            else:
                centroids, assign = kmeans_vq(X, k, self.kmeans_iters, wts,
                                              init=self.init)
            self.assignments, self.centroids = assign, centroids
            out[:, b0:b0 + bs] = centroids[assign].reshape(rows, bs) * scale
        return out

