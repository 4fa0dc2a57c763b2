"""GPTQ calibration with MicroScopiQ prune-and-redistribute, in PyTorch.

Counterpart of ``microscopiq_tpu/quant/gptq.py``: the running Hessian
update, the Cholesky -> inverse -> upper-Cholesky pipeline, and the
sequential column loop of each 128-column block, in JAX's order of
operations. In ``mx_prune`` mode each column's outlier count (from the
two-level quantizer) frees that many weight slots: the ``q^2/d^2`` least
important quantized weights are zeroed (a stable sort, as ``jnp.argsort``:
zero codes tie at importance 0), and the error feedback redistributes
their contribution into the columns not yet quantized.

On a CUDA device the block step (the column loop of one block) is captured
once per geometry (mode, quantizer, rows, columns, decisions) in a CUDA
graph and replayed for every block of that geometry, as
``eval/generate.py::DecodeStep`` replays a decode step; JAX jits the same
block function. The step has no host sync and no data-dependent shape. On
the CPU the step runs eagerly.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.outlier import (quantize_mx_outlier_hessian,
                           quantize_mx_outlier_hessian_decisions,
                           quantize_mx_outlier_v1)
from .quantizer import MXQuantizer, UniformQuantizer, quantize_uniform

_DECISION_NAMES = ("inl_code", "out_code", "mask", "se_in", "se_out")


class StageTimer:
    """Wall seconds by stage name; on a CUDA device each stage starts and
    ends with a synchronize, so that it holds its kernels' time."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
            self.seconds[stage] = (self.seconds.get(stage, 0.0)
                                   + time.perf_counter() - t0)


def _no_timer(stage: str):
    return contextlib.nullcontext()


def _quantize_col(qcfg: tuple, mode: str, collect: bool):
    """The column quantizer of ``mode``: w (rows,) -> (q, counts, dec)."""
    (in_sb, out_sb, in_fmt, out_fmt, sem, std_dev, axes, bsz, rnd, flush,
     cap) = qcfg

    def quantize_col(w):
        if mode in ("mx_prune", "mx_hessian"):
            if collect:
                q, n_out, dec = quantize_mx_outlier_hessian_decisions(
                    w[:, None], in_sb, out_sb, in_fmt, out_fmt, sem,
                    std_dev, list(axes), bsz, rnd, flush, cap)
                return q[:, 0], n_out, dec
            q, n_out = quantize_mx_outlier_hessian(
                w[:, None], in_sb, out_sb, in_fmt, out_fmt, sem, std_dev,
                list(axes), bsz, rnd, flush, cap)
            return q[:, 0], n_out, None
        if mode == "mx_v1":
            q = quantize_mx_outlier_v1(
                w[:, None], in_sb, out_sb, in_fmt, out_fmt, sem, std_dev,
                list(axes), bsz, rnd, flush)
            return q[:, 0], None, None
        raise ValueError(mode)

    return quantize_col


def quantizer_config(qz: MXQuantizer) -> tuple:
    """The static configuration of an MXQuantizer, as the block step takes
    it."""
    return (qz.inlier_scale_bits, qz.outlier_scale_bits,
            qz.inlier_elem_format, qz.outlier_elem_format,
            qz.shared_exp_method, qz.std_dev, tuple(qz.axes), qz.block_size,
            qz.round, qz.flush_fp32_subnorms,
            getattr(qz, "max_outliers_per_block", 0))


def mx_block_step(qcfg: tuple, mode: str, collect: bool) -> Callable:
    """The column loop of one block (``_make_block_fn``'s body):
    (W1, Hinv1) -> (Q1, Err1, L1, decisions or ())."""
    quantize_col = _quantize_col(qcfg, mode, collect)
    bsz = qcfg[7]

    def step(W1, Hinv1):
        rows, count = W1.shape
        W1 = W1.clone()
        Q1 = torch.zeros_like(W1)
        Err1 = torch.zeros_like(W1)
        L1 = torch.zeros_like(W1)
        ids = torch.arange(rows, dtype=torch.int32, device=W1.device)
        nb = (rows + bsz - 1) // bsz if bsz else 1
        if collect:
            D = (torch.zeros_like(W1), torch.zeros_like(W1),
                 torch.zeros((rows, count), dtype=torch.bool,
                             device=W1.device),
                 W1.new_zeros((nb, count)), W1.new_zeros((nb, count)))
        for i in range(count):
            w = W1[:, i].clone()
            d = Hinv1[i, i]
            q, n_out, dec = quantize_col(w)
            keep = None
            if mode == "mx_prune":
                # prune-and-redistribute: zero the num least important
                # weights by the rank of q^2/d^2 (stable among ties)
                importance = (q * q) / (d * d)
                num = n_out.to(torch.int32).sum()
                order = torch.argsort(importance, stable=True)
                ranks = torch.empty_like(ids).scatter_(0, order, ids)
                pruned = ranks < num
                q = torch.where(pruned, torch.zeros_like(q), q)
                keep = ~pruned
            err = (w - q) / d
            # error feedback into the block's remaining columns
            W1[:, i + 1:] -= err[:, None] * Hinv1[i, i + 1:][None, :]
            Q1[:, i] = q
            Err1[:, i] = err
            L1[:, i] = (w - q) ** 2 / d ** 2
            if collect:
                if keep is None:
                    keep = torch.ones_like(w, dtype=torch.bool)
                zero = torch.zeros_like(w)
                D[0][:, i] = torch.where(keep, dec["inl_code"][:, 0], zero)
                D[1][:, i] = torch.where(keep, dec["out_code"][:, 0], zero)
                D[2][:, i] = (dec["mask"][:, 0] > 0) & keep
                D[3][:, i] = dec["se_in"][:, 0]
                D[4][:, i] = dec["se_out"][:, 0]
        return Q1, Err1, L1, (D if collect else ())

    return step


def _uniform_block_step(maxq):
    """The uniform-grid column loop: (W1, Hinv1, S1, Z1) -> (Q1, Err1, L1)."""

    def step(W1, Hinv1, S1, Z1):
        count = W1.shape[1]
        W1 = W1.clone()
        Q1 = torch.zeros_like(W1)
        Err1 = torch.zeros_like(W1)
        L1 = torch.zeros_like(W1)
        for i in range(count):
            w = W1[:, i].clone()
            d = Hinv1[i, i]
            q = quantize_uniform(w, S1[:, i], Z1[:, i], maxq)
            err = (w - q) / d
            W1[:, i + 1:] -= err[:, None] * Hinv1[i, i + 1:][None, :]
            Q1[:, i] = q
            Err1[:, i] = err
            L1[:, i] = (w - q) ** 2 / d ** 2
        return Q1, Err1, L1, ()

    return step


class GraphedStep:
    """A block step captured in a CUDA graph on static input buffers.

    The first use runs the step once on a side stream (the warm-up that
    makes the sort's and the allocator's state before capture), then
    captures it; every call copies its inputs into the static buffers and
    replays. The outputs are the graph's own tensors: a caller copies them
    before the next call. A failed capture or replay raises."""

    def __init__(self, step: Callable, inputs):
        self.static_in = [x.clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(*self.static_in)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static_out = step(*self.static_in)

    def __call__(self, *inputs):
        for buf, x in zip(self.static_in, inputs):
            buf.copy_(x)
        self.graph.replay()
        return self.static_out


# captured block steps by geometry (device, kind, config, rows, count)
_GRAPHS: Dict[tuple, GraphedStep] = {}


def clear_graphs() -> None:
    """Drop every captured block step (and its memory pool)."""
    _GRAPHS.clear()


def _run_block(key: tuple, make_step: Callable, inputs, timer) -> tuple:
    W1 = inputs[0]
    if not W1.is_cuda:
        return make_step()(*inputs)
    key = (W1.device,) + key + tuple(W1.shape)
    g = _GRAPHS.get(key)
    if g is None:
        with timer("graph_capture"):
            g = GraphedStep(make_step(), inputs)
            _GRAPHS[key] = g
    return g(*inputs)


class GPTQ:
    """Layer-wise GPTQ calibrator.

        g = GPTQ(weight)              # weight (out_features, in_features)
        g.quantizer = MXQuantizer(...)
        g.add_batch(x)                # x (..., in_features), per batch
        Q, losses = g.fasterquant()
    """

    def __init__(self, weight: torch.Tensor, mode: str = "mx_prune"):
        W = weight.to(torch.float32)
        if W.ndim == 4:      # conv kernels: flatten the reduced dims
            W = W.reshape(W.shape[0], -1)
        self.W = W
        self.rows, self.columns = W.shape
        self.H = torch.zeros((self.columns, self.columns),
                             dtype=torch.float32, device=W.device)
        self.nsamples = np.float32(0.0)
        self.quantizer: Optional[MXQuantizer] = None
        self.mode = mode
        self.decisions = None

    @torch.no_grad()
    def add_batch(self, inp: torch.Tensor) -> None:
        """Running update H <- H n/(n+b) + (2/(n+b)) X^T X over a batch of b
        samples, its float32 scalars as JAX computes them."""
        if inp.ndim == 2:
            inp = inp[None]
        tmp = np.float32(inp.shape[0])
        inp2d = inp.reshape(-1, inp.shape[-1])
        new_n = self.nsamples + tmp
        self.H.mul_(float(self.nsamples / new_n))
        x = float(np.sqrt(np.float32(2.0) / new_n)) * inp2d.to(torch.float32)
        self.H.addmm_(x.T, x)
        self.nsamples = new_n

    def free(self) -> None:
        self.H = None

    @torch.no_grad()
    def inverse_hessian(self, percdamp: float = 0.01,
                        actorder: bool = False):
        """(W, Hinv, invperm) as the column loop takes them: dead columns
        (zero Hessian diagonal) zeroed in W with H's diagonal set to 1,
        columns in act order (descending diagonal, stable) where asked,
        H damped by ``percdamp`` of its mean diagonal, then Cholesky ->
        inverse -> the inverse's upper Cholesky factor."""
        W, H = self.W, self.H
        dead = torch.diagonal(H) == 0
        H = H + torch.diag(dead.to(H.dtype))          # H[dead, dead] = 1
        W = W * (~dead)[None, :]                      # W[:, dead] = 0
        invperm = None
        if actorder:
            perm = torch.argsort(-torch.diagonal(H), stable=True)
            W = W[:, perm]
            H = H[perm][:, perm]
            invperm = torch.argsort(perm, stable=True)
        damp = percdamp * torch.mean(torch.diagonal(H))
        eye = torch.eye(self.columns, dtype=H.dtype, device=H.device)
        L = torch.linalg.cholesky(H + damp * eye)
        Hinv = torch.linalg.cholesky(torch.cholesky_solve(eye, L)).T
        return W, Hinv, invperm

    @torch.no_grad()
    def fasterquant(self, blocksize: int = 128, percdamp: float = 0.01,
                    groupsize: int = -1, actorder: bool = False,
                    static_groups: bool = False, verbose: bool = False,
                    collect_decisions: bool = False,
                    timer=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Quantize the layer; returns (Q, losses). ``timer`` (a
        :class:`StageTimer`) takes the Cholesky and column-loop seconds."""
        timer = timer or _no_timer
        tick = time.time()
        with timer("cholesky"):
            W, Hinv, invperm = self.inverse_hessian(percdamp, actorder)
        with timer("column_loop"):
            if self.mode == "uniform":
                Q, losses = self._fasterquant_uniform(
                    W, Hinv, blocksize, groupsize, timer)
            else:
                Q, losses = self._fasterquant_mx(
                    W, Hinv, blocksize, collect_decisions, timer)
        if collect_decisions and self.mode != "uniform" and actorder:
            for n in _DECISION_NAMES:
                self.decisions[n] = self.decisions[n][:, invperm]
        if actorder:
            Q = Q[:, invperm]
        if verbose:
            print(f"time {time.time() - tick:.2f}")
            print(f"error {float(losses.sum()):.6f}")
        return Q, losses

    def _fasterquant_mx(self, W, Hinv, blocksize, collect, timer):
        qz = self.quantizer
        qcfg = quantizer_config(qz)
        Q = torch.zeros_like(W)
        losses = torch.zeros_like(W)
        W = W.clone()
        decs = [] if collect else None
        for i1 in range(0, self.columns, blocksize):
            i2 = min(i1 + blocksize, self.columns)
            Q1, Err1, L1, D1 = _run_block(
                ("mx", qcfg, self.mode, collect),
                lambda: mx_block_step(qcfg, self.mode, collect),
                (W[:, i1:i2], Hinv[i1:i2, i1:i2]), timer)
            Q[:, i1:i2] = Q1
            losses[:, i1:i2] = L1 / 2
            if collect:
                decs.append(tuple(d.clone() for d in D1))
            if i2 < self.columns:
                W[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]
        self.decisions = None
        if collect:
            self.decisions = {
                n: torch.cat([d[k] for d in decs], dim=1)
                for k, n in enumerate(_DECISION_NAMES)}
            self.decisions["block_size"] = qz.block_size
        return Q, losses

    def _fasterquant_uniform(self, W, Hinv, blocksize, groupsize, timer):
        """The uniform-grid path: group scales pre-fit on the damped but
        unquantized W, gathered per column inside the loop."""
        qz: UniformQuantizer = self.quantizer
        cols = self.columns
        if not qz.ready():
            qz.find_params(W, weight=True)
        if groupsize == -1:
            scale = qz.scale.reshape(-1, 1).expand(W.shape[0], cols)
            zero = qz.zero.reshape(-1, 1).expand(W.shape[0], cols)
        else:
            scs, zps = [], []
            for g0 in range(0, cols, groupsize):
                gq = UniformQuantizer()
                gq.maxq = qz.maxq
                gq.perchannel, gq.sym, gq.mse = qz.perchannel, qz.sym, qz.mse
                gq.norm, gq.grid, gq.maxshrink = qz.norm, qz.grid, qz.maxshrink
                gq.find_params(W[:, g0:g0 + groupsize], weight=True)
                n = min(groupsize, cols - g0)
                scs.append(gq.scale.reshape(-1, 1).expand(W.shape[0], n))
                zps.append(gq.zero.reshape(-1, 1).expand(W.shape[0], n))
            scale = torch.cat(scs, dim=1)
            zero = torch.cat(zps, dim=1)
        scale = scale.to(W.device).contiguous()
        zero = zero.to(W.device).contiguous()
        Q = torch.zeros_like(W)
        losses = torch.zeros_like(W)
        W = W.clone()
        for i1 in range(0, cols, blocksize):
            i2 = min(i1 + blocksize, cols)
            Q1, Err1, L1, _ = _run_block(
                ("uniform", qz.maxq), lambda: _uniform_block_step(qz.maxq),
                (W[:, i1:i2], Hinv[i1:i2, i1:i2], scale[:, i1:i2],
                 zero[:, i1:i2]), timer)
            Q[:, i1:i2] = Q1
            losses[:, i1:i2] = L1 / 2
            if i2 < cols:
                W[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]
        return Q, losses
