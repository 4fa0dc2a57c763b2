"""Quantizer objects of the GPTQ engine.

Counterpart of ``microscopiq_tpu/quant/quantizer.py``:
* :func:`quantize_uniform` / :class:`UniformQuantizer`: GPTQ's min/max grid
  quantizer with per-channel, symmetric and MSE shrink-search options;
* :class:`MXQuantizer`: the configuration of the outlier-aware MX quantizer
  (stateless: ``find_params`` does nothing, ``ready()`` is always True),
  whose two-level quantizers are the port's ``ops/outlier.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.outlier import quantize_mx_outlier_hessian, quantize_mx_outlier_v1


def quantize_uniform(x, scale, zero, maxq):
    """Uniform grid quantize-dequantize; maxq < 0 selects the trits mode
    (+-scale/zero thresholds)."""
    if maxq < 0:
        return ((x > scale / 2).to(x.dtype) * scale
                + (x < zero / 2).to(x.dtype) * zero)
    q = torch.clamp(torch.round(x / scale) + zero, 0, maxq)
    return scale * (q - zero)


class UniformQuantizer:
    """Min/max uniform quantizer with optional MSE shrink search."""

    def __init__(self, shape: int = 1):
        self.maxq = 0
        self.scale = torch.zeros(shape)
        self.zero = torch.zeros(shape)
        self.perchannel = False
        self.sym = True
        self.mse = False
        self.norm = 2.4
        self.grid = 100
        self.maxshrink = 0.8

    def configure(self, bits, perchannel=False, sym=True, mse=False,
                  norm=2.4, grid=100, maxshrink=0.8, trits=False):
        self.maxq = 2 ** bits - 1
        self.perchannel = perchannel
        self.sym = sym
        self.mse = mse
        self.norm = norm
        self.grid = grid
        self.maxshrink = maxshrink
        if trits:
            self.maxq = -1

    def find_params(self, x: torch.Tensor, weight: bool = False):
        shape = x.shape
        if self.perchannel:
            if weight:
                x = x.reshape(shape[0], -1)
            elif len(shape) == 4:
                x = x.permute(1, 0, 2, 3).reshape(shape[1], -1)
            elif len(shape) == 3:
                x = x.reshape(-1, shape[-1]).T
            elif len(shape) == 2:
                x = x.T
        else:
            x = x.reshape(1, -1)

        zero_row = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        xmin = torch.minimum(x.amin(dim=1), zero_row)
        xmax = torch.maximum(x.amax(dim=1), zero_row)
        if self.sym:
            xmax = torch.maximum(xmin.abs(), xmax)
            xmin = torch.where(xmin < 0, -xmax, xmin)
        degenerate = (xmin == 0) & (xmax == 0)
        xmin = torch.where(degenerate, torch.full_like(xmin, -1.0), xmin)
        xmax = torch.where(degenerate, torch.full_like(xmax, 1.0), xmax)

        if self.maxq < 0:
            self.scale, self.zero = xmax, xmin
        else:
            self.scale = (xmax - xmin) / self.maxq
            if self.sym:
                self.zero = torch.full_like(self.scale, (self.maxq + 1) / 2)
            else:
                self.zero = torch.round(-xmin / self.scale)

        if self.mse:
            best = torch.full((x.shape[0],), float("inf"), device=x.device)
            scale, zero = self.scale, self.zero
            for i in range(int(self.maxshrink * self.grid)):
                p = 1 - i / self.grid
                xmin1, xmax1 = p * xmin, p * xmax
                scale1 = (xmax1 - xmin1) / self.maxq
                zero1 = torch.round(-xmin1 / scale1) if not self.sym else zero
                q = quantize_uniform(x, scale1[:, None], zero1[:, None],
                                     self.maxq)
                err = torch.sum(torch.abs(q - x) ** self.norm, dim=1)
                better = err < best
                best = torch.where(better, err, best)
                scale = torch.where(better, scale1, scale)
                zero = torch.where(better, zero1, zero)
            self.scale, self.zero = scale, zero

        if not self.perchannel:
            rep = shape[0] if weight else (
                shape[2] if len(shape) == 3 else shape[1])
            self.scale = self.scale.repeat(rep)
            self.zero = self.zero.repeat(rep)

        if weight:
            tgt = [-1] + [1] * (len(shape) - 1)
            self.scale = self.scale.reshape(tgt)
            self.zero = self.zero.reshape(tgt)
        elif len(shape) == 4:
            self.scale = self.scale.reshape(1, -1, 1, 1)
            self.zero = self.zero.reshape(1, -1, 1, 1)
        elif len(shape) == 3:
            self.scale = self.scale.reshape(1, 1, -1)
            self.zero = self.zero.reshape(1, 1, -1)
        elif len(shape) == 2:
            self.scale = self.scale[None, :]
            self.zero = self.zero[None, :]

    def quantize(self, x):
        if self.ready():
            return quantize_uniform(x, self.scale, self.zero, self.maxq)
        return x

    def enabled(self):
        return self.maxq > 0

    def ready(self):
        return bool(torch.all(self.scale != 0))


@dataclasses.dataclass
class MXQuantizer:
    """Outlier-aware MX quantizer configuration; ``quantize`` applies the v1
    (RTN) outlier quantizer, and the GPTQ engine calls the Hessian variant
    with these fields."""

    inlier_scale_bits: int = 8
    outlier_scale_bits: int = 8
    inlier_elem_format: Optional[str] = "int2"
    outlier_elem_format: Optional[str] = "fp4_e2m1"
    shared_exp_method: str = "max"
    std_dev: float = 2.0
    axes: tuple = (0,)
    block_size: int = 16
    round: str = "nearest"
    flush_fp32_subnorms: bool = False
    # 0: unbounded (the reference); k > 0 keeps the k largest-|A| outliers
    # of a block (the compact serving transport's slot budget)
    max_outliers_per_block: int = 0

    def configure(self, inlier_scale_bits, outlier_scale_bits,
                  inlier_elem_format, outlier_elem_format,
                  shared_exp_method="max", std_dev=2, axes=None,
                  block_size=0, round="nearest", flush_fp32_subnorms=False):
        self.inlier_scale_bits = inlier_scale_bits
        self.outlier_scale_bits = outlier_scale_bits
        self.inlier_elem_format = inlier_elem_format
        self.outlier_elem_format = outlier_elem_format
        self.shared_exp_method = shared_exp_method
        self.std_dev = std_dev
        self.axes = tuple(axes) if axes is not None else None
        self.block_size = block_size
        self.round = round
        self.flush_fp32_subnorms = flush_fp32_subnorms

    def find_params(self, x, weight: bool = False):
        pass

    def quantize(self, x):
        return quantize_mx_outlier_v1(
            x, self.inlier_scale_bits, self.outlier_scale_bits,
            self.inlier_elem_format, self.outlier_elem_format,
            self.shared_exp_method, self.std_dev, list(self.axes),
            self.block_size, self.round, self.flush_fp32_subnorms)

    def quantize_hessian(self, x):
        """Quantized x and the per-block outlier counts (GPTQ's)."""
        return quantize_mx_outlier_hessian(
            x, self.inlier_scale_bits, self.outlier_scale_bits,
            self.inlier_elem_format, self.outlier_elem_format,
            self.shared_exp_method, self.std_dev, list(self.axes),
            self.block_size, self.round, self.flush_fp32_subnorms,
            self.max_outliers_per_block)

    def enabled(self):
        return self.inlier_elem_format is not None

    def ready(self):
        return True
