"""RMSNorm, LayerNorm, GroupNorm and BatchNorm, plain and MX-quantized.

Counterpart of ``microscopiq_tpu/nn/norms.py``. Without ``mx_specs`` each
computes in x's dtype as the JAX module does (bf16 at serving). With it,
every intermediate of the normalization (mean, centred values, variance,
reciprocal square root, normalized values, affine output) goes through the
straight-through element-wise quantizer (:func:`norm_forward`). Statistics
are population variances (``jnp.var``), the running variance included, so
``torch.nn.BatchNorm*`` (unbiased running variance) does not fit.

RMSNorm and LayerNorm keep ``scale``/``bias`` as buffers, installed by the
models' ``install_tree``; GroupNorm and BatchNorm hold parameters (and
BatchNorm its running ``mean``/``var`` buffers), loaded from a flax tree by
``convert.load_flax_variables``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import resolve_device
from ..specs import MxSpecs
from .functional import ste_elemwise
from .vector_ops import vec_recip, vec_sqrt


def _q(x, specs, round=None):
    return ste_elemwise(x, specs, round)


def norm_forward(x, axes: Sequence[int], weight, bias, eps: float, mx_specs,
                 use_mean: bool = True):
    """The quantized normalization core over ``axes``."""
    axes = tuple(axes)
    if use_mean:
        mean = _q(torch.mean(x, dim=axes, keepdim=True), mx_specs)
        xc = _q(x - mean, mx_specs)
    else:
        xc = x
    var = _q(torch.mean(xc * xc, dim=axes, keepdim=True), mx_specs)
    rstd = _q(vec_recip(vec_sqrt(var + eps, mx_specs), mx_specs), mx_specs)
    xn = _q(xc * rstd, mx_specs)
    if weight is not None:
        xn = _q(xn * weight, mx_specs)
    if bias is not None:
        xn = _q(xn + bias, mx_specs)
    return xn


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x*x) + eps) * scale``, computed in x's dtype (bf16 at
    serving) exactly as the JAX module does; a float32 ``scale`` promotes
    the output to float32, as in JAX. With ``mx_specs``, the quantized
    core without the mean."""

    def __init__(self, features: int, eps: float = 1e-6,
                 mx_specs: Optional[MxSpecs] = None):
        super().__init__()
        self.eps = eps
        self.mx_specs = mx_specs
        self.register_buffer("scale", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mx_specs is not None:
            return norm_forward(_q(x, self.mx_specs), (-1,), self.scale,
                                None, self.eps, self.mx_specs,
                                use_mean=False)
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.scale


class LayerNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * scale (+ bias)`` over the last
    axis, the population variance, in x's dtype as the JAX module computes
    it: OPT's norms with a bias, MPT's without (``use_bias=False``). With
    ``mx_specs``, the quantized core."""

    def __init__(self, features: int, eps: float = 1e-5,
                 use_bias: bool = True, mx_specs: Optional[MxSpecs] = None):
        super().__init__()
        self.eps = eps
        self.mx_specs = mx_specs
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features) if use_bias
                             else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mx_specs is not None:
            return norm_forward(_q(x, self.mx_specs), (-1,), self.scale,
                                self.bias, self.eps, self.mx_specs,
                                use_mean=True)
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale
        return y if self.bias is None else y + self.bias


class GroupNorm(nn.Module):
    """Group normalization of (N, C, ...) inputs (channel axis 1) with a
    per-channel affine ``scale``/``bias``, on ``device`` (the card unless
    the caller asks for the CPU)."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-5,
                 mx_specs: Optional[MxSpecs] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_groups = num_groups
        self.eps = eps
        self.mx_specs = mx_specs
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C = x.shape[0], x.shape[1]
        g = self.num_groups
        xg = x.reshape((N, g, C // g) + tuple(x.shape[2:]))
        axes = tuple(range(2, xg.ndim))
        if self.mx_specs is None:
            mean = torch.mean(xg, dim=axes, keepdim=True)
            var = torch.var(xg, dim=axes, keepdim=True, correction=0)
            xn = (xg - mean) * torch.rsqrt(var + self.eps)
        else:
            xn = norm_forward(_q(xg, self.mx_specs), axes, None, None,
                              self.eps, self.mx_specs, use_mean=True)
        xn = xn.reshape(x.shape)
        shape = (1, C) + (1,) * (x.ndim - 2)
        return xn * self.scale.reshape(shape) + self.bias.reshape(shape)


class BatchNorm(nn.Module):
    """Batch normalization over every axis but the channel axis 1 (the
    reference's BN1d/2d/3d in one), with running ``mean``/``var`` buffers
    (flax's ``batch_stats``). ``use_running_average`` (the constructor's, or
    the call's where given) normalizes by the running statistics; else by
    the batch's population statistics, which update the running buffers
    by ``momentum`` in training mode only. Built on ``device``, the card
    unless the caller asks for the CPU."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1, use_running_average: bool = True,
                 mx_specs: Optional[MxSpecs] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.momentum = momentum
        self.use_running_average = use_running_average
        self.mx_specs = mx_specs
        self.scale = nn.Parameter(torch.ones(features, device=dev))
        self.bias = nn.Parameter(torch.zeros(features, device=dev))
        self.register_buffer("mean", torch.zeros(features, device=dev))
        self.register_buffer("var", torch.ones(features, device=dev))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        use_ra = (self.use_running_average if use_running_average is None
                  else use_running_average)
        axes = (0,) + tuple(range(2, x.ndim))
        if use_ra:
            mean, var = self.mean, self.var
        else:
            mean = torch.mean(x, dim=axes)
            var = torch.var(x, dim=axes, correction=0)
            if self.training:
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * var)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        w, b = self.scale.reshape(shape), self.bias.reshape(shape)
        if self.mx_specs is None:
            xn = (x - mean.reshape(shape)) * torch.rsqrt(
                var.reshape(shape) + self.eps)
            return xn * w + b
        specs = self.mx_specs
        xc = _q(_q(x, specs) - mean.reshape(shape), specs)
        rstd = _q(vec_recip(vec_sqrt(var.reshape(shape) + self.eps, specs),
                            specs), specs)
        xn = _q(_q(xc * rstd, specs) * w, specs)
        return _q(xn + b, specs)
