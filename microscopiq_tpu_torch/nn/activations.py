"""MX-quantized activations, functional and as modules.

Counterpart of ``microscopiq_tpu/nn/activations.py``: each activation
element-wise quantizes its input and output under ``round_output``; the
backward is the true derivative, re-quantized by the straight-through
primitive. ``gelu`` is the tanh approximation, ``jax.nn.gelu``'s default;
``sigmoid`` goes through the vector-op exp and reciprocal chain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..specs import MxSpecs
from .functional import ste_elemwise
from .vector_ops import vec_exp, vec_recip


def _q(x, specs):
    return ste_elemwise(x, specs, specs["round_output"])


def _wrap(fn):
    def quantized(x, mx_specs: Optional[MxSpecs] = None):
        if mx_specs is None:
            return fn(x)
        return _q(fn(_q(x, mx_specs)), mx_specs)
    return quantized


relu = _wrap(torch.relu)
relu6 = _wrap(lambda x: torch.clamp(x, 0, 6))
gelu = _wrap(lambda x: F.gelu(x, approximate="tanh"))
tanh = _wrap(torch.tanh)


def leaky_relu(x, negative_slope: float = 0.01,
               mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return F.leaky_relu(x, negative_slope)
    x = _q(x, mx_specs)
    return _q(torch.where(x >= 0, x, negative_slope * x), mx_specs)


def sigmoid(x, mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return torch.sigmoid(x)
    x = _q(x, mx_specs)
    return vec_recip(1.0 + vec_exp(-x, mx_specs), mx_specs)


def silu(x, mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return F.silu(x)
    x = _q(x, mx_specs)
    return _q(x * sigmoid(x, mx_specs), mx_specs)


class _Act(nn.Module):
    _fn = None

    def __init__(self, mx_specs: Optional[MxSpecs] = None):
        super().__init__()
        self.mx_specs = mx_specs

    def forward(self, x):
        return type(self)._fn(x, self.mx_specs)


class ReLU(_Act):
    _fn = staticmethod(relu)


class ReLU6(_Act):
    _fn = staticmethod(relu6)


class GELU(_Act):
    _fn = staticmethod(gelu)


class SiLU(_Act):
    _fn = staticmethod(silu)


class Sigmoid(_Act):
    _fn = staticmethod(sigmoid)


class Tanh(_Act):
    _fn = staticmethod(tanh)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01,
                 mx_specs: Optional[MxSpecs] = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.mx_specs = mx_specs

    def forward(self, x):
        return leaky_relu(x, self.negative_slope, self.mx_specs)
