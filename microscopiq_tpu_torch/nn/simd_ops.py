"""SIMD element-wise op models (low-precision vector units).

Counterpart of ``microscopiq_tpu/nn/simd_ops.py``: add, sub, mul, div,
sqrt, square, exp, log, reduce_sum, reduce_mean, norm and split, each
quantizing its inputs and output to the container format under
``round_output``; the gradients are re-quantized by the straight-through
primitive. ``mx_specs=None`` is the plain op.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..specs import MxSpecs
from .functional import ste_elemwise
from .vector_ops import vec_div, vec_exp, vec_sqrt


def _q(x, specs):
    return ste_elemwise(x, specs,
                        None if specs is None else specs["round_output"])


def _binary(fn):
    def op(a, b, mx_specs: Optional[MxSpecs] = None):
        if mx_specs is None:
            return fn(a, b)
        return _q(fn(_q(a, mx_specs), _q(b, mx_specs)), mx_specs)
    return op


simd_add = _binary(torch.add)
simd_sub = _binary(torch.sub)
simd_mul = _binary(torch.mul)


def _dims(axis):
    """``axis`` (None, an int or a sequence) as torch's ``dim``."""
    if axis is None:
        return None
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _reduce(fn, x, axis, keepdims):
    dims = _dims(axis)
    if dims is None:
        out = fn(x)
        return out.reshape((1,) * x.ndim) if keepdims else out
    return fn(x, dim=dims, keepdim=keepdims)


def simd_div(a, b, mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return a / b
    return vec_div(_q(a, mx_specs), _q(b, mx_specs), mx_specs)


def simd_sqrt(x, mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return torch.sqrt(x)
    return vec_sqrt(_q(x, mx_specs), mx_specs)


def simd_square(x, mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return x * x
    x = _q(x, mx_specs)
    return _q(x * x, mx_specs)


def simd_exp(x, mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return torch.exp(x)
    return vec_exp(_q(x, mx_specs), mx_specs)


def simd_log(x, mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return torch.log(x)
    return _q(torch.log(_q(x, mx_specs)), mx_specs)


def simd_reduce_sum(x, axis=None, keepdims: bool = False,
                    mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return _reduce(torch.sum, x, axis, keepdims)
    return _q(_reduce(torch.sum, _q(x, mx_specs), axis, keepdims), mx_specs)


def simd_reduce_mean(x, axis=None, keepdims: bool = False,
                     mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return _reduce(torch.mean, x, axis, keepdims)
    return _q(_reduce(torch.mean, _q(x, mx_specs), axis, keepdims),
              mx_specs)


def simd_norm(x, axis=None, keepdims: bool = False,
              mx_specs: Optional[MxSpecs] = None):
    """L2 norm; with a spec, the quantized square, sum and sqrt chain."""
    if mx_specs is None:
        return torch.linalg.vector_norm(x, dim=_dims(axis), keepdim=keepdims)
    s = simd_reduce_sum(simd_square(x, mx_specs), axis=axis,
                        keepdims=keepdims, mx_specs=mx_specs)
    return vec_sqrt(s, mx_specs)


def simd_split(x, indices_or_sections, axis: int = 0,
               mx_specs: Optional[MxSpecs] = None):
    """``jnp.split``: an int is a number of equal sections, a sequence the
    indices to split at."""
    if isinstance(indices_or_sections, int):
        parts = list(torch.chunk(x, indices_or_sections, dim=axis))
        if x.shape[axis] % indices_or_sections:
            raise ValueError("array split does not result in an equal "
                             "division")
    else:
        bounds = [0, *indices_or_sections, x.shape[axis]]
        parts = [x.narrow(axis, a, b - a)
                 for a, b in zip(bounds[:-1], bounds[1:])]
    if mx_specs is None:
        return parts
    return [_q(p, mx_specs) for p in parts]
