"""Straight-through quantization primitives of the MX layers.

Counterpart of ``microscopiq_tpu/nn/functional.py``, whose custom VJPs
become ``torch.autograd.Function``s:

* :func:`ste_elemwise`: element-wise (bfloat/fp container) quantization;
  the gradient passes straight through and is itself element-wise
  quantized under the backward specs' ``round_grad_input``.
* :func:`ste_mx` / :func:`ste_mx_outlier`: MX (outlier) block quantization
  whose backward is the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.elemwise import quantize_elemwise_op
from ..ops.mx import quantize_mx_op
from ..ops.outlier import quantize_mx_outlier_op
from ..specs import MxSpecs, get_backwards_mx_specs


class _SteElemwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mx_specs, round):
        ctx.mx_specs = mx_specs
        return quantize_elemwise_op(x, mx_specs, round=round)

    @staticmethod
    def backward(ctx, g):
        bspecs = get_backwards_mx_specs(ctx.mx_specs)
        g = quantize_elemwise_op(
            g, bspecs,
            round=None if bspecs is None else bspecs["round_grad_input"])
        return g, None, None


class _SteIdentity(torch.autograd.Function):
    """Forward ``fn(x)``; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_elemwise(x: torch.Tensor, mx_specs: Optional[MxSpecs],
                 round: Optional[str]) -> torch.Tensor:
    """Element-wise quantize with a straight-through, re-quantized
    gradient."""
    return _SteElemwise.apply(x, mx_specs, round)


def ste_mx(x: torch.Tensor, mx_specs, elem_format, axes: Sequence[int],
           round: str = "nearest") -> torch.Tensor:
    """MX block quantize with a straight-through gradient."""
    return _SteIdentity.apply(x, lambda t: quantize_mx_op(
        t, mx_specs, elem_format=elem_format, axes=list(axes), round=round))


def ste_mx_outlier(x: torch.Tensor, mx_specs, inlier_elem_format,
                   outlier_elem_format, axes: Sequence[int],
                   round: str = "nearest") -> torch.Tensor:
    """Outlier-aware MX quantize with a straight-through gradient."""
    return _SteIdentity.apply(x, lambda t: quantize_mx_outlier_op(
        t, mx_specs, inlier_elem_format=inlier_elem_format,
        outlier_elem_format=outlier_elem_format, axes=list(axes),
        round=round))
