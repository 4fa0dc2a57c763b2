"""MX linear, matmul and bmm with their quantized backward passes.

Counterpart of ``microscopiq_tpu/nn/linear.py``; its custom VJP becomes a
``torch.autograd.Function`` (:func:`mx_linear`).

Forward: element-wise quantize the input, weight and bias (bfloat/fp
container), MX-outlier quantize input and weight along the contraction
axis (the input along ``a_axes`` where the spec sets it), multiply, and
element-wise quantize the output (again after the bias add). The backward
is straight-through with the gradients and the saved operands
re-quantized under the backward specs: for ``grad_w`` along the example
axis (-2), for ``grad_in`` the weight along its out axis (0) and the
gradient along its last axis; the bias gradient sums the quantized
gradient. The saved operands are the bfloat-quantized ones under
``quantize_backprop``, else the raw ones.

:class:`QuantizedLinear` holds no weight: it multiplies by a packed one
through the port's GEMV/GEMM kernels (:func:`packed_matmul`, which the
models' ``QLinear`` also calls).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..ops.cuda.dequant_matmul import (dequant_matmul,
                                       dequant_matmul_reference)
from ..ops.cuda.outlier_matmul import (dequant_matmul_nb,
                                       dequant_matmul_nb_reference,
                                       dequant_matmul_outlier,
                                       dequant_matmul_outlier_reference)
from ..ops.elemwise import quantize_elemwise_op
from ..ops.mx import quantize_mx_op
from ..ops.outlier import quantize_mx_outlier_op
from ..ops.packing import PackedMX, PackedOutlierNB
from ..specs import MxSpecs, get_backwards_mx_specs
from .functional import ste_elemwise, ste_mx


def _plain(x, weight, bias):
    y = x @ weight.T
    return y if bias is None else y + bias


def mx_linear_forward(x, weight, bias, mx_specs):
    """(y, bf_in, bf_weight): the fake-quant forward and its bfloat-
    quantized operands."""
    bf_in = quantize_elemwise_op(x, mx_specs, round=mx_specs["round_output"])
    bf_weight = quantize_elemwise_op(weight, mx_specs,
                                     round=mx_specs["round_weight"])
    a_axes = mx_specs.get("a_axes")
    qis_input = quantize_mx_outlier_op(
        bf_in, mx_specs, inlier_elem_format=mx_specs["a_elem_format"],
        outlier_elem_format=mx_specs["a_elem_format"],
        axes=[-1 if a_axes is None else a_axes],
        round=mx_specs["round_mx_output"])
    qis_weight = quantize_mx_outlier_op(
        bf_weight, mx_specs, inlier_elem_format=mx_specs["w_elem_format"],
        outlier_elem_format=mx_specs["w_elem_format"], axes=[-1],
        round=mx_specs["round_mx_output"])
    out = quantize_elemwise_op(qis_input @ qis_weight.T, mx_specs,
                               round=mx_specs["round_output"])
    if bias is not None:
        bf_bias = quantize_elemwise_op(bias, mx_specs,
                                       round=mx_specs["round_weight"])
        out = quantize_elemwise_op(out + bf_bias, mx_specs,
                                   round=mx_specs["round_output"])
    return out, bf_in, bf_weight


def mx_linear_backward(g, x, weight, has_bias: bool, mx_specs):
    """(grad_in, grad_w, grad_b) of :func:`mx_linear` from the saved
    operands ``x``/``weight`` (bfloat-quantized under ``quantize_backprop``,
    else raw)."""
    if mx_specs is None:
        grad_in = g @ weight
        grad_w = torch.einsum("...o,...i->oi", g, x)
        grad_b = g.reshape(-1, g.shape[-1]).sum(0) if has_bias else None
        return grad_in, grad_w, grad_b
    bspecs = get_backwards_mx_specs(mx_specs)
    out_dim, in_dim = weight.shape
    g = quantize_elemwise_op(g, bspecs, round=bspecs["round_grad_input"])

    # grad_weight: both operands quantized along the example axis
    qex_input = quantize_mx_op(
        x, bspecs, elem_format=bspecs["a_elem_format_bp_ex"], axes=[-2],
        round=bspecs["round_mx_input_grad_weight"])
    qex_g = quantize_mx_op(
        g, bspecs, elem_format=bspecs["a_elem_format_bp_ex"], axes=[-2],
        round=bspecs["round_mx_grad_output_grad_weight"])
    grad_w = qex_g.reshape(-1, out_dim).T @ qex_input.reshape(-1, in_dim)
    grad_w = quantize_elemwise_op(grad_w, bspecs,
                                  round=bspecs["round_grad_weight"])

    # grad_input: the weight along its out axis, the gradient along its last
    qos_weight = quantize_mx_op(
        weight, bspecs, elem_format=bspecs["w_elem_format_bp"], axes=[0],
        round=bspecs["round_mx_weight_grad_input"])
    qos_g = quantize_mx_op(
        g, bspecs, elem_format=bspecs["a_elem_format_bp_os"], axes=[-1],
        round=bspecs["round_mx_grad_output_grad_input"])
    grad_in = quantize_elemwise_op(qos_g @ qos_weight, bspecs,
                                   round=bspecs["round_grad_input"])

    grad_b = None
    if has_bias:
        grad_b = quantize_elemwise_op(g.reshape(-1, out_dim).sum(0), bspecs,
                                      round=bspecs["round_grad_weight"])
    return grad_in, grad_w, grad_b


class _MXLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mx_specs):
        ctx.mx_specs = mx_specs
        ctx.has_bias = bias is not None
        if mx_specs is None:
            ctx.save_for_backward(x, weight)
            return _plain(x, weight, bias)
        out, bf_in, bf_weight = mx_linear_forward(x, weight, bias, mx_specs)
        if mx_specs["quantize_backprop"]:
            ctx.save_for_backward(bf_in, bf_weight)
        else:
            ctx.save_for_backward(x, weight)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        grad_in, grad_w, grad_b = mx_linear_backward(
            g, x, weight, ctx.has_bias, ctx.mx_specs)
        return grad_in, grad_w, grad_b, None


def mx_linear(x, weight, bias, mx_specs: Optional[MxSpecs]):
    """y = x @ weight.T (+ bias), fully fake-quantized; weight (out, in)."""
    return _MXLinear.apply(x, weight, bias, mx_specs)


def linear(x, weight, bias=None, mx_specs: Optional[MxSpecs] = None):
    """Functional MX linear; the plain product without a spec."""
    if mx_specs is None:
        return _plain(x, weight, bias)
    return mx_linear(x, weight, bias, mx_specs)


def matmul(a, b, mx_specs: Optional[MxSpecs] = None,
           mode_config: str = "aa"):
    """MX matmul a @ b. ``mode_config`` picks each operand's format: 'aa'
    both activations, 'aw' a activation and b weight, 'wa' the reverse."""
    if mx_specs is None:
        return a @ b
    fmt_a = mx_specs["a_elem_format" if mode_config in ("aa", "aw")
                     else "w_elem_format"]
    fmt_b = mx_specs["a_elem_format" if mode_config in ("aa", "wa")
                     else "w_elem_format"]
    rnd = mx_specs["round_output"]
    qa = ste_mx(ste_elemwise(a, mx_specs, rnd), mx_specs, fmt_a, (-1,),
                mx_specs["round_mx_output"])
    qb = ste_mx(ste_elemwise(b, mx_specs, rnd), mx_specs, fmt_b, (-2,),
                mx_specs["round_mx_output"])
    return ste_elemwise(qa @ qb, mx_specs, rnd)


bmm = matmul  # batched semantics are the same under broadcasting


def lecun_normal(shape, fan_in: int, device,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at 2 std, scaled to
    variance 1/fan_in. Drawn on the generator's device (the CPU without
    one) and moved to ``device``, so one seed gives one draw anywhere."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, device=None if generator is None
                    else generator.device)
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
    return t.to(device)


class MXLinear(nn.Module):
    """Fake-quant linear; ``kernel`` is stored flax-style (in, out) and
    applied as the (out, in) weight. Initialized as flax does (lecun-normal
    kernel, zero bias) on ``device`` (the card unless the caller asks for
    the CPU); ``convert.load_flax_variables`` loads a flax tree."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, mx_specs: Optional[MxSpecs] = None,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.mx_specs = mx_specs
        self.kernel = nn.Parameter(lecun_normal(
            (in_features, features), in_features, dev, generator).to(dtype))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype,
                                              device=dev))
                     if use_bias else None)

    def forward(self, x):
        return linear(x, self.kernel.T, self.bias, self.mx_specs)


def packed_matmul(x, w, out_dtype, use_kernels: bool = True):
    """x @ a packed weight: a ``PackedMX`` through ``dequant_matmul``, a
    ``PackedOutlierNB`` through ``dequant_matmul_nb``, a
    ``PackedMXOutlier`` through ``dequant_matmul_outlier`` (each picks its
    GEMV or GEMM by token count, and its plain version on CPU tensors);
    ``use_kernels=False`` takes the plain versions on any device."""
    if isinstance(w, PackedMX):
        f = dequant_matmul if use_kernels else dequant_matmul_reference
    elif isinstance(w, PackedOutlierNB):
        f = dequant_matmul_nb if use_kernels else dequant_matmul_nb_reference
    else:
        f = (dequant_matmul_outlier if use_kernels
             else dequant_matmul_outlier_reference)
    return f(x, w, out_dtype=out_dtype)


class QuantizedLinear(nn.Module):
    """Serving linear over a packed weight handed to each call, through
    :func:`packed_matmul`."""

    def __init__(self, out_dtype=torch.float32):
        super().__init__()
        self.out_dtype = out_dtype

    def forward(self, x, packed):
        return packed_matmul(x, packed, self.out_dtype)
