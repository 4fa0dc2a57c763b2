"""MX-quantized convolutions and pooling.

Counterpart of ``microscopiq_tpu/nn/conv.py``; its custom VJP becomes a
``torch.autograd.Function`` (:func:`mx_conv`). Layout: (N, C, *spatial)
inputs, (O, I, *kernel) weights.

Forward: input and weight element-wise quantized, MX-quantized along the
input-channel (contraction) axis 1, convolved, the quantized bias added,
the result element-wise quantized once. Backward: the gradient element-wise
re-quantized under the backward specs; ``grad_w`` contracts the input and
the gradient MX-quantized along the batch axis 0, ``grad_x`` the weight
along its out-channel axis 0 and the gradient along its channel axis 1;
each gradient element-wise quantized under its own rounding knob. The
transposed contractions are the vector-Jacobian products of the plain conv
at the quantized operands (``torch.autograd.grad``).

Padding is JAX's explicit ``((lo, hi), ...)`` per spatial axis. The
transposed conv is ``lax.conv_transpose(..., transpose_kernel=True)``:
``F.conv_transpose2d`` without padding is that conv at padding
``d*(k-1)`` on each side, so the result is cropped (or zero-padded) to the
explicit padding.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.elemwise import quantize_elemwise_op
from ..ops.mx import quantize_mx_op
from ..specs import MxSpecs, get_backwards_mx_specs
from .functional import ste_elemwise
from .linear import lecun_normal

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _norm_args(stride, padding, dilation, nd):
    """stride and dilation as tuples, padding as ((lo, hi), ...)."""
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    if isinstance(padding, int):
        padding = ((padding, padding),) * nd
    elif padding and isinstance(padding[0], int):
        padding = tuple((p, p) for p in padding)
    else:
        padding = tuple(tuple(p) for p in padding)
    return stride, padding, dilation


def _pad_arg(padding):
    """``F.pad``'s argument (last axis first) from ((lo, hi), ...)."""
    return [p for lo_hi in reversed(padding) for p in lo_hi]


def raw_conv(x, w, stride, padding, dilation, groups, nd, transpose):
    """The plain conv (``lax.conv_general_dilated``) or, with
    ``transpose``, ``lax.conv_transpose(x, w.swapaxes(0, 1), ...,
    transpose_kernel=True)`` for an OI weight ``w``."""
    if transpose:
        full = _CONV_T[nd](x, w.transpose(0, 1), stride=stride,
                           dilation=dilation)
        ks = w.shape[2:]
        extra = [(lo - d * (k - 1), hi - d * (k - 1))
                 for (lo, hi), d, k in zip(padding, dilation, ks)]
        return F.pad(full, _pad_arg(extra))
    if any(p for lo_hi in padding for p in lo_hi):
        x = F.pad(x, _pad_arg(padding))
    return _CONV[nd](x, w, stride=stride, dilation=dilation, groups=groups)


def _bias_shape(nd):
    return (1, -1) + (1,) * nd


def _vjp(fn, primal, cotangent):
    with torch.enable_grad():
        p = primal.detach().requires_grad_()
        return torch.autograd.grad(fn(p), p, cotangent)[0]


class _MXConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, args, mx_specs):
        stride, padding, dilation, groups, nd, transpose = args
        ctx.args, ctx.mx_specs = args, mx_specs
        ctx.has_bias = bias is not None
        conv = lambda x_, w_: raw_conv(x_, w_, stride, padding, dilation,
                                       groups, nd, transpose)
        if mx_specs is None:
            ctx.save_for_backward(x, w)
            out = conv(x, w)
            return out if bias is None else out + bias.reshape(
                _bias_shape(nd))
        bf_x = quantize_elemwise_op(x, mx_specs,
                                    round=mx_specs["round_output"])
        bf_w = quantize_elemwise_op(w, mx_specs,
                                    round=mx_specs["round_weight"])
        qid_x = quantize_mx_op(bf_x, mx_specs,
                               elem_format=mx_specs["a_elem_format"],
                               axes=[1])
        qid_w = quantize_mx_op(bf_w, mx_specs,
                               elem_format=mx_specs["w_elem_format"],
                               axes=[1])
        out = conv(qid_x, qid_w)
        if bias is not None:
            bf_b = quantize_elemwise_op(bias, mx_specs,
                                        round=mx_specs["round_weight"])
            out = out + bf_b.reshape(_bias_shape(nd))
        out = quantize_elemwise_op(out, mx_specs,
                                   round=mx_specs["round_output"])
        if mx_specs["quantize_backprop"]:
            ctx.save_for_backward(bf_x, bf_w)
        else:
            ctx.save_for_backward(x, w)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, nd, transpose = ctx.args
        mx_specs = ctx.mx_specs
        conv = lambda x_, w_: raw_conv(x_, w_, stride, padding, dilation,
                                       groups, nd, transpose)
        sum_axes = (0, *range(2, g.ndim))
        if mx_specs is None:
            grad_b = g.sum(dim=sum_axes) if ctx.has_bias else None
            return (_vjp(lambda x_: conv(x_, w), x, g),
                    _vjp(lambda w_: conv(x, w_), w, g), grad_b, None, None)

        bspecs = get_backwards_mx_specs(mx_specs)
        g = quantize_elemwise_op(g, bspecs, round=bspecs["round_grad_input"])
        # grad_weight: input and gradient MX-quantized along the batch axis
        qex_x = quantize_mx_op(x, bspecs,
                               elem_format=bspecs["a_elem_format"], axes=[0])
        qex_g = quantize_mx_op(g, bspecs,
                               elem_format=bspecs["a_elem_format"], axes=[0])
        grad_w = quantize_elemwise_op(
            _vjp(lambda w_: conv(qex_x, w_), w, qex_g), bspecs,
            round=bspecs["round_grad_weight"])
        # grad_input: weight and gradient along the out-channel axis, the
        # reduction axis of the transposed conv
        qod_w = quantize_mx_op(w, bspecs,
                               elem_format=bspecs["w_elem_format"], axes=[0])
        qod_g = quantize_mx_op(g, bspecs,
                               elem_format=bspecs["a_elem_format"], axes=[1])
        grad_x = quantize_elemwise_op(
            _vjp(lambda x_: conv(x_, qod_w), x, qod_g), bspecs,
            round=bspecs["round_grad_input"])
        grad_b = None
        if ctx.has_bias:
            grad_b = quantize_elemwise_op(g.sum(dim=sum_axes), bspecs,
                                          round=bspecs["round_grad_weight"])
        return grad_x, grad_w, grad_b, None, None


def mx_conv(x, w, bias, stride, padding, dilation, groups: int, nd: int,
            transpose: bool, mx_specs: Optional[MxSpecs]):
    """Quantized N-d conv (+ bias) with the quantized backward; stride,
    padding and dilation normalized as :func:`_norm_args` gives them."""
    return _MXConv.apply(x, w, bias,
                         (stride, padding, dilation, groups, nd, transpose),
                         mx_specs)


def _conv_nd(x, w, bias, stride, padding, dilation, groups, nd,
             mx_specs: Optional[MxSpecs], transpose: bool = False):
    stride, padding, dilation = _norm_args(stride, padding, dilation, nd)
    return mx_conv(x, w, bias, stride, padding, dilation, groups, nd,
                   transpose, mx_specs)


def conv1d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1,
           mx_specs: Optional[MxSpecs] = None):
    return _conv_nd(x, w, bias, stride, padding, dilation, groups, 1,
                    mx_specs)


def conv2d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1,
           mx_specs: Optional[MxSpecs] = None):
    return _conv_nd(x, w, bias, stride, padding, dilation, groups, 2,
                    mx_specs)


def conv3d(x, w, bias=None, stride=1, padding=0, dilation=1, groups=1,
           mx_specs: Optional[MxSpecs] = None):
    return _conv_nd(x, w, bias, stride, padding, dilation, groups, 3,
                    mx_specs)


def conv_transpose2d(x, w, bias=None, stride=1, padding=0, dilation=1,
                     mx_specs: Optional[MxSpecs] = None):
    """w: (I, O, kH, kW), torch's ConvTranspose layout; swapped to OI so
    that the contraction axis (in-channels) is axis 1."""
    return _conv_nd(x, w.transpose(0, 1), bias, stride, padding, dilation,
                    1, 2, mx_specs, transpose=True)


def adaptive_avg_pool2d(x, output_size: Union[int, Tuple[int, int]],
                        mx_specs: Optional[MxSpecs] = None):
    """Quantized mean pooling to ``output_size`` (which must divide the
    spatial size)."""
    oh, ow = _tuple(output_size, 2)
    N, C, H, W = x.shape
    if H % oh or W % ow:
        raise ValueError("adaptive pooling requires divisible sizes")
    if mx_specs is not None:
        x = ste_elemwise(x, mx_specs, mx_specs["round_output"])
    out = x.reshape(N, C, oh, H // oh, ow, W // ow).mean(dim=(3, 5))
    if mx_specs is not None:
        out = ste_elemwise(out, mx_specs, mx_specs["round_output"])
    return out


class Conv2d(nn.Module):
    """Conv2d module: an OIHW ``kernel`` (lecun-normal, as flax
    initializes it) and a zero ``bias``, on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, in_features: int, out_features: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 use_bias: bool = True, mx_specs: Optional[MxSpecs] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        kh, kw = _tuple(kernel_size, 2)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.mx_specs = mx_specs
        cin = in_features // groups
        # flax's fan_in for an OIHW kernel shape: every axis but the last
        fan_in = out_features * cin * kh
        self.kernel = nn.Parameter(lecun_normal(
            (out_features, cin, kh, kw), fan_in, dev, generator))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=dev))
                     if use_bias else None)

    def forward(self, x):
        return conv2d(x, self.kernel, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, self.mx_specs)
