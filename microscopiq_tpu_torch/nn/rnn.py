"""MX-quantized LSTM.

Counterpart of ``microscopiq_tpu/nn/rnn.py``: the gate products go through
the MX linear, the gate nonlinearities through the quantized sigmoid/tanh
chain and the state updates through the SIMD ops; the recurrence over
(T, B, D) sequences is a Python loop (``lax.scan`` in JAX).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..specs import MxSpecs
from .activations import sigmoid, tanh
from .linear import lecun_normal, linear
from .simd_ops import simd_add, simd_mul


class LSTMCell(nn.Module):
    """One step: (h, c), x -> (h', c'), h'. Weights ``w_ih`` (4H, D),
    ``w_hh`` (4H, H) and ``bias`` (4H,), the gates in the order i, f, g,
    o. Built on ``device``, the card unless the caller asks for the
    CPU."""

    def __init__(self, input_size: int, hidden_size: int,
                 mx_specs: Optional[MxSpecs] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        H = hidden_size
        self.hidden_size = H
        self.mx_specs = mx_specs
        self.w_ih = nn.Parameter(lecun_normal((4 * H, input_size), 4 * H,
                                              dev, generator))
        self.w_hh = nn.Parameter(lecun_normal((4 * H, H), 4 * H, dev,
                                              generator))
        self.bias = nn.Parameter(torch.zeros(4 * H, device=dev))

    def forward(self, carry, x):
        h, c = carry
        s = self.mx_specs
        gates = simd_add(linear(x, self.w_ih, None, s),
                         linear(h, self.w_hh, self.bias, s), s)
        i, f, g, o = torch.split(gates, self.hidden_size, dim=-1)
        i, f, o = sigmoid(i, s), sigmoid(f, s), sigmoid(o, s)
        g = tanh(g, s)
        c_new = simd_add(simd_mul(f, c, s), simd_mul(i, g, s), s)
        h_new = simd_mul(o, tanh(c_new, s), s)
        return (h_new, c_new), h_new


class LSTM(nn.Module):
    """Single-layer MX LSTM over (T, B, D) sequences; returns (ys (T, B, H),
    (h, c)). The cell is flax's ``LSTMCell_0``."""

    flax_names = {"LSTMCell_0": "cell"}

    def __init__(self, input_size: int, hidden_size: int,
                 mx_specs: Optional[MxSpecs] = None, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.cell = LSTMCell(input_size, hidden_size, mx_specs, device,
                             generator)

    def forward(self, xs, init_carry: Optional[Tuple] = None):
        if init_carry is None:
            z = xs.new_zeros(xs.shape[1], self.hidden_size)
            init_carry = (z, z)
        carry, ys = init_carry, []
        for x in xs:
            carry, y = self.cell(carry, x)
            ys.append(y)
        return torch.stack(ys), carry
