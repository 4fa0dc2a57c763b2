"""MX-quantized softmax with an optional base-2 exponent.

Counterpart of ``microscopiq_tpu/nn/softmax.py``: the input, the shifted
values, the exponentials (2^x under ``softmax_exp2``, a model of hardware
with only a base-2 exponential unit), the denominator and the output are
element-wise quantized.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..specs import MxSpecs
from .functional import ste_elemwise
from .vector_ops import vec_exp, vec_exp2, vec_recip


def softmax(x, axis: int = -1, mx_specs: Optional[MxSpecs] = None):
    if mx_specs is None:
        return torch.softmax(x, dim=axis)
    rnd = mx_specs["round_output"]
    x = ste_elemwise(x, mx_specs, rnd)
    m = torch.amax(x, dim=axis, keepdim=True)
    shifted = ste_elemwise(x - m, mx_specs, rnd)
    e = (vec_exp2(shifted, mx_specs) if mx_specs["softmax_exp2"]
         else vec_exp(shifted, mx_specs))
    denom = ste_elemwise(torch.sum(e, dim=axis, keepdim=True), mx_specs, rnd)
    return ste_elemwise(e * vec_recip(denom, mx_specs), mx_specs, rnd)


class Softmax(nn.Module):
    def __init__(self, axis: int = -1, mx_specs: Optional[MxSpecs] = None):
        super().__init__()
        self.axis = axis
        self.mx_specs = mx_specs

    def forward(self, x):
        return softmax(x, self.axis, self.mx_specs)
