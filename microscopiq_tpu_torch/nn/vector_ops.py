"""Low-precision vector-unit op models.

Counterpart of ``microscopiq_tpu/nn/vector_ops.py``: exp, 2^x, reciprocal,
division, sqrt and tanh with every intermediate element-wise quantized,
honouring ``vec_use_exp2`` (e^x as 2^(x log2 e)) and ``vec_use_recip`` (one
Newton-Raphson step from a quantized seed).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..specs import MxSpecs
from .functional import ste_elemwise

_LOG2_E = math.log2(math.e)


def _q(x, specs, round=None):
    return ste_elemwise(x, specs, round)


def vec_exp2(x, mx_specs: Optional[MxSpecs]):
    return _q(torch.exp2(x), mx_specs)


def vec_exp(x, mx_specs: Optional[MxSpecs]):
    if mx_specs is not None and mx_specs["vec_use_exp2"]:
        return vec_exp2(_q(x * _LOG2_E, mx_specs), mx_specs)
    return _q(torch.exp(x), mx_specs)


def vec_recip(x, mx_specs: Optional[MxSpecs]):
    if mx_specs is not None and mx_specs["vec_use_recip"]:
        seed = _q(1.0 / x, mx_specs)
        return _q(seed * (2.0 - _q(x * seed, mx_specs)), mx_specs)
    return _q(1.0 / x, mx_specs)


def vec_div(a, b, mx_specs: Optional[MxSpecs]):
    if mx_specs is not None and mx_specs["vec_use_recip"]:
        return _q(a * vec_recip(b, mx_specs), mx_specs)
    return _q(a / b, mx_specs)


def vec_sqrt(x, mx_specs: Optional[MxSpecs]):
    return _q(torch.sqrt(x), mx_specs)


def vec_tanh(x, mx_specs: Optional[MxSpecs]):
    return _q(torch.tanh(x), mx_specs)
