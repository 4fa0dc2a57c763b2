"""MX quantization specs: the part that the packers and the serving path read.

Counterpart of ``microscopiq_tpu/specs.py`` (``MxSpecs``,
``finalize_mx_specs``, ``mx_assert_finite``). The CLI registration and the
other assert helpers of the reference belong to the calibration/training
path (ROADMAP queue 1 items 6 and 9) and are not carried here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

# MX_ASSERT=True turns on the NaN guards of the outlier quantizer
_ASSERT_MODE = os.environ.get("MX_ASSERT", "False")


def mx_assert_finite(x: torch.Tensor, name: str) -> torch.Tensor:
    """NaN guard at the reference's check points (``utils/quant.py:103-128``),
    which catch the deliberate NaN-poisoning of overflowed shared scales.
    A no-op unless ``MX_ASSERT=True``; raises FloatingPointError otherwise."""
    if _ASSERT_MODE == "True" and bool(torch.isnan(x).any()):
        raise FloatingPointError(f"MX assert: {name} contains NaN values")
    return x


@dataclasses.dataclass(frozen=True)
class MxSpecs:
    """Immutable MX spec; defaults mirror the reference's."""

    scale_bits: int = 0

    w_elem_format: Optional[str] = None
    a_elem_format: Optional[str] = None
    w_elem_format_bp: Optional[str] = None
    a_elem_format_bp_ex: Optional[str] = None
    a_elem_format_bp_os: Optional[str] = None
    w_outlier_elem_format: Optional[str] = None
    outlier_std_dev: float = 2.0
    mx_flush_fp32_subnorms: bool = False

    shared_exp_method: str = "max"
    block_size: int = 0

    bfloat: int = 0
    fp: int = 0
    bfloat_subnorms: bool = True

    quantize_backprop: bool = True

    round: str = "nearest"
    round_m: str = "nearest"
    round_weight: str = "nearest"
    round_output: str = "nearest"
    round_grad_weight: str = "nearest"
    round_grad_input: str = "nearest"
    round_mx_output: str = "nearest"
    round_mx_input_grad_input: str = "nearest"
    round_mx_weight_grad_input: str = "nearest"
    round_mx_grad_output_grad_input: str = "nearest"
    round_mx_input_grad_weight: str = "nearest"
    round_mx_grad_output_grad_weight: str = "nearest"

    softmax_exp2: bool = False
    vec_use_exp2: bool = False
    vec_use_recip: bool = False

    use_pallas: bool = False
    a_axes: Optional[int] = None

    def __getitem__(self, key: str):
        return getattr(self, key)

    def replace(self, **kwargs) -> "MxSpecs":
        return dataclasses.replace(self, **kwargs)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_FIELDS = {f.name for f in dataclasses.fields(MxSpecs)}


def apply_mx_specs(mx_specs, default_mx_specs: Optional[MxSpecs] = None
                   ) -> MxSpecs:
    """Overlay user-specified (non-None) entries onto the defaults."""
    base = default_mx_specs or MxSpecs()
    if not mx_specs:
        return base
    updates = {}
    for k, v in dict(mx_specs).items():
        if v is not None:
            if k not in _FIELDS:
                raise KeyError(f"Unknown key '{k}' passed to mx specs")
            updates[k] = v
    return base.replace(**updates)


def finalize_mx_specs(specs, early_exit: bool = True) -> Optional[MxSpecs]:
    """Resolve dependent specs; None when nothing is quantized."""
    specs = specs.as_dict() if isinstance(specs, MxSpecs) else dict(specs)
    if (not specs.get("w_elem_format", 0)
            and not specs.get("a_elem_format", 0)
            and not specs.get("w_elem_format_bp", 0)
            and not specs.get("a_elem_format_bp_os", 0)
            and not specs.get("a_elem_format_bp_ex", 0)
            and not specs.get("bfloat", 0)
            and not specs.get("fp", 0)
            and early_exit):
        return None

    def assign_if_none(f1, f2):
        if specs.get(f1) is None and f2 in specs:
            specs[f1] = specs[f2]

    assign_if_none("w_elem_format_bp", "w_elem_format")
    assign_if_none("a_elem_format_bp_os", "a_elem_format")
    assign_if_none("a_elem_format_bp_ex", "a_elem_format")
    for r in ("round_m", "round_output", "round_grad_weight",
              "round_grad_input", "round_weight", "round_mx_output"):
        assign_if_none(r, "round")
    for r in ("round_mx_input_grad_input", "round_mx_weight_grad_input",
              "round_mx_grad_output_grad_input", "round_mx_input_grad_weight",
              "round_mx_grad_output_grad_weight"):
        assign_if_none(r, "round_grad_input")
    return apply_mx_specs(specs, MxSpecs())
