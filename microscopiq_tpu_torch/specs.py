"""MX quantization specs.

Counterpart of ``microscopiq_tpu/specs.py``: ``MxSpecs`` with dict-style
access, ``finalize_mx_specs``, the backward-pass specs of the training path
(``get_backwards_mx_specs``), the ``MX_ASSERT`` guards (``mx_assert_finite``,
``mx_assert_test``), and the CLI's ``add_mx_args`` and ``get_mx_specs``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import traceback
from typing import Optional

import torch

# MX_ASSERT=True turns on the NaN guards of the outlier quantizer and the
# spec check of the MX layers
_ASSERT_MODE = os.environ.get("MX_ASSERT", "False")

_HELP = {
    "scale_bits": "Bits (sign + magnitude) for the shared exponent/scale",
    "w_elem_format": "Weight MX elem format, one of {fp8_e5m2, fp8_e4m3, "
                     "fp6_e3m2, fp6_e2m3, fp4_e2m1, int8, int4, int2}",
    "a_elem_format": "Activation MX elem format. See w_elem_format",
    "w_elem_format_bp": "Backpass weight MX elem format",
    "a_elem_format_bp_ex": "Backpass act MX elem format (error x)",
    "a_elem_format_bp_os": "Backpass act MX elem format (output side)",
    "w_outlier_elem_format": "Outlier elem format for outlier-aware weight "
                             "quantization (None disables the outlier path)",
    "outlier_std_dev": "k in the mean±k·std outlier rule",
    "mx_flush_fp32_subnorms": "Flush blocks with subnormal shared scale to 0",
    "shared_exp_method": "Shared exponent method: max or none",
    "block_size": "MX shared-exponent block size",
    "bfloat": "BfloatX container format (8 exp + sign + mantissa)",
    "fp": "fpX container format (5 exp + sign + mantissa)",
    "bfloat_subnorms": "Bfloat/FP supports subnorms",
    "quantize_backprop": "Enable mx/bfloat quantization on backward pass",
    "round": "Global rounding mode: nearest, floor, even",
    "round_m": "Optimizer m/v rounding mode",
    "round_weight": "Weight bfloat rounding mode",
    "round_output": "Activation bfloat rounding mode",
    "round_grad_weight": "Weight-gradient rounding mode",
    "round_grad_input": "Input-gradient rounding mode",
    "round_mx_output": "Forward-pass MX rounding mode",
    "round_mx_input_grad_input": "",
    "round_mx_weight_grad_input": "",
    "round_mx_grad_output_grad_input": "",
    "round_mx_input_grad_weight": "",
    "round_mx_grad_output_grad_weight": "",
    "softmax_exp2": "Softmax uses 2^x instead of e^x",
    "vec_use_exp2": "Use 2^x to compute e^x in vector ops",
    "vec_use_recip": "Use Newton-Raphson reciprocal for division",
    "use_pallas": "Use fused kernels for quantized ops (the port's CUDA "
                  "kernels); plain PyTorch semantics otherwise",
}


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

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def replace(self, **kwargs) -> "MxSpecs":
        return dataclasses.replace(self, **kwargs)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_FIELDS = {f.name for f in dataclasses.fields(MxSpecs)}
_DEFAULTS = MxSpecs()


def get_default_mx_specs() -> MxSpecs:
    """Spec with quantization disabled."""
    return MxSpecs()


def apply_mx_specs(mx_specs, default_mx_specs: Optional[MxSpecs] = None
                   ) -> MxSpecs:
    """Overlay user-specified (non-None) entries onto the defaults."""
    base = default_mx_specs or get_default_mx_specs()
    if not mx_specs:
        return base
    updates = {}
    for k, v in dict(mx_specs).items():
        if v is not None:
            if k not in _FIELDS:
                raise KeyError(f"Unknown key '{k}' passed to mx specs")
            updates[k] = v
    return base.replace(**updates)


def get_backwards_mx_specs(specs: Optional[MxSpecs]) -> Optional[MxSpecs]:
    """The spec of the backward pass: ``specs`` itself under
    ``quantize_backprop``, else ``specs`` with every format, the block size
    and the element containers cleared (a spec that quantizes nothing)."""
    if specs is None:
        return None
    if not specs.quantize_backprop:
        return specs.replace(
            w_elem_format=None, a_elem_format=None, w_elem_format_bp=None,
            a_elem_format_bp_os=None, a_elem_format_bp_ex=None,
            block_size=0, bfloat=0, fp=0)
    return specs


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
    return apply_mx_specs(specs, get_default_mx_specs())


def add_mx_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Register every spec knob as a CLI flag: ``--<name>`` (a true default
    as ``--no_<name>``), plus ``--skip_early_exit``."""
    group = parser.add_argument_group("mx", "MX specs")
    for f in dataclasses.fields(MxSpecs):
        k, v = f.name, getattr(_DEFAULTS, f.name)
        help_str = _HELP.get(k, "") or "No help string"
        if "elem_format" in k:
            group.add_argument("--" + k, type=str, default=v, help=help_str)
        elif isinstance(v, bool) and v is False:
            group.add_argument("--" + k, action="store_true", help=help_str)
        elif isinstance(v, bool) and v is True:
            group.add_argument("--no_" + k, action="store_true",
                               help=help_str)
        elif isinstance(v, float):
            group.add_argument("--" + k, type=float, default=None,
                               help=help_str)
        elif isinstance(v, int):
            group.add_argument("--" + k, type=int, default=None,
                               help=help_str)
        else:
            group.add_argument("--" + k, type=str, default=None,
                               help=help_str)
    group.add_argument("--skip_early_exit", action="store_true",
                       default=False,
                       help="Don't early exit if no quantization is specified")
    return parser


def get_mx_specs(parsed_args: argparse.Namespace) -> Optional[MxSpecs]:
    """A finalized spec from the flags of :func:`add_mx_args`."""
    parsed = {}
    for f in dataclasses.fields(MxSpecs):
        k, v = f.name, getattr(_DEFAULTS, f.name)
        if isinstance(v, bool) and v is True:
            if hasattr(parsed_args, "no_" + k):
                parsed[k] = not getattr(parsed_args, "no_" + k)
        elif hasattr(parsed_args, k):
            parsed[k] = getattr(parsed_args, k)
    early_exit = not getattr(parsed_args, "skip_early_exit", False)
    return finalize_mx_specs(parsed, early_exit=early_exit)


def mx_assert_test(mx_specs) -> None:
    """Under ``MX_ASSERT=True``, raise ValueError when an MX op was handed no
    spec, naming the op and its caller; a no-op otherwise."""
    if _ASSERT_MODE == "True" and mx_specs is None:
        stack = traceback.extract_stack()
        f1, f2 = stack[-2], stack[-3]
        raise ValueError(
            "MX assert test failed!\n"
            f"mx_specs is None in function {f1.name}\n"
            f"Called from {f2.filename}, line {f2.lineno}\n  {f2.line}")
