"""Scalar element formats for microscaling (MX) quantization.

Own copy of ``microscopiq_tpu/formats.py``: the same format table with the
same ``(ebits, mbits, emax, max_norm, min_norm)`` parameters. ``mbits``
includes the sign bit and the implicit leading one.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Union

FP32_EXPONENT_BIAS = 127
FP32_MIN_NORMAL = 2.0 ** (-FP32_EXPONENT_BIAS + 1)


class RoundingMode(enum.IntEnum):
    nearest = 0
    floor = 1
    even = 2

    @staticmethod
    def string_enums():
        return [s.name for s in list(RoundingMode)]


class ElemFormat(enum.Enum):
    int8 = 1
    int4 = 2
    int2 = 3
    fp8_e5m2 = 4
    fp8_e4m3 = 5
    fp6_e3m2 = 6
    fp6_e2m3 = 7
    fp4 = 8
    fp4_e2m1 = 8
    float16 = 9
    fp16 = 9
    bfloat16 = 10
    bf16 = 10

    @staticmethod
    def from_str(s: str) -> "ElemFormat":
        if s is None:
            raise ValueError("elem_format string is None")
        s = s.lower()
        if hasattr(ElemFormat, s):
            return getattr(ElemFormat, s)
        raise ValueError(f"Undefined elem format: {s}")


class FormatParams(NamedTuple):
    """ebits, mbits (incl. sign and implicit one), emax, max_norm, min_norm."""

    ebits: int
    mbits: int
    emax: int
    max_norm: float
    min_norm: float


def _get_min_norm(ebits: int) -> float:
    """Minimum normal magnitude for a float format (0 for int formats)."""
    emin = 2 - (2 ** (ebits - 1))
    return 0 if ebits == 0 else 2 ** emin


def _get_max_norm(ebits: int, mbits: int) -> float:
    """Max normal for float formats that reserve the top exponent for NaN/Inf."""
    if ebits < 5:
        raise ValueError("invalid for floats that don't define NaN")
    emax = 2 ** (ebits - 1) - 1
    return 2 ** emax * float(2 ** (mbits - 1) - 1) / 2 ** (mbits - 2)


# (ebits, mbits, emax) per format: sub-byte fp formats without NaN/Inf use
# emax = 2**(ebits-1); formats with NaN/Inf reserve the top exponent.
_FORMAT_TABLE = {
    ElemFormat.int8: (0, 8, 0),
    ElemFormat.int4: (0, 4, 0),
    ElemFormat.int2: (0, 2, 0),
    ElemFormat.fp8_e5m2: (5, 4, 2 ** 4 - 1),
    ElemFormat.fp8_e4m3: (4, 5, 2 ** 3),
    ElemFormat.fp6_e3m2: (3, 4, 2 ** 2),
    ElemFormat.fp6_e2m3: (2, 5, 2 ** 1),
    ElemFormat.fp4: (2, 3, 2 ** 1),
    ElemFormat.float16: (5, 12, 2 ** 4 - 1),
    ElemFormat.bfloat16: (8, 9, 2 ** 7 - 1),
}


def get_format_params(fmt: Union[str, ElemFormat]) -> FormatParams:
    """Return (ebits, mbits, emax, max_norm, min_norm) for a format."""
    if isinstance(fmt, str):
        fmt = ElemFormat.from_str(fmt)
    if fmt not in _FORMAT_TABLE:
        raise ValueError(f"Unknown element format {fmt}")
    ebits, mbits, emax = _FORMAT_TABLE[fmt]
    if fmt != ElemFormat.fp8_e4m3:
        max_norm = 2 ** emax * float(2 ** (mbits - 1) - 1) / 2 ** (mbits - 2)
    else:
        # e4m3 gives up the top mantissa encoding for NaN
        max_norm = 2 ** emax * 1.75
    return FormatParams(ebits, mbits, emax, max_norm, _get_min_norm(ebits))
