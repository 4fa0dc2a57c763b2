"""Element-wise (scalar-format) fake quantization in PyTorch.

Counterpart of ``microscopiq_tpu/ops/elemwise.py`` and bit-exact with it:
``floor(log2|x|)`` comes from the float32 exponent field
(``tensor.view(torch.int32)``), and powers of two are assembled into the
exponent field, so no transcendental ``log2``/``exp2`` rounding can leak in.
Also the spec-driven container quantizers of the MX layers
(``quantize_bfloat``, ``quantize_fp``, ``quantize_elemwise_op``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..formats import _get_max_norm, _get_min_norm, get_format_params

_F32_INF = float("inf")


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: keeps the sign of zero and propagates NaN, where
    ``torch.sign`` maps both to +0."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2(x))`` for x >= 0 from the float32 bit pattern.

    Subnormals included; +Inf for +-Inf, NaN for NaN, and -150 for 0 (a
    sentinel: callers offset zeros first), as in the reference.
    """
    xf = x.to(torch.float32)
    bits = xf.view(torch.int32)
    biased = (bits >> 23) & 0xFF
    mant = bits & 0x7FFFFF
    exp_normal = biased - 127
    # subnormal: x = mant * 2^-149, floor(log2 x) = bitlength(mant) - 150;
    # bitlength(mant) - 1 is the exponent field of float(mant) (exact, < 2^23)
    mant_exp = ((mant.to(torch.float32).view(torch.int32) >> 23) & 0xFF) - 127
    exp_subnormal = torch.where(mant == 0, torch.full_like(mant, -150),
                                mant_exp + 1 - 150)
    out = torch.where(biased > 0, exp_normal, exp_subnormal).to(torch.float32)
    out = torch.where(torch.isinf(xf), torch.full_like(out, _F32_INF), out)
    return torch.where(torch.isnan(xf), torch.full_like(out, float("nan")),
                       out)


def exp2_exact(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2.0**e`` for integer-valued float e in [-126, 127].

    Out-of-range finite exponents clamp to [-126, 127]; +Inf -> Inf,
    -Inf -> 0, NaN -> NaN.
    """
    ef = e.to(torch.float32)
    ei = torch.nan_to_num(ef.clamp(-126.0, 127.0), nan=0.0).to(torch.int32)
    p = ((ei + 127) << 23).view(torch.float32)
    p = torch.where(ef == _F32_INF, torch.full_like(p, _F32_INF), p)
    p = torch.where(ef == -_F32_INF, torch.zeros_like(p), p)
    return torch.where(torch.isnan(ef), torch.full_like(p, float("nan")), p)


def mul_pow2(x: torch.Tensor, e) -> torch.Tensor:
    """Exact ``x * 2**e`` for integer-valued e in [-254, 254].

    Two half-exponent factors, each a normal float32, so that no subnormal
    reciprocal is ever formed.
    """
    ef = (e.to(torch.float32) if isinstance(e, torch.Tensor)
          else torch.tensor(float(e), dtype=torch.float32, device=x.device))
    e1 = torch.trunc(ef / 2)
    e2 = ef - e1
    return x * exp2_exact(e1) * exp2_exact(e2)


def _safe_lshift(x, bits: int, exp):
    if exp is None:
        return x * (2 ** bits)
    return mul_pow2(x, -exp) * (2 ** bits)


def _safe_rshift(x, bits: int, exp):
    if exp is None:
        return x / (2 ** bits)
    return mul_pow2(x / (2 ** bits), exp)


def round_mantissa(A: torch.Tensor, bits: int, round: str = "nearest",
                   clamp: bool = False,
                   generator: Optional[torch.Generator] = None,
                   rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round the scaled mantissa. Modes: floor, nearest, even, dither.

    ``nearest`` is ``floor(|A| + 0.5)`` (ties away from zero), not
    ``torch.round``. ``dither`` is ``sign(A) * floor(|A| + u)`` with u
    uniform in [0, 1): the draws ``rand`` (A's shape) where given, else
    drawn from ``generator``; one of the two is required.
    """
    if round == "dither":
        if rand is None:
            if generator is None:
                raise ValueError("round='dither' requires a generator or "
                                 "the uniform draws")
            rand = torch.rand(A.shape, generator=generator, dtype=A.dtype,
                              device=A.device)
        elif rand.shape != A.shape:
            raise ValueError(f"dither draws of shape {tuple(rand.shape)} "
                             f"for a tensor of shape {tuple(A.shape)}")
        out = _sign(A) * torch.floor(torch.abs(A) + rand.to(A.dtype))
    elif round == "floor":
        out = _sign(A) * torch.floor(torch.abs(A))
    elif round == "nearest":
        out = _sign(A) * torch.floor(torch.abs(A) + 0.5)
    elif round == "even":
        absA = torch.abs(A)
        maskA = ((absA - 0.5) % 2 == 0).to(A.dtype)
        out = _sign(A) * (torch.floor(absA + 0.5) - maskA)
    else:
        raise ValueError(f"Unrecognized round method {round}")
    if clamp:
        max_mantissa = 2 ** (bits - 1) - 1
        out = torch.clamp(out, -max_mantissa, max_mantissa)
    return out


def quantize_elemwise_core(A: torch.Tensor, bits: int, exp_bits: int,
                           max_norm: float, round: str = "nearest",
                           saturate_normals: bool = False,
                           allow_denorm: bool = True,
                           generator: Optional[torch.Generator] = None,
                           rand: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Quantize each element to a (sign, exp_bits, bits-2 mantissa) format.

    Runs in float32 and casts back to the input dtype. ``generator`` or
    ``rand`` feed ``round="dither"`` (see :func:`round_mantissa`).
    """
    orig_dtype = A.dtype
    A = A.to(torch.float32)
    if not allow_denorm and exp_bits > 0:
        # mask-multiply (not where) so NaN inputs stay NaN
        out = (torch.abs(A) >= _get_min_norm(exp_bits)).to(A.dtype) * A
    else:
        out = A

    if exp_bits != 0:
        private_exp = floor_log2(torch.abs(A) + (A == 0).to(A.dtype))
        min_exp = -(2 ** (exp_bits - 1)) + 2
        private_exp = torch.clamp(private_exp, min=float(min_exp))
    else:
        private_exp = None

    out = _safe_lshift(out, bits - 2, private_exp)
    out = round_mantissa(out, bits, round, clamp=False, generator=generator,
                         rand=rand)
    out = _safe_rshift(out, bits - 2, private_exp)

    if saturate_normals or exp_bits == 0:
        out = torch.clamp(out, -max_norm, max_norm)
    else:
        out = torch.where(torch.abs(out) > max_norm,
                          _sign(out) * _F32_INF, out)
    out = torch.where(torch.isinf(A), A, out)
    out = torch.where(torch.isnan(A), torch.full_like(out, float("nan")), out)
    return out.to(orig_dtype)


def quantize_elemwise(A: torch.Tensor, elem_format, round: str = "nearest",
                      saturate_normals: bool = False,
                      allow_denorm: bool = True) -> torch.Tensor:
    """Quantize to a named element format (None = passthrough)."""
    if elem_format is None:
        return A
    ebits, mbits, _, max_norm, _ = get_format_params(elem_format)
    return quantize_elemwise_core(
        A, mbits, ebits, max_norm, round=round,
        saturate_normals=saturate_normals, allow_denorm=allow_denorm)


def quantize_bfloat(A: torch.Tensor, bfloat: int, round: str = "nearest",
                    allow_denorm: bool = True) -> torch.Tensor:
    """Quantize to bfloatX (1 sign + 8 exp + (bfloat-9) mantissa bits)."""
    if bfloat == 0 or bfloat == 32:
        return A
    max_norm = _get_max_norm(8, bfloat - 7)
    return quantize_elemwise_core(
        A, bits=bfloat - 7, exp_bits=8, max_norm=max_norm, round=round,
        allow_denorm=allow_denorm)


def quantize_fp(A: torch.Tensor, exp_bits: Optional[int] = None,
                mantissa_bits: Optional[int] = None, round: str = "nearest",
                allow_denorm: bool = True) -> torch.Tensor:
    """Quantize to an IEEE-like fpX (NaN/Inf as in fp16/fp32)."""
    if exp_bits is None or mantissa_bits is None:
        return A
    max_norm = _get_max_norm(exp_bits, mantissa_bits + 2)
    return quantize_elemwise_core(
        A, bits=mantissa_bits + 2, exp_bits=exp_bits, max_norm=max_norm,
        round=round, allow_denorm=allow_denorm)


def quantize_elemwise_op(A: torch.Tensor, mx_specs,
                         round: Optional[str] = None) -> torch.Tensor:
    """Spec-driven element-wise quantization by the ``bfloat`` or ``fp``
    knob (mutually exclusive; bfloat > 9 and fp > 6 when set). ``round``
    defaults to the spec's ``round``; ``mx_specs=None`` passes A through."""
    if mx_specs is None:
        return A
    if round is None:
        round = mx_specs["round"]
    bfloat, fp = mx_specs["bfloat"], mx_specs["fp"]
    if bfloat > 0 and fp > 0:
        raise ValueError("Cannot set both [bfloat] and [fp] in mx_specs.")
    if bfloat > 9:
        return quantize_bfloat(A, bfloat=bfloat, round=round,
                               allow_denorm=mx_specs["bfloat_subnorms"])
    if 0 < bfloat <= 9:
        raise ValueError("Cannot set [bfloat] <= 9 in mx_specs.")
    if fp > 6:
        return quantize_fp(A, exp_bits=5, mantissa_bits=fp - 6, round=round,
                           allow_denorm=mx_specs["bfloat_subnorms"])
    if 0 < fp <= 6:
        raise ValueError("Cannot set [fp] <= 6 in mx_specs.")
    return A
