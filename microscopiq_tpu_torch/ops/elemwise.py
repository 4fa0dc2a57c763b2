"""Element-wise (scalar-format) fake quantization in PyTorch.

Counterpart of ``microscopiq_tpu/ops/elemwise.py`` and bit-exact with it:
``floor(log2|x|)`` comes from the float32 exponent field
(``tensor.view(torch.int32)``), and powers of two are assembled into the
exponent field, so no transcendental ``log2``/``exp2`` rounding can leak in.
"""

from __future__ import annotations

import torch

from ..formats import _get_min_norm, get_format_params

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
                   clamp: bool = False) -> torch.Tensor:
    """Round the scaled mantissa. Modes: floor, nearest, even.

    ``nearest`` is ``floor(|A| + 0.5)`` (ties away from zero), not
    ``torch.round``. The reference's ``dither`` mode belongs to the
    training path (ROADMAP queue 1 item 9).
    """
    if round == "floor":
        out = _sign(A) * torch.floor(torch.abs(A))
    elif round == "nearest":
        out = _sign(A) * torch.floor(torch.abs(A) + 0.5)
    elif round == "even":
        absA = torch.abs(A)
        maskA = ((absA - 0.5) % 2 == 0).to(A.dtype)
        out = _sign(A) * (torch.floor(absA + 0.5) - maskA)
    elif round == "dither":
        raise NotImplementedError(
            "round='dither' is not ported yet (ROADMAP queue 1 item 9)")
    else:
        raise ValueError(f"Unrecognized round method {round}")
    if clamp:
        max_mantissa = 2 ** (bits - 1) - 1
        out = torch.clamp(out, -max_mantissa, max_mantissa)
    return out


def quantize_elemwise_core(A: torch.Tensor, bits: int, exp_bits: int,
                           max_norm: float, round: str = "nearest",
                           saturate_normals: bool = False,
                           allow_denorm: bool = True) -> torch.Tensor:
    """Quantize each element to a (sign, exp_bits, bits-2 mantissa) format.

    Runs in float32 and casts back to the input dtype.
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
    out = round_mantissa(out, bits, round, clamp=False)
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
