"""Packed MX weight storage: codes plus per-block shared exponents.

Counterpart of ``microscopiq_tpu/ops/packing.py``, bit-exact with it:

* ``PackedMX``, the native containers, ``pack_mx`` (both ``exact_scale``
  modes) in the native, ``emi8``, sub-byte (``sb4``/``sb2``) and raw fp-bit
  (``pf4``/``pf6``) transports, the pre-blocked serving layout and
  ``dequantize_mx``;
* the MicroScopiQ outlier formats: the side-band ``PackedMXOutlier``
  (``pack_mx_outlier``, ``dequantize_mx_outlier``), its merge into one
  ``emi8m`` byte stream (``merge_outlier_emi8``, ``pack_emi8m_absolute``,
  ``emi8m_rebase``) and the compact N-blocked int2+fp4 transport
  ``PackedOutlierNB`` (``pack_outlier_nb``, ``dequantize_outlier_nb``).

The JAX package runs the emi8m encoders on the host in numpy float64; here
they run in torch float64 on the tensor's device, in row chunks that bound
the temporaries of a large matrix (the lm_head). Chunks follow rows of the
non-blocked axis, so the bytes are the same as for the whole tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..formats import ElemFormat, get_format_params
from .elemwise import exp2_exact, floor_log2, mul_pow2, quantize_elemwise_core
from .mx import shared_exponents

_CONTAINERS = {
    ElemFormat.int8: torch.int8,
    ElemFormat.int4: torch.int8,
    ElemFormat.int2: torch.int8,
    ElemFormat.fp8_e4m3: torch.float8_e4m3fn,
    ElemFormat.fp8_e5m2: torch.float8_e5m2,
    ElemFormat.fp6_e3m2: torch.float8_e4m3fn,
    ElemFormat.fp6_e2m3: torch.float8_e4m3fn,
    ElemFormat.fp4: torch.float8_e4m3fn,
    ElemFormat.float16: torch.float16,
    ElemFormat.bfloat16: torch.bfloat16,
}

# elements per row chunk of the float64 emi8m encoders and the outlier packers
_CHUNK_ELEMS = 1 << 24


def _fmt(fmt) -> ElemFormat:
    return ElemFormat.from_str(fmt) if isinstance(fmt, str) else fmt


def container_dtype(fmt) -> torch.dtype:
    """Smallest native dtype that exactly holds every value of ``fmt``."""
    return _CONTAINERS[_fmt(fmt)]


def _is_int_format(fmt) -> bool:
    return _fmt(fmt) in (ElemFormat.int8, ElemFormat.int4, ElemFormat.int2)


# ---------------------------------------------------------------------------
# emi8 transport: fp4/fp6 code -> one int8 byte = (m̂ << (8-mw)) | e'
# ---------------------------------------------------------------------------
def emi8_params(fmt) -> Tuple[int, int, int]:
    """(mw, mm, emin) for the emi8 byte layout of a sub-byte fp format.

    Every fp4/fp6 value is exactly ``m̂ · 2^(e' + emin - mm)``: a signed
    integer mantissa m̂ in the high ``mw`` bits and a biased exponent e' in
    the low ``8 - mw`` bits. The ``2^(emin - mm)`` factor folds into the
    per-block scale (:func:`emi8_fold`).
    """
    fmt = _fmt(fmt)
    if fmt not in (ElemFormat.fp4, ElemFormat.fp6_e3m2, ElemFormat.fp6_e2m3):
        raise ValueError(f"emi8 transport only supports fp4/fp6, got {fmt}")
    ebits, mbits, emax, _, _ = get_format_params(fmt)
    emin = 2 - (2 ** (ebits - 1))
    return mbits, mbits - 2, emin


def _emi8_encode(q: torch.Tensor, fmt) -> torch.Tensor:
    """Exact fp values q (already fake-quantized to fmt) -> emi8 bytes."""
    mw, mm, emin = emi8_params(fmt)
    aq = torch.abs(q)
    e = torch.clamp(floor_log2(torch.clamp(aq, min=2.0 ** (emin - mm))),
                    min=float(emin)).to(torch.int32)
    # torch.round is round-half-even, as jnp.round
    mhat = torch.round(q * exp2_exact((mm - e).to(torch.float32))
                       ).to(torch.int32)
    eprime = e - emin
    return (((mhat & ((1 << mw) - 1)) << (8 - mw)) | eprime).to(torch.int8)


def _emi8_decode_f32(codes: torch.Tensor, fmt) -> torch.Tensor:
    """emi8 bytes -> q · 2^(mm - emin); the caller applies the fold."""
    mw, _, _ = emi8_params(fmt)
    c = codes.to(torch.int32)                 # int8 sign-extends m̂
    mhat = c >> (8 - mw)                      # arithmetic: signed m̂
    eprime = c & ((1 << (8 - mw)) - 1)
    return (mhat << eprime).to(torch.float32)


def emi8_fold(fmt) -> int:
    """Scale fold for emi8 codes: value = decoded · 2^(-fold)."""
    _, mm, emin = emi8_params(fmt)
    return mm - emin


def transport_rows_per_block(transport: str, block_size: int) -> int:
    """Packed storage rows spanned by one block along the blocked axis."""
    return {"sb4": block_size // 2, "sb2": block_size // 4,
            "pf4": block_size // 2, "pf6": 3 * block_size // 4}.get(
                transport, block_size)


# ---------------------------------------------------------------------------
# Packed container
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PackedMX:
    """MX-quantized tensor: codes + int8 per-block shared exponents.

    codes:     the source tensor's shape (padded to a block multiple along
               ``axis``), in the container dtype, or int8 emi8 bytes. In the
               serving layout a (K, N) axis=0 weight is (K/B, B, N).
    scale_exp: one int8 exponent per block; (K/B, N) for serving weights.
    axis:      the blocked axis; linear weights are (K, N) with axis=0.
    transport: "native" (container dtype), "emi8" (byte codes), "emi8m"
               (merged two-level outlier bytes), "sb4"/"sb2" (2 or 4 int
               codes a byte) or "pf4"/"pf6" (raw fp bits, 4 or 6 a code).
    transport_mw / transport_fold: the field split and scale fold of the
               emi8m stream; the kernels take both at run time.
    """

    codes: torch.Tensor
    scale_exp: torch.Tensor
    elem_format: str
    block_size: int
    scale_bits: int
    orig_dim: int
    axis: int = -1
    transport: str = "native"
    transport_mw: int = 0
    transport_fold: int = 0

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def bits_per_element(self) -> float:
        if self.transport in ("emi8", "emi8m"):
            elem_bits = 8
        elif self.transport in ("sb4", "sb2", "pf4", "pf6"):
            elem_bits = 8 * transport_rows_per_block(
                self.transport, self.block_size) / self.block_size
        else:
            elem_bits = 8 * torch.empty(
                (), dtype=container_dtype(self.elem_format)).element_size()
        return elem_bits + self.scale_bits / self.block_size

    def nbytes(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scale_exp.numel() * self.scale_exp.element_size())


def to_serving_layout(p: PackedMX) -> PackedMX:
    """Pre-block a (K, N) axis=0 PackedMX into codes (K/B, rows, N) with
    scale_exp (K/B, N): the operand form both CUDA kernels read."""
    if p.codes.ndim == 3:
        if p.scale_exp.ndim == 3:          # legacy (K/B, 1, N) scales
            nb, _, N = p.scale_exp.shape
            return dataclasses.replace(p, scale_exp=p.scale_exp.reshape(nb, N))
        return p
    if p.axis != 0 or p.codes.ndim != 2:
        raise ValueError("serving layout needs a 2-D axis=0 (K, N) weight")
    rows = transport_rows_per_block(p.transport, p.block_size)
    K, N = p.codes.shape
    return dataclasses.replace(p, codes=p.codes.reshape(K // rows, rows, N))


def from_serving_layout(p: PackedMX) -> PackedMX:
    """Inverse of :func:`to_serving_layout`."""
    if p.codes.ndim == 2:
        return p
    nb, B, N = p.codes.shape
    se = p.scale_exp
    if se.ndim == 3:
        se = se.reshape(nb, N)
    return dataclasses.replace(p, codes=p.codes.reshape(nb * B, N),
                               scale_exp=se)


# ---------------------------------------------------------------------------
# Pack / dequantize
# ---------------------------------------------------------------------------
def _block_last_axis(A: torch.Tensor, block_size: int
                     ) -> Tuple[torch.Tensor, int]:
    n = A.shape[-1]
    pad = (-n) % block_size
    if pad:
        A = torch.cat([A, A.new_zeros(A.shape[:-1] + (pad,))], dim=-1)
    nb = A.shape[-1] // block_size
    return A.reshape(A.shape[:-1] + (nb, block_size)), n


def _code_cast(vals_scaled: torch.Tensor, fmt) -> torch.Tensor:
    """Cast scaled fake-quantized values into the container dtype."""
    if _is_int_format(fmt):
        _, mbits, _, _, _ = get_format_params(fmt)
        return torch.round(vals_scaled * (2 ** (mbits - 2))).to(torch.int8)
    return vals_scaled.to(container_dtype(fmt))


def _code_decode(codes: torch.Tensor, fmt) -> torch.Tensor:
    """Container codes -> scaled float values."""
    if _is_int_format(fmt):
        _, mbits, _, _, _ = get_format_params(fmt)
        return codes.to(torch.float32) * (2.0 ** -(mbits - 2))
    return codes.to(torch.float32)


def pack_mx(A: torch.Tensor, scale_bits: int, elem_format, block_size: int,
            round: str = "nearest", exact_scale: bool = False,
            axis: int = -1, transport: str = "native") -> PackedMX:
    """Quantize A, blocking ``axis``, into packed storage.

    ``exact_scale=False`` (the default, and what ``bench.py`` packs with)
    divides by ``exp2_exact(se) + 1e-6`` as the reference's fake quantizer
    does, so that ``dequantize_mx(pack_mx(A)) == quantize_mx(A)``.
    ``exact_scale=True`` divides by the exact power of two.
    """
    fmt = _fmt(elem_format)
    fmt_name = elem_format if isinstance(elem_format, str) else fmt.name
    ebits, mbits, emax, max_norm, _ = get_format_params(fmt)

    axis_n = axis % A.ndim
    A_ = A if axis_n == A.ndim - 1 else A.movedim(axis_n, -1)
    blocked, orig_dim = _block_last_axis(A_.to(torch.float32), block_size)
    se = shared_exponents(blocked, "max", axes=[blocked.ndim - 1], ebits=0)
    se = se - emax
    scale_emax = 2 ** (scale_bits - 1) - 1
    se = torch.clamp(se, -scale_emax, scale_emax)
    if exact_scale:
        scaled = mul_pow2(blocked, -se)
    else:
        scaled = blocked / (exp2_exact(se) + 1e-6)
    q = quantize_elemwise_core(scaled, mbits, ebits, max_norm, round=round,
                               allow_denorm=True, saturate_normals=True)
    if transport == "emi8":
        codes = _emi8_encode(q, fmt).reshape(blocked.shape[:-2] + (-1,))
    elif transport in ("pf4", "pf6"):
        ok = (fmt == ElemFormat.fp4 if transport == "pf4"
              else fmt in (ElemFormat.fp6_e3m2, ElemFormat.fp6_e2m3))
        if not ok:
            raise ValueError(f"{transport} transport needs a matching fp "
                             f"format, got {fmt}")
        codes = _pf_pack(q, fmt, block_size, transport)
    elif transport in ("sb4", "sb2"):
        per, bits = subbyte_params(fmt)
        if per != {"sb4": 2, "sb2": 4}[transport]:
            raise ValueError(f"{transport} transport needs "
                             f"{'int4' if transport == 'sb4' else 'int2'}")
        codes = _code_cast(q, fmt).reshape(blocked.shape[:-2] + (-1,))
        codes = _subbyte_pack(codes, block_size, per, bits)
    elif transport == "native":
        codes = _code_cast(q, fmt).reshape(blocked.shape[:-2] + (-1,))
    else:
        raise ValueError(f"unknown transport {transport!r}")
    se = se[..., 0].to(torch.int8)
    if axis_n != A.ndim - 1:
        codes = codes.movedim(-1, axis_n).contiguous()
        se = se.movedim(-1, axis_n).contiguous()
    return PackedMX(codes=codes, scale_exp=se, elem_format=fmt_name,
                    block_size=block_size, scale_bits=scale_bits,
                    orig_dim=orig_dim, axis=axis_n, transport=transport)


def dequantize_mx(p: PackedMX, dtype=torch.float32) -> torch.Tensor:
    """Dense tensor from packed storage (bit-exact vs ``quantize_mx``)."""
    if p.axis == 0 and p.codes.ndim == 3 and p.scale_exp.ndim in (2, 3):
        p = from_serving_layout(p)
    codes, se = p.codes, p.scale_exp
    axis_n = p.axis % codes.ndim
    if axis_n != codes.ndim - 1:
        codes = codes.movedim(axis_n, -1)
        se = se.movedim(axis_n, -1)
    if p.transport in ("sb4", "sb2"):
        per, bits = subbyte_params(p.elem_format)
        codes = _subbyte_unpack(codes, p.block_size, per, bits)
    elif p.transport in ("pf4", "pf6"):
        codes = _pf_unpack(codes, p.elem_format, p.block_size, p.transport)
    nb = codes.shape[-1] // p.block_size
    if p.transport == "emi8":
        vals = _emi8_decode_f32(codes, p.elem_format)
        se = se.to(torch.int32) - emi8_fold(p.elem_format)
    elif p.transport == "emi8m":
        vals = emi8m_decode_f32(codes, p.transport_mw)
        se = se.to(torch.int32) - p.transport_fold
    elif p.transport in ("pf4", "pf6"):
        ebits, mbits, _, _, _ = get_format_params(p.elem_format)
        vals = pf_decode_int(codes, ebits, mbits - 2).to(torch.float32)
        se = se.to(torch.int32) - emi8_fold(p.elem_format)
    else:
        vals = _code_decode(codes, p.elem_format)
    vals = vals.reshape(vals.shape[:-1] + (nb, p.block_size))
    vals = mul_pow2(vals, se[..., None].to(torch.float32))
    vals = vals.reshape(vals.shape[:-2] + (-1,))[..., :p.orig_dim]
    if axis_n != codes.ndim - 1:
        vals = vals.movedim(-1, axis_n)
    return vals.to(dtype)


# ---------------------------------------------------------------------------
# Raw fp-bit codec and sub-byte packing
# ---------------------------------------------------------------------------
def _fp_bias(ebits: int, emax: int) -> int:
    # IEEE-style bias, whether or not the format reserves its top exponent:
    # emin = 1 - bias in every case
    del emax
    return 2 ** (ebits - 1) - 1


def encode_fp_bits(vals: torch.Tensor, fmt) -> torch.Tensor:
    """On-grid values (outputs of quantize_elemwise_core) -> the format's
    (sign | exponent | mantissa) field encoding, as uint8."""
    ebits, mbits, emax, _, min_norm = get_format_params(fmt)
    fbits = mbits - 2
    bias = _fp_bias(ebits, emax)
    emin = 2 - 2 ** (ebits - 1)
    v = vals.to(torch.float32)
    a = torch.abs(v)
    sign = (v < 0) | ((v == 0) & torch.signbit(v))
    e_real = torch.clamp(floor_log2(a + (a == 0).to(a.dtype)),
                         min=float(emin))
    is_sub = a < min_norm
    e_field = torch.where(is_sub, torch.zeros_like(e_real),
                          e_real + bias).to(torch.int32)
    frac = torch.where(is_sub, mul_pow2(a, -float(emin)),
                       mul_pow2(a, -e_real) - 1.0) * (2 ** fbits)
    m_field = torch.round(frac).to(torch.int32)     # half-even, as jnp.round
    code = ((sign.to(torch.int32) << (ebits + fbits)) | (e_field << fbits)
            | m_field)
    return code.to(torch.uint8)


def decode_fp_bits(codes: torch.Tensor, fmt) -> torch.Tensor:
    """Field encodings -> float32 grid values."""
    ebits, mbits, emax, _, _ = get_format_params(fmt)
    fbits = mbits - 2
    bias = _fp_bias(ebits, emax)
    emin = 2 - 2 ** (ebits - 1)
    c = codes.to(torch.int32)
    m = (c & (2 ** fbits - 1)).to(torch.float32)
    e = (c >> fbits) & (2 ** ebits - 1)
    s = (c >> (ebits + fbits)) & 1
    mag = torch.where(e > 0,
                      mul_pow2(1.0 + m * (2.0 ** -fbits),
                               (e - bias).to(torch.float32)),
                      mul_pow2(m * (2.0 ** -fbits), float(emin)))
    return torch.where(s == 1, -mag, mag)


# ---------------------------------------------------------------------------
# Standalone transport packers (last axis; int4/fp4 two a byte, low nibble
# the even index; int2 four a byte; fp6 four codes in three bytes)
# ---------------------------------------------------------------------------
def _interleave(parts) -> torch.Tensor:
    out = torch.stack(parts, dim=-1)
    return out.reshape(out.shape[:-2] + (-1,))


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] -> uint8, two a byte. Last axis even."""
    c = codes.to(torch.int16) & 0xF
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8, sign-extended from the nibble."""
    p = packed.to(torch.int16)
    return _interleave([(((p >> s) & 0xF) ^ 8) - 8 for s in (0, 4)]
                       ).to(torch.int8)


def pack_int2(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-2, 1] -> uint8, four a byte."""
    c = codes.to(torch.int16) & 0x3
    return (c[..., 0::4] | (c[..., 1::4] << 2) | (c[..., 2::4] << 4)
            | (c[..., 3::4] << 6)).to(torch.uint8)


def unpack_int2(packed: torch.Tensor) -> torch.Tensor:
    p = packed.to(torch.int16)
    return _interleave([(((p >> s) & 0x3) ^ 2) - 2 for s in (0, 2, 4, 6)]
                       ).to(torch.int8)


def pack_fp4(vals: torch.Tensor) -> torch.Tensor:
    """fp4_e2m1 grid values -> uint8, two a byte."""
    c = encode_fp_bits(vals, "fp4_e2m1").to(torch.int16) & 0xF
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)


def unpack_fp4(packed: torch.Tensor) -> torch.Tensor:
    return _interleave([decode_fp_bits(packed & 0xF, "fp4_e2m1"),
                        decode_fp_bits((packed >> 4) & 0xF, "fp4_e2m1")])


def pack_fp6(vals: torch.Tensor, fmt: str = "fp6_e3m2") -> torch.Tensor:
    """fp6 grid values, four codes -> three bytes:
    c0[5:0] | c1[1:0] << 6 ; c1[5:2] | c2[3:0] << 4 ; c2[5:4] | c3[5:0] << 2.
    """
    codes = encode_fp_bits(vals, fmt).to(torch.int32)
    c0, c1, c2, c3 = (codes[..., i::4] for i in range(4))
    return _interleave([(c0 | (c1 << 6)) & 0xFF,
                        ((c1 >> 2) | (c2 << 4)) & 0xFF,
                        (c2 >> 4) | (c3 << 2)]).to(torch.uint8)


def unpack_fp6(packed: torch.Tensor, fmt: str = "fp6_e3m2") -> torch.Tensor:
    p = packed.to(torch.int32)
    b0, b1, b2 = (p[..., i::3] for i in range(3))
    codes = _interleave([b0 & 0x3F, ((b0 >> 6) | (b1 << 2)) & 0x3F,
                         ((b1 >> 4) | (b2 << 4)) & 0x3F, (b2 >> 2) & 0x3F])
    return decode_fp_bits(codes, fmt)


def subbyte_params(fmt) -> Tuple[int, int]:
    """(codes_per_byte, bits) of the sb4/sb2 transports."""
    fmt = _fmt(fmt)
    if fmt == ElemFormat.int4:
        return 2, 4
    if fmt == ElemFormat.int2:
        return 4, 2
    raise ValueError(f"sub-byte transport only for int4/int2, got {fmt}")


def _subbyte_pack(codes: torch.Tensor, block_size: int, per: int,
                  bits: int) -> torch.Tensor:
    """Blockwise-interleaved sub-byte packing along the last axis: byte row
    r of block b holds the codes at offsets r, r + B/per, ...,
    r + (per-1)·B/per, field i at bits ``bits·i``. (..., K) -> (..., K/per)
    int8."""
    B = block_size
    if B % per:
        raise ValueError(f"block {B} is not a multiple of {per}")
    *lead, K = codes.shape
    nb = K // B
    c = codes.to(torch.int32).reshape(*lead, nb, per, B // per)
    mask = (1 << bits) - 1
    out = torch.zeros(c.shape[:-2] + (B // per,), dtype=torch.int32,
                      device=codes.device)
    for i in range(per):
        out = out | ((c[..., i, :] & mask) << (bits * i))
    return out.to(torch.uint8).view(torch.int8).reshape(*lead, nb * (B // per))


def _subbyte_unpack(packed: torch.Tensor, block_size: int, per: int,
                    bits: int) -> torch.Tensor:
    """Inverse of :func:`_subbyte_pack`: sign-extended int8 codes."""
    B = block_size
    *lead, Kp = packed.shape
    nb = Kp // (B // per)
    p = packed.to(torch.int32).reshape(*lead, nb, B // per)
    fields = []
    for i in range(per):
        f = (p >> (bits * i)) & ((1 << bits) - 1)
        fields.append(torch.where(f >= (1 << (bits - 1)), f - (1 << bits), f))
    c = torch.stack(fields, dim=-2)                 # (..., nb, per, B/per)
    return c.reshape(*lead, nb * B).to(torch.int8)


def _pf_pack(q: torch.Tensor, fmt, block_size: int, transport: str
             ) -> torch.Tensor:
    """Raw fp-bit sub-byte packing (pf4: 2 codes a byte; pf6: a low-4-bit
    sb4 plane and a high-2-bit sb2 plane per block). q: (..., nb, B)."""
    B = block_size
    c = encode_fp_bits(q, fmt).to(torch.int8)
    flat = c.reshape(c.shape[:-2] + (-1,))
    if transport == "pf4":
        if B % 16:
            raise ValueError("pf4 needs block_size % 16 == 0")
        return _subbyte_pack(flat, B, 2, 4)
    if B % 32:
        raise ValueError("pf6 needs block_size % 32 == 0")
    lo = _subbyte_pack(flat & 0xF, B, 2, 4)
    hi = _subbyte_pack((flat.to(torch.int32) >> 4).to(torch.int8), B, 4, 2)
    nb = flat.shape[-1] // B
    lo = lo.reshape(lo.shape[:-1] + (nb, B // 2))
    hi = hi.reshape(hi.shape[:-1] + (nb, B // 4))
    out = torch.cat([lo, hi], dim=-1)
    return out.reshape(out.shape[:-2] + (-1,))


def _pf_unpack(packed: torch.Tensor, fmt, block_size: int, transport: str
               ) -> torch.Tensor:
    """Inverse of :func:`_pf_pack`: sign-extended int8 fp-bit codes."""
    B = block_size
    if transport == "pf4":
        return _subbyte_unpack(packed, B, 2, 4)
    rows = 3 * B // 4
    nb = packed.shape[-1] // rows
    p = packed.reshape(packed.shape[:-1] + (nb, rows))
    lo4 = _subbyte_unpack(
        p[..., :B // 2].reshape(p.shape[:-2] + (nb * (B // 2),)),
        B, 2, 4).to(torch.int32) & 0xF
    hi2 = _subbyte_unpack(
        p[..., B // 2:].reshape(p.shape[:-2] + (nb * (B // 4),)),
        B, 4, 2).to(torch.int32)
    return ((hi2 << 4) | lo4).to(torch.int8)


def pf_decode_int(c: torch.Tensor, ebits: int, mm: int) -> torch.Tensor:
    """Sign-extended raw fp-bit codes -> integers q · 2^fold
    (fold = emi8_fold): mag = (m | implicit << mm) << max(e-1, 0)."""
    c = c.to(torch.int32)
    e = (c >> mm) & ((1 << ebits) - 1)
    m = c & ((1 << mm) - 1)
    ne = torch.clamp(e, max=1)
    mag = (m | (ne << mm)) << (e - ne)
    smask = c >> 31
    return (mag ^ smask) - smask


# ---------------------------------------------------------------------------
# Side-band outlier format (the MicroScopiQ two-level format)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PackedMXOutlier:
    """Two-level outlier-aware packed tensor.

    inlier:        PackedMX of the inliers (outlier slots hold code 0).
    out_codes:     (..., nblocks, K) outlier codes in the outlier format's
                   container dtype; (K/B, N, budget) for an axis-0 weight.
    out_pos:       (..., nblocks, K) int32 row within the block; -1: empty.
    out_scale_exp: (..., nblocks) int8 level-2 exponent.
    """

    inlier: PackedMX
    out_codes: torch.Tensor
    out_pos: torch.Tensor
    out_scale_exp: torch.Tensor
    outlier_format: str
    outlier_scale_bits: int

    @property
    def device(self) -> torch.device:
        return self.inlier.codes.device

    @property
    def budget(self) -> int:
        return self.out_codes.shape[-1]

    def nbytes(self) -> int:
        return self.inlier.nbytes() + sum(
            t.numel() * t.element_size()
            for t in (self.out_codes, self.out_pos, self.out_scale_exp))


def _row_slices(n_rows: int, row_elems: int):
    """Slices of at most ``_CHUNK_ELEMS`` elements over ``n_rows`` rows."""
    step = max(1, _CHUNK_ELEMS // max(row_elems, 1))
    return [slice(i, min(n_rows, i + step)) for i in range(0, n_rows, step)]


def _pack_outlier_rows(rows: torch.Tensor, fmt_in, fmt_out, isb: int,
                       osb: int, std_dev: float, block_size: int,
                       budget: int, round: str):
    """pack_mx_outlier of (r, n) rows blocked along n: inlier codes
    (r, nb·B), se_in (r, nb), outlier codes and positions (r, nb, budget),
    se_out (r, nb)."""
    from .outlier import _clamp_shared_exp, extract_outlier_indices

    eb_i, mb_i, emax_i, mn_i, _ = get_format_params(fmt_in)
    eb_o, mb_o, emax_o, mn_o, _ = get_format_params(fmt_out)
    blocked, _ = _block_last_axis(rows.to(torch.float32), block_size)
    mask = extract_outlier_indices(blocked, std_dev, axes=[2], use_abs=True,
                                   unbiased=False)
    inl = blocked * (1.0 - mask)
    outl = blocked * mask
    se_in = shared_exponents(inl, "max", axes=[2], ebits=0)
    se_in = _clamp_shared_exp(se_in, emax_i, isb, True)
    inl_q = quantize_elemwise_core(mul_pow2(inl, -se_in), mb_i, eb_i, mn_i,
                                   round=round, allow_denorm=True,
                                   saturate_normals=True)
    outl_l1 = mul_pow2(outl, se_in)
    se_out = shared_exponents(outl_l1, "max", axes=[2], ebits=0)
    se_out = _clamp_shared_exp(se_out, emax_o, osb, True)
    outl_scaled = mul_pow2(outl_l1, -se_out)
    outl_q = quantize_elemwise_core(outl_scaled, mb_o, eb_o, mn_o,
                                    round=round, allow_denorm=True,
                                    saturate_normals=True)
    # the `budget` largest |scaled outliers| of each block, stable order
    neg_mag = torch.where(mask > 0, -torch.abs(outl_scaled),
                          torch.ones_like(outl_scaled))
    order = torch.argsort(neg_mag, dim=-1, stable=True)[..., :budget]
    sel = torch.take_along_dim(mask, order, dim=-1) > 0
    out_codes = torch.where(sel, torch.take_along_dim(outl_q, order, dim=-1),
                            torch.zeros((), device=rows.device))
    out_pos = torch.where(sel, order, -1).to(torch.int32)
    return (_code_cast(inl_q, fmt_in).reshape(rows.shape[0], -1),
            se_in[..., 0].to(torch.int8), _code_cast(out_codes, fmt_out),
            out_pos, se_out[..., 0].to(torch.int8))


def pack_mx_outlier(A: torch.Tensor, inlier_scale_bits: int,
                    outlier_scale_bits: int, inlier_elem_format,
                    outlier_elem_format, std_dev: float = 2.0,
                    block_size: int = 16, outlier_budget: int = 4,
                    round: str = "nearest", axis: int = -1
                    ) -> PackedMXOutlier:
    """Pack with the two-level outlier scheme (GPTQ-variant statistics) into
    static-shape storage: per block at most ``outlier_budget`` outliers,
    largest |value| first; outliers beyond the budget are dropped."""
    fmt_in = inlier_elem_format if isinstance(inlier_elem_format, str) \
        else inlier_elem_format.name
    fmt_out = outlier_elem_format if isinstance(outlier_elem_format, str) \
        else outlier_elem_format.name
    axis_n = axis % A.ndim
    A_ = A if axis_n == A.ndim - 1 else A.movedim(axis_n, -1)
    lead, n = A_.shape[:-1], A_.shape[-1]
    rows = A_.reshape(-1, n)
    parts = [_pack_outlier_rows(rows[s], fmt_in, fmt_out, inlier_scale_bits,
                                outlier_scale_bits, std_dev, block_size,
                                outlier_budget, round)
             for s in _row_slices(rows.shape[0], n)]
    inl_codes, se_in8, oc, out_pos, se_out8 = (
        torch.cat([p[i] for p in parts]) for i in range(5))
    nb = se_in8.shape[-1]
    inl_codes = inl_codes.reshape(lead + (-1,))
    se_in8 = se_in8.reshape(lead + (nb,))
    se_out8 = se_out8.reshape(lead + (nb,))
    oc = oc.reshape(lead + oc.shape[1:])
    out_pos = out_pos.reshape(lead + out_pos.shape[1:])
    if axis_n != A.ndim - 1:
        inl_codes = inl_codes.movedim(-1, axis_n).contiguous()
        se_in8 = se_in8.movedim(-1, axis_n).contiguous()
        oc = oc.movedim(-2, axis_n).contiguous()
        out_pos = out_pos.movedim(-2, axis_n).contiguous()
        se_out8 = se_out8.movedim(-1, axis_n).contiguous()
    inlier = PackedMX(codes=inl_codes, scale_exp=se_in8, elem_format=fmt_in,
                      block_size=block_size, scale_bits=inlier_scale_bits,
                      orig_dim=n, axis=axis_n)
    return PackedMXOutlier(inlier=inlier, out_codes=oc, out_pos=out_pos,
                           out_scale_exp=se_out8, outlier_format=fmt_out,
                           outlier_scale_bits=outlier_scale_bits)


def _outlier_to_last(p: PackedMXOutlier):
    """(codes, se_in, out_codes, out_pos, se_out) with the blocked axis
    last (out_codes/out_pos: block axis second to last)."""
    inl = p.inlier
    codes, se_in, oc, pos, se_out = (inl.codes, inl.scale_exp, p.out_codes,
                                     p.out_pos, p.out_scale_exp)
    axis_n = inl.axis % codes.ndim
    if axis_n != codes.ndim - 1:
        codes = codes.movedim(axis_n, -1)
        se_in = se_in.movedim(axis_n, -1)
        oc = oc.movedim(axis_n, -2)
        pos = pos.movedim(axis_n, -2)
        se_out = se_out.movedim(axis_n, -1)
    return codes, se_in, oc, pos, se_out, axis_n


def dequantize_mx_outlier(p: PackedMXOutlier, dtype=torch.float32
                          ) -> torch.Tensor:
    """Dense tensor: inlier·2^L1 + outlier·2^(L2-L1) added at its block row
    (the scale_compute.v:55-57 merge)."""
    inl = p.inlier
    bs = inl.block_size
    codes, se_in8, oc, pos, se_out8, axis_n = _outlier_to_last(p)
    nb = codes.shape[-1] // bs
    vals = _code_decode(codes, inl.elem_format)
    vals = vals.reshape(vals.shape[:-1] + (nb, bs))
    se_in = se_in8.to(torch.float32)
    vals = mul_pow2(vals, se_in[..., None])
    se_out = se_out8.to(torch.float32)
    out_vals = mul_pow2(mul_pow2(_code_decode(oc, p.outlier_format),
                                 se_out[..., None]), -se_in[..., None])
    # an empty slot (pos -1) adds +0 at row 0, as the JAX scatter does
    valid = pos >= 0
    safe = torch.where(valid, pos, 0).to(torch.int64)
    upd = torch.where(valid, out_vals, torch.zeros((), device=vals.device))
    k = pos.shape[-1]
    vals = vals.reshape(-1, bs).scatter_add(
        1, safe.reshape(-1, k), upd.reshape(-1, k)).reshape(vals.shape)
    vals = vals.reshape(vals.shape[:-2] + (-1,))[..., :inl.orig_dim]
    if axis_n != vals.ndim - 1:
        vals = vals.movedim(-1, axis_n)
    return vals.to(dtype)


# ---------------------------------------------------------------------------
# emi8m: the two-level outlier format merged into one emi8-style byte stream
#
# Every element (inlier or outlier) of value m̂·2^E is one int8 byte
# (m̂ << (8-mw)) | e' with e' = E + fold - se relative to the block's L1
# exponent. Encoding is exact or raises ValueError.
# ---------------------------------------------------------------------------
def emi8m_decode_f32(codes: torch.Tensor, mw: int) -> torch.Tensor:
    """emi8m bytes -> value · 2^fold (the caller folds 2^(se - fold))."""
    c = codes.to(torch.int32)                  # int8 sign-extends m̂
    return ((c >> (8 - mw)) << (c & ((1 << (8 - mw)) - 1))).to(torch.float32)


def _exp2_f64(e: torch.Tensor) -> torch.Tensor:
    """Exact 2.0**e in float64 for integer e in [-1022, 1023]."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def _pow2_decompose(t: torch.Tensor):
    """Exact integer decomposition t = m0 · 2^e0 with m0 odd (0 for 0) of
    float64 values."""
    m, e = torch.frexp(t)
    m53 = torch.round(m * (2.0 ** 53)).to(torch.int64)      # exact
    e0 = e.to(torch.int64) - 53
    nz = m53 != 0
    low = torch.where(nz, m53 & -m53, torch.ones_like(m53))  # lowest set bit
    tz = torch.frexp(low.to(torch.float64))[1].to(torch.int64) - 1
    m0 = torch.where(nz, m53 >> tz, torch.zeros_like(m53))
    e0 = torch.where(nz, e0 + tz, torch.zeros_like(e0))
    return m0, e0, nz


def _emi8m_fields(decomp, mw: int, fold: int):
    """Exact (e', m̂) int64 fields for values m0·2^(e0+fold), or None if the
    (mw, fold) split cannot hold them exactly."""
    m0, e0, nz = decomp
    g = e0 + fold                                         # required shift
    if bool((nz & (g < 0)).any()):
        return None                                       # sub-fold values
    efield_max = (1 << (8 - mw)) - 1
    j = torch.clamp(g - efield_max, min=0)                # excess into m̂
    if bool((nz & (j > 32)).any()):
        return None
    zero = torch.zeros_like(m0)
    mhat = torch.where(nz, m0 << torch.clamp(j, max=32), zero)
    eprime = torch.where(nz, g - j, zero)
    if bool(((mhat > (1 << (mw - 1)) - 1) | (mhat < -(1 << (mw - 1)))).any()):
        return None
    # the in-kernel decode shifts m̂ << e' in int32: keep it representable
    if bool((nz & (torch.abs(mhat.to(torch.float64)) * _exp2_f64(eprime)
                   >= 2.0 ** 31)).any()):
        return None
    return eprime, mhat


def _emi8m_bytes(eprime: torch.Tensor, mhat: torch.Tensor, mw: int
                 ) -> torch.Tensor:
    byte = ((mhat & ((1 << mw) - 1)) << (8 - mw)) | eprime
    return (byte & 0xFF).to(torch.uint8).view(torch.int8)


def _emi8m_encode(chunks, mw: int, fold: int):
    """Encode the float64 values that ``chunks`` (callables) produce with
    one (mw, fold) for all of them: the smallest feasible mw, and with
    ``fold < 0`` the fold that makes the smallest exponent 0. Returns
    (byte chunks, mw, fold); raises ValueError when no split is exact."""
    if fold < 0:
        fold = 0
        for get in chunks:
            _, e0, nz = _pow2_decompose(get())
            if bool(nz.any()):
                fold = max(fold, int(-e0[nz].min()))
    tried = []
    for mw_c in ([mw] if mw else range(2, 8)):
        tried.append((mw_c, fold))
        out = []
        for get in chunks:
            fields = _emi8m_fields(_pow2_decompose(get()), mw_c, fold)
            if fields is None:
                out = None
                break
            out.append(_emi8m_bytes(*fields, mw_c))
        if out is not None:
            return out, mw_c, fold
    raise ValueError(f"values not exactly emi8m-representable {tried}")


def merge_outlier_emi8(p: PackedMXOutlier, mw: int = 0, fold: int = -1
                       ) -> PackedMX:
    """Collapse a PackedMXOutlier into one exact emi8m PackedMX. With mw and
    fold defaulted, the smallest feasible mantissa width and scale fold are
    chosen per tensor; raises ValueError when the values cannot be held
    exactly (keep the side-band then)."""
    inl = p.inlier
    bs = inl.block_size
    codes, se_in, oc, pos, se_out, axis_n = _outlier_to_last(p)
    shape = codes.shape
    nb = shape[-1] // bs
    k = pos.shape[-1]
    codes, se_in, se_out = (codes.reshape(-1, nb * bs), se_in.reshape(-1, nb),
                            se_out.reshape(-1, nb))
    oc, pos = oc.reshape(-1, nb, k), pos.reshape(-1, nb, k)

    def values(s):
        def get():
            t = _code_decode(codes[s], inl.elem_format).to(torch.float64)
            t = t.reshape(-1, nb, bs)
            # an outlier's value relative to its block's L1 exponent is
            # oc · 2^(L2 - 2·L1): pack_mx_outlier scales outliers by 2^L1
            # before the L2 exponent is taken
            sin = se_in[s].to(torch.int64)
            rel = oc[s].to(torch.float64) * _exp2_f64(
                se_out[s].to(torch.int64) - 2 * sin)[..., None]
            valid = pos[s] >= 0
            addv = torch.zeros((t.shape[0] * nb, bs + 1), dtype=t.dtype,
                               device=t.device)
            # valid rows are unique within a block; empty slots go to a
            # dump column
            addv.scatter_(1, torch.where(valid, pos[s], bs).to(torch.int64)
                          .reshape(-1, k),
                          torch.where(valid, rel, 0.0).reshape(-1, k))
            return (t + addv[:, :bs].reshape(t.shape)).reshape(-1)
        return get

    out, mw_c, fold = _emi8m_encode(
        [values(s) for s in _row_slices(codes.shape[0], nb * bs)], mw, fold)
    out = torch.cat(out).reshape(shape)
    if axis_n != len(shape) - 1:
        out = out.movedim(-1, axis_n).contiguous()
    return dataclasses.replace(inl, codes=out, transport="emi8m",
                               transport_mw=mw_c, transport_fold=fold)


def pack_emi8m_absolute(A: torch.Tensor, block_size: int = 32, mw: int = 0,
                        axis: int = 0, elem_format: str = "int2") -> PackedMX:
    """Encode exact (already fake-quantized) values as an *absolute* emi8m
    stream: one (e'|m̂) byte per element, one per-tensor scale fold and
    all-zero block exponents, for quantized tensors of any block geometry.
    Raises ValueError when the tensor's range or mantissas do not fit a
    byte."""
    t = A.to(torch.float32)
    axis_n = axis % t.ndim
    if axis_n != t.ndim - 1:
        t = t.movedim(axis_n, -1)
    lead, n = t.shape[:-1], t.shape[-1]
    pad = (-n) % block_size
    rows = t.reshape(-1, n)
    if pad:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], pad))], dim=1)

    def values(s):
        return lambda: rows[s].to(torch.float64).reshape(-1)

    out, mw_c, fold = _emi8m_encode(
        [values(s) for s in _row_slices(rows.shape[0], n + pad)], mw, -1)
    codes = torch.cat(out).reshape(lead + (n + pad,))
    nb = (n + pad) // block_size
    se = torch.zeros(lead + (nb,), dtype=torch.int8, device=A.device)
    if axis_n != A.ndim - 1:
        codes = codes.movedim(-1, axis_n).contiguous()
        se = se.movedim(-1, axis_n).contiguous()
    return PackedMX(codes=codes, scale_exp=se, elem_format=elem_format,
                    block_size=block_size, scale_bits=8, orig_dim=n,
                    axis=axis_n, transport="emi8m", transport_mw=mw_c,
                    transport_fold=fold)


def emi8m_rebase(p: PackedMX, mw: int, fold: int) -> PackedMX:
    """Re-encode an emi8m tensor to a common (mw, fold), as fused
    projections need. Exact or raises ValueError."""
    if p.transport != "emi8m":
        raise ValueError(f"emi8m_rebase of a {p.transport!r} tensor")
    if mw == p.transport_mw and fold == p.transport_fold:
        return p
    flat = p.codes.reshape(-1)
    omw = p.transport_mw
    efield_max = (1 << (8 - mw)) - 1
    out = []
    for s in _row_slices(flat.numel(), 1):
        c = flat[s].view(torch.uint8).to(torch.int64)
        mhat = ((c >> (8 - omw)) ^ (1 << (omw - 1))) - (1 << (omw - 1))
        eprime = (c & ((1 << (8 - omw)) - 1)) + (fold - p.transport_fold)
        j = torch.clamp(eprime - efield_max, min=0)
        if bool(((mhat != 0) & ((eprime < 0) | (j > 32))).any()):
            raise ValueError("emi8m rebase infeasible")
        zero = torch.zeros_like(mhat)
        mhat = torch.where(mhat != 0, mhat << torch.clamp(j, max=32), zero)
        eprime = torch.where(mhat != 0, eprime - j, zero)
        if bool(((mhat > (1 << (mw - 1)) - 1)
                 | (mhat < -(1 << (mw - 1)))).any()):
            raise ValueError("emi8m rebase infeasible")
        out.append(_emi8m_bytes(eprime, mhat, mw))
    return dataclasses.replace(p, codes=torch.cat(out).reshape(p.codes.shape),
                               transport_mw=mw, transport_fold=fold)


# ---------------------------------------------------------------------------
# Compact N-blocked serving transport (the paper's bit budget)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PackedOutlierNB:
    """MicroScopiQ compact transport: int2 inliers and fp4 outliers in the
    GPTQ out-axis 16-element blocks (llm/opt.py), stored transposed (N, K).

    codes:         (Np/4, K) int8: sb2-packed int2 inlier codes along N
                   (byte row 4b + r holds rows 16b + r + 4i at bits 2i).
    scale_exp:     (NB, K) int8 level-1 (inlier) exponents.
    out_byte:      (budget, NB, K) int8 ``pos << 4 | fp4 bits``; an empty
                   slot is byte 0, which decodes to +0.
    out_scale_exp: (NB, K) int8 level-2 (outlier) exponents.

    W[n, k] = inl·2^L1 + fp4·2^(L2-L1) at the slot rows.
    """

    codes: torch.Tensor
    scale_exp: torch.Tensor
    out_byte: torch.Tensor
    out_scale_exp: torch.Tensor
    elem_format: str
    outlier_format: str
    block_size: int
    orig_n: int
    orig_k: int

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def budget(self) -> int:
        return self.out_byte.shape[0]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.codes, self.scale_exp, self.out_byte,
                             self.out_scale_exp))

    @property
    def bits_per_element(self) -> float:
        """Realized bits per weight element, all streams counted."""
        return self.nbytes() * 8 / (self.orig_n * self.orig_k)


def pack_outlier_nb(decisions: dict, budget: int = 0,
                    elem_format: str = "int2",
                    outlier_format: str = "fp4_e2m1") -> PackedOutlierNB:
    """Build the compact transport from quantization *decisions*
    (``quantize_mx_outlier_hessian_decisions`` on the (N, K) weight with
    ``axes=[0]`` and block 16, plus ``"block_size"``); exact by
    construction. ``budget=0`` sizes the slots to the largest per-block
    outlier count; a smaller explicit budget raises ValueError if a block
    overflows (cap at quantization time with ``max_outliers_per_block``).
    """
    bs = int(decisions["block_size"])
    inl = torch.as_tensor(decisions["inl_code"]).to(torch.float32)  # (N, K)
    dev = inl.device
    get = lambda k: torch.as_tensor(decisions[k], device=dev)
    out = get("out_code").to(torch.float32)
    mask = get("mask") != 0
    se_in = get("se_in").to(torch.int8)                               # (NB, K)
    se_out = get("se_out").to(torch.int8)
    N, K = inl.shape
    if bs != 16:
        raise ValueError("the compact transport is specified for block 16")
    pad = (-N) % bs
    if pad:
        inl = torch.cat([inl, inl.new_zeros((pad, K))])
        out = torch.cat([out, out.new_zeros((pad, K))])
        mask = torch.cat([mask, mask.new_zeros((pad, K))])
    nb = inl.shape[0] // bs
    _, mbits, _, _, _ = get_format_params(elem_format)
    icodes = torch.round(inl * (2.0 ** (mbits - 2))).to(torch.int8)
    packed = _subbyte_pack(icodes.T, bs, 4, 2).T.contiguous()     # (Np/4, K)

    mb = mask.reshape(nb, bs, K)
    maxc = int(mb.sum(dim=1).max()) if mb.numel() else 0
    if budget == 0:
        budget = max(maxc, 1)
    elif maxc > budget:
        raise ValueError(
            f"{maxc} outliers in a block exceed budget {budget}; quantize "
            "with max_outliers_per_block to cap at calibration time")
    ob = out.reshape(nb, bs, K)
    parts = []
    for s in _row_slices(nb, bs * K):
        m = mb[s]
        # outliers first, in row order (stable): a nonzero fp4 code never
        # has value 0, so byte 0 marks an empty slot unambiguously
        order = torch.argsort((~m).to(torch.uint8), dim=1,
                              stable=True)[:, :budget, :]
        sel_val = torch.take_along_dim(ob[s], order, dim=1)
        sel = torch.take_along_dim(m, order, dim=1)
        fp4 = torch.where(sel, encode_fp_bits(sel_val, outlier_format).to(
            torch.int32), 0)
        pos = torch.where(sel, order, 0).to(torch.int32)
        parts.append(((pos << 4) | (fp4 & 0xF)).to(torch.uint8))
    out_byte = torch.cat(parts).view(torch.int8).movedim(1, 0).contiguous()
    return PackedOutlierNB(codes=packed, scale_exp=se_in, out_byte=out_byte,
                           out_scale_exp=se_out, elem_format=elem_format,
                           outlier_format=outlier_format, block_size=bs,
                           orig_n=N, orig_k=K)


def outlier_nb_parts(p: PackedOutlierNB) -> dict:
    """The (N, K) f32 parts of the compact transport: ``codes`` (the inlier
    codes as stored), ``inliers`` (their values, codes times the level-1
    scale) and ``outliers`` (each slot's value at its row, zero elsewhere).
    Inliers are zero at outlier rows, so inliers + outliers is exact."""
    bs = p.block_size
    icodes = _subbyte_unpack(p.codes.T, bs, 4, 2).T              # (Np, K)
    Np, K = icodes.shape
    nb = Np // bs
    vals = _code_decode(icodes, p.elem_format)
    se_in = p.scale_exp.to(torch.float32)                         # (nb, K)
    inl = mul_pow2(vals.reshape(nb, bs, K), se_in[:, None, :])
    b = p.out_byte.to(torch.int32) & 0xFF                         # (s, nb, K)
    pos = b >> 4
    oval = decode_fp_bits(b & 0xF, p.outlier_format)
    contrib = mul_pow2(oval, (p.out_scale_exp.to(torch.float32) - se_in)[None])
    row = torch.arange(bs, device=inl.device)[None, :, None]
    out = torch.zeros_like(inl)
    for s in range(p.out_byte.shape[0]):
        out = out + torch.where(row == pos[s][:, None, :],
                                contrib[s][:, None, :], 0.0)
    n = p.orig_n
    return {"codes": icodes[:n].to(torch.float32),
            "inliers": inl.reshape(Np, K)[:n],
            "outliers": out.reshape(Np, K)[:n]}


def dequantize_outlier_nb(p: PackedOutlierNB, dtype=torch.float32
                          ) -> torch.Tensor:
    """Dense (N, K) tensor from the compact transport: the plain twin of the
    kernel's decode, exact against the fake-quant output."""
    parts = outlier_nb_parts(p)
    return (parts["inliers"] + parts["outliers"]).to(dtype)
