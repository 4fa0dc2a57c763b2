"""Posit number system, vectorized in PyTorch.

Counterpart of ``microscopiq_tpu/posit/posit.py``: posit(nbits, es)
encode/decode, fake-quantization, arithmetic (+, -, *, /), the fast
sigmoid and the ``Posit`` wrapper. Posit values are ordered like their
two's-complement encodings, so a sorted value table per (nbits, es), built
once on the host in float64, turns

* decode into a table gather,
* encode / fake-quant into ``torch.searchsorted`` (left side, as
  ``jnp.searchsorted``) and round-to-nearest with ties to the even
  encoding (the posit standard),
* arithmetic into decode, a float32 op and re-encode.

As in JAX, the search runs on the float32 copy of the table and the inputs
are compared in float32. Codes are computed in int64 (CUDA's uint16 and
uint32 lack ``%``, ``^`` and ``>>``) and cast once to uint8, uint16 or
uint32 by ``nbits``, as JAX returns them; the bits are the same.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import resolve_device


@functools.lru_cache(maxsize=16)
def posit_table(nbits: int, es: int) -> np.ndarray:
    """Values of all 2^nbits posit encodings, indexed by the unsigned
    encoding. Entry 2^(nbits-1) (NaR) is NaN."""
    n = 1 << nbits
    vals = np.zeros(n, np.float64)
    useed = 2.0 ** (2 ** es)
    for code in range(n):
        if code == 0:
            continue
        if code == n // 2:
            vals[code] = np.nan  # NaR
            continue
        bits = code
        sign = (bits >> (nbits - 1)) & 1
        if sign:
            bits = (-bits) & (n - 1)  # two's complement magnitude
        # regime: run of identical bits after the sign bit
        r0 = (bits >> (nbits - 2)) & 1
        run = 0
        i = nbits - 2
        while i >= 0 and ((bits >> i) & 1) == r0:
            run += 1
            i -= 1
        k = (run - 1) if r0 == 1 else -run
        # i = position of the regime-terminating bit (or -1 if the regime
        # fills the word); rem_count bits remain below it
        rem_count = max(i, 0)
        e = 0
        ebits_avail = min(es, rem_count)
        if ebits_avail > 0:
            e = (bits >> (rem_count - ebits_avail)) & \
                ((1 << ebits_avail) - 1)
            # short exponent fields are left-aligned per the standard
            e <<= (es - ebits_avail)
        fbits = max(rem_count - es, 0)
        f = bits & ((1 << fbits) - 1) if fbits > 0 else 0
        frac = 1.0 + f / (1 << fbits) if fbits > 0 else 1.0
        mag = (useed ** k) * (2.0 ** e) * frac
        vals[code] = -mag if sign else mag
    return vals


@functools.lru_cache(maxsize=16)
def _sorted_table(nbits: int, es: int) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted values, their encodings), NaR excluded."""
    vals = posit_table(nbits, es)
    codes = np.arange(len(vals))
    keep = ~np.isnan(vals)
    vals, codes = vals[keep], codes[keep]
    order = np.argsort(vals)
    return vals[order], codes[order]


_DEVICE_TABLES: dict = {}


def _tables(nbits: int, es: int, device: torch.device):
    """(sorted float32 values, their int64 codes, the float32 table by
    code) on ``device``, made once per device."""
    key = (nbits, es, str(device))
    if key not in _DEVICE_TABLES:
        vals, codes = _sorted_table(nbits, es)
        _DEVICE_TABLES[key] = (
            torch.as_tensor(vals.astype(np.float32), device=device),
            torch.as_tensor(codes.astype(np.int64), device=device),
            torch.as_tensor(posit_table(nbits, es).astype(np.float32),
                            device=device))
    return _DEVICE_TABLES[key]


def _nearest(x: torch.Tensor, nbits: int, es: int):
    """(float32 x, index of the upper neighbour, pick the upper one) of
    round-to-nearest on the sorted table, ties to the even encoding."""
    tv, tc, _ = _tables(nbits, es, x.device)
    xf = x.to(torch.float32)
    idx = torch.clamp(torch.searchsorted(tv, xf.contiguous(), right=False),
                      1, tv.shape[0] - 1)
    lo, hi = tv[idx - 1], tv[idx]
    pick_hi = (xf - lo) > (hi - xf)
    tie = (xf - lo) == (hi - xf)
    pick_hi = torch.where(tie, (tc[idx] % 2) == 0, pick_hi)
    return xf, idx, pick_hi


def quantize_posit(x: torch.Tensor, nbits: int = 8,
                   es: int = 1) -> torch.Tensor:
    """Fake-quantize to the nearest posit value (ties to even encoding);
    NaN stays NaN."""
    tv, _, _ = _tables(nbits, es, x.device)
    xf, idx, pick_hi = _nearest(x, nbits, es)
    out = torch.where(pick_hi, tv[idx], tv[idx - 1])
    out = torch.where(torch.isnan(xf), torch.full_like(out, float("nan")),
                      out)
    return out.to(x.dtype)


def code_dtype(nbits: int) -> torch.dtype:
    return (torch.uint8 if nbits <= 8 else torch.uint16 if nbits <= 16
            else torch.uint32)


def encode_posit(x: torch.Tensor, nbits: int = 8,
                 es: int = 1) -> torch.Tensor:
    """Float -> posit encodings (uint dtype sized to nbits); NaN -> NaR."""
    _, tc, _ = _tables(nbits, es, x.device)
    xf, idx, pick_hi = _nearest(x, nbits, es)
    code = torch.where(pick_hi, tc[idx], tc[idx - 1])
    code = torch.where(torch.isnan(xf),
                       torch.full_like(code, 1 << (nbits - 1)), code)
    return code.to(code_dtype(nbits))


def decode_posit(codes: torch.Tensor, nbits: int = 8, es: int = 1,
                 dtype=torch.float32) -> torch.Tensor:
    """Posit encodings -> float values (table gather); NaR -> NaN."""
    _, _, table = _tables(nbits, es, codes.device)
    return table[codes.to(torch.int64)].to(dtype)


def _arith(op, a, b, nbits, es):
    return quantize_posit(op(a.to(torch.float32), b.to(torch.float32)),
                          nbits, es)


def posit_add(a, b, nbits=8, es=1):
    return _arith(torch.add, a, b, nbits, es)


def posit_sub(a, b, nbits=8, es=1):
    return _arith(torch.sub, a, b, nbits, es)


def posit_mul(a, b, nbits=8, es=1):
    return _arith(torch.mul, a, b, nbits, es)


def posit_div(a, b, nbits=8, es=1):
    return _arith(torch.div, a, b, nbits, es)


def posit_sigmoid(x: torch.Tensor, nbits: int = 8,
                  es: int = 0) -> torch.Tensor:
    """The posit fast-sigmoid trick: for es=0 posits, sigmoid(x) ~
    decode((NaR_code XOR encode(x)) >> 2), the top bit flipped and the
    code shifted."""
    codes = encode_posit(x, nbits, es).to(torch.int64)
    flipped = (codes ^ (1 << (nbits - 1))) >> 2
    return decode_posit(flipped, nbits, es)


class Posit:
    """Scalar/tensor wrapper mirroring the reference class. Inputs that are
    not tensors go to ``device`` (the card unless the caller asks for the
    CPU); float64 becomes float32, as ``jnp.asarray`` makes it."""

    def __init__(self, nbits: int = 8, es: int = 1, device="cuda"):
        self.nbits = nbits
        self.es = es
        self.device = resolve_device(device)

    def _tensor(self, x) -> torch.Tensor:
        t = (x if isinstance(x, torch.Tensor)
             else torch.as_tensor(np.asarray(x), device=self.device))
        return t.to(torch.float32) if t.dtype == torch.float64 else t

    def set_float(self, x):
        return encode_posit(self._tensor(x), self.nbits, self.es)

    def to_float(self, codes):
        return decode_posit(codes, self.nbits, self.es)

    def posify(self, x):
        return quantize_posit(self._tensor(x), self.nbits, self.es)

    def __call__(self, x):
        return self.posify(x)
