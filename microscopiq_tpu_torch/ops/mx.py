"""Microscaling (MX) block quantization in PyTorch.

Counterpart of ``microscopiq_tpu/ops/mx.py``: tile the shared axes into
``block_size`` blocks, take one power-of-two scale per block from the max
magnitude, clamp its exponent to ``scale_bits``, quantize the elements
against the scaled values and rescale. Bit-exact with the JAX function.
:func:`quantize_mx_op` is the spec-driven form that the MX layers call.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..formats import FP32_EXPONENT_BIAS, FP32_MIN_NORMAL, get_format_params
from .elemwise import exp2_exact, floor_log2, mul_pow2, quantize_elemwise_core

Axes = Union[int, Sequence[int], None]


def _normalize_axes(axes: Axes, ndim: int) -> List[int]:
    axes = [axes] if isinstance(axes, int) else list(axes)
    return [x + ndim if x < 0 else x for x in axes]


def _pad_axis(A: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Append ``n`` zeros along ``axis``."""
    shape = list(A.shape)
    shape[axis] = n
    return torch.cat([A, A.new_zeros(shape)], dim=axis)


def reshape_to_blocks(A: torch.Tensor, axes: Sequence[int], block_size: int
                      ) -> Tuple[torch.Tensor, List[int], Tuple[int, ...],
                                 Tuple[int, ...]]:
    """Tile ``axes`` of A into (num_blocks, block_size) pairs with zero pad.

    Returns (blocked tensor, shifted axes, orig shape (post-unsqueeze),
    padded shape).
    """
    if axes is None:
        raise ValueError("axes required to determine block dimension")
    if block_size == 0:
        raise ValueError("block_size == 0 in reshape_to_blocks")
    axes = sorted(_normalize_axes(axes, A.ndim))
    for i in range(len(axes)):
        axes[i] += i
        A = A.unsqueeze(axes[i] + 1)
    orig_shape = tuple(A.shape)
    for axis in axes:
        size = orig_shape[axis]
        if size % block_size != 0:
            A = _pad_axis(A, axis, block_size - size % block_size)
    padded_shape = tuple(A.shape)
    shape = list(padded_shape)
    for axis in axes:
        if shape[axis] >= block_size:
            shape[axis + 1] = block_size
            shape[axis] = shape[axis] // block_size
        else:
            # short axis: keep it whole inside a single block
            shape[axis + 1] = shape[axis]
            shape[axis] = 1
    return A.reshape(shape), axes, orig_shape, padded_shape


def undo_reshape_to_blocks(A: torch.Tensor, padded_shape: Sequence[int],
                           orig_shape: Sequence[int], axes: Sequence[int]
                           ) -> torch.Tensor:
    """Inverse of :func:`reshape_to_blocks`."""
    A = A.reshape(padded_shape)
    if list(padded_shape) != list(orig_shape):
        A = A[tuple(slice(0, x) for x in orig_shape)]
    for axis in reversed(list(axes)):
        A = A.squeeze(axis + 1)
    return A


def shared_exponents(A: torch.Tensor, method: str = "max",
                     axes: Optional[Sequence[int]] = None,
                     ebits: int = 0) -> torch.Tensor:
    """Shared exponent per block: floor(log2(max |A| over axes))."""
    if method == "max":
        if axes is None:
            shared_exp = torch.abs(A).amax()
        else:
            shared_exp = torch.abs(A)
            for axis in axes:
                shared_exp = shared_exp.amax(dim=axis, keepdim=True)
    elif method == "none":
        shared_exp = torch.abs(A)
    else:
        raise ValueError(f"Unrecognized shared exponent method {method}")
    shared_exp = floor_log2(
        shared_exp + FP32_MIN_NORMAL * (shared_exp == 0).to(shared_exp.dtype))
    if ebits > 0:
        emax = 2 ** (ebits - 1) - 1
        # overflow poisons the block with NaN; underflow clamps
        shared_exp = torch.where(shared_exp > emax,
                                 torch.full_like(shared_exp, float("nan")),
                                 shared_exp)
        shared_exp = torch.where(shared_exp < -emax,
                                 torch.full_like(shared_exp, float(-emax)),
                                 shared_exp)
    return shared_exp


def quantize_mx(A: torch.Tensor, scale_bits: int, elem_format,
                shared_exp_method: str = "max", axes: Axes = None,
                block_size: int = 0, round: str = "nearest",
                flush_fp32_subnorms: bool = False) -> torch.Tensor:
    """Fake-quantize A to an MX format with per-block shared scales."""
    if elem_format is None:
        return A
    if scale_bits <= 0:
        raise ValueError("scale_bits must be positive")
    axes = _normalize_axes(axes, A.ndim)
    ebits, mbits, emax, max_norm, _ = get_format_params(elem_format)

    orig_shape = padded_shape = None
    if block_size > 0:
        A, axes, orig_shape, padded_shape = reshape_to_blocks(
            A, axes, block_size)
    shared_exp_axes = [x + 1 for x in axes] if block_size > 0 else axes
    shared_exp = shared_exponents(A, shared_exp_method, shared_exp_axes,
                                  ebits=0)
    if flush_fp32_subnorms:
        A = A * (shared_exp > -FP32_EXPONENT_BIAS).to(A.dtype)

    shared_exp = shared_exp - emax
    scale_emax = 2 ** (scale_bits - 1) - 1
    shared_exp = torch.where(shared_exp > scale_emax,
                             torch.full_like(shared_exp, float("nan")),
                             shared_exp)
    shared_exp = torch.where(shared_exp < -scale_emax,
                             torch.full_like(shared_exp, float(-scale_emax)),
                             shared_exp)
    # the reference adds 1e-6 to the scale before dividing (kept for parity)
    A = A / (exp2_exact(shared_exp) + 1e-6)
    A = quantize_elemwise_core(A, mbits, ebits, max_norm, round=round,
                               allow_denorm=True, saturate_normals=True)
    A = mul_pow2(A, shared_exp)
    if block_size:
        A = undo_reshape_to_blocks(A, padded_shape, orig_shape, axes)
    return A


def quantize_mx_op(A: torch.Tensor, mx_specs, elem_format=None,
                   block_size: Optional[int] = None, axes: Axes = None,
                   round: str = "nearest") -> torch.Tensor:
    """Spec-driven :func:`quantize_mx`: the block size, shared-exponent
    method and subnormal flush from ``mx_specs``, scale_bits 8 where the
    spec leaves it 0; ``elem_format=None`` passes A through."""
    if elem_format is None:
        return A
    if block_size is None:
        block_size = mx_specs["block_size"]
    scale_bits = mx_specs["scale_bits"] if mx_specs["scale_bits"] != 0 else 8
    return quantize_mx(
        A, scale_bits, elem_format, block_size=block_size, axes=axes,
        round=round, shared_exp_method=mx_specs["shared_exp_method"],
        flush_fp32_subnorms=mx_specs["mx_flush_fp32_subnorms"])
