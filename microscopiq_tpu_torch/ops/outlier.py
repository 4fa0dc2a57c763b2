"""Outlier-aware two-level MX quantization (the MicroScopiQ core) in PyTorch.

Counterpart of ``microscopiq_tpu/ops/outlier.py`` and bit-exact with it (and
with ``tests/golden/outlier.npz``): each block is split into inliers and
outliers by a mean ± k·std rule, inliers are quantized under a level-1 shared
power-of-two scale, outliers under a second, level-2 scale taken after
multiplying them by the level-1 scale.

* :func:`quantize_mx_outlier_hessian` (GPTQ loop; returns outlier counts),
  :func:`quantize_mx_outlier_hessian_decisions` (also the pre-scale codes,
  mask and both exponents that a lossless packer needs),
  :func:`quantize_mx_outlier_v1` (RTN);
* :func:`quantize_mx_outlier_op_v1` / :func:`quantize_mx_outlier_op`, the
  nn-layer variant: statistics of raw values with Bessel-corrected std along
  the block-count axes, no -20 underflow floor.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..formats import FP32_EXPONENT_BIAS, get_format_params
from ..specs import mx_assert_finite
from .elemwise import mul_pow2, quantize_elemwise_core
from .mx import (_normalize_axes, reshape_to_blocks, shared_exponents,
                 undo_reshape_to_blocks)


def extract_outlier_indices(A: torch.Tensor, std_dev: float = 1.0,
                            axes: Optional[Sequence[int]] = None,
                            use_abs: bool = True,
                            unbiased: bool = False) -> torch.Tensor:
    """Per-block outlier mask: 1.0 where A falls outside mean ± k·std.

    The statistics are of |A| (``use_abs``) or of A, with the population or
    the Bessel-corrected std; the *raw* A is compared with the bounds in
    both cases, as the reference does.
    """
    ddof = 1 if unbiased else 0
    if axes is not None:
        dims = tuple(axes)
        X = torch.abs(A) if use_abs else A
        mean = torch.mean(X, dim=dims, keepdim=True)
        var = torch.var(X, dim=dims, correction=ddof, keepdim=True)
        std = torch.sqrt(var)
    else:
        mean = torch.mean(A)
        std = torch.std(A, correction=ddof)
    lower = mean - std_dev * std
    upper = mean + std_dev * std
    return ((A < lower) | (A > upper)).to(A.dtype)


def _clamp_shared_exp(shared_exp: torch.Tensor, emax_elem: int,
                      scale_bits: int, underflow_floor_20: bool
                      ) -> torch.Tensor:
    """Offset by the element format's emax and clamp to the scale_bits
    range: overflow poisons to NaN, underflow clamps to -scale_emax (or to
    -20 when ``underflow_floor_20`` and scale_emax > 20)."""
    shared_exp = shared_exp - emax_elem
    scale_emax = 2 ** (scale_bits - 1) - 1
    floor = -scale_emax
    if underflow_floor_20 and -scale_emax < -20:
        floor = -20
    shared_exp = torch.where(shared_exp > scale_emax,
                             torch.full_like(shared_exp, float("nan")),
                             shared_exp)
    return torch.where(shared_exp < -scale_emax,
                       torch.full_like(shared_exp, float(floor)), shared_exp)


def _outlier_quantize_core(A, inlier_scale_bits, outlier_scale_bits,
                           inlier_elem_format, outlier_elem_format,
                           shared_exp_method, std_dev, axes, block_size,
                           round, flush_fp32_subnorms, *, stats_use_abs,
                           stats_unbiased, stats_on_block_axis,
                           underflow_floor_20, want_num_outliers,
                           want_decisions=False, max_outliers_per_block=0):
    assert inlier_scale_bits > 0 and outlier_scale_bits > 0
    axes = _normalize_axes(axes, A.ndim)
    ebits_in, mbits_in, emax_in, max_norm_in, _ = get_format_params(
        inlier_elem_format)
    ebits_out, mbits_out, emax_out, max_norm_out, _ = get_format_params(
        outlier_elem_format)

    orig_shape = padded_shape = None
    if block_size > 0:
        A, axes, orig_shape, padded_shape = reshape_to_blocks(A, axes,
                                                              block_size)
    shared_exp_axes = [x + 1 for x in axes] if block_size > 0 else axes
    # intra-block statistics for the GPTQ variants, block-count axes for the
    # nn-op variant (mx_ops.py:248 passes the pre-shift axes)
    stats_axes = axes if stats_on_block_axis else shared_exp_axes
    outlier_pos = extract_outlier_indices(
        A, std_dev, stats_axes, use_abs=stats_use_abs,
        unbiased=stats_unbiased)

    if max_outliers_per_block:
        # keep the k largest-|A| outliers of each block; stable sorts make
        # the kept count exact (the compact transport's slot budget)
        assert block_size > 0 and len(shared_exp_axes) == 1
        ba = shared_exp_axes[0]
        Am = torch.movedim(torch.abs(A) * outlier_pos, ba, -1)
        flat = Am.reshape(-1, Am.shape[-1])
        order = torch.argsort(-flat, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)     # inverse perm
        keep = (ranks < max_outliers_per_block).reshape(Am.shape)
        outlier_pos = outlier_pos * torch.movedim(keep, -1, ba).to(
            outlier_pos.dtype)

    num_outliers = None
    if want_num_outliers:
        # reference quirk (utils/quant.py:66): counts every block_size-th
        # block along axis 0 only; GPTQ's prune budget depends on it
        num_outliers = (outlier_pos[::block_size].sum(dim=-2).flatten()
                        .to(torch.int8))

    inlier_val = A * (1.0 - outlier_pos)
    outlier_val = A * outlier_pos

    # level-1 (inlier) shared scale
    shared_exp_in = shared_exponents(inlier_val, method=shared_exp_method,
                                     axes=shared_exp_axes, ebits=0)
    if flush_fp32_subnorms:
        inlier_val = inlier_val * (
            shared_exp_in > -FP32_EXPONENT_BIAS).to(inlier_val.dtype)
    shared_exp_in = _clamp_shared_exp(shared_exp_in, emax_in,
                                      inlier_scale_bits, underflow_floor_20)
    inlier_val = mul_pow2(inlier_val, -shared_exp_in)
    # level-1 scaling of outliers, undone at reconstruction
    # (scale_compute.v:55-57's L2-L1 scale merge)
    outlier_val = mul_pow2(outlier_val, shared_exp_in)
    inlier_val = quantize_elemwise_core(
        inlier_val, mbits_in, ebits_in, max_norm_in, round=round,
        allow_denorm=True, saturate_normals=True)
    inlier_code = inlier_val
    inlier_val = mul_pow2(inlier_val, shared_exp_in)
    inlier_val = mx_assert_finite(inlier_val, "inlier_val")
    outlier_val = mx_assert_finite(outlier_val, "outlier_val (level-1)")

    # level-2 (outlier) shared scale
    shared_exp_out = shared_exponents(outlier_val, method=shared_exp_method,
                                      axes=shared_exp_axes, ebits=0)
    shared_exp_out = _clamp_shared_exp(shared_exp_out, emax_out,
                                       outlier_scale_bits, underflow_floor_20)
    shared_exp_out = mx_assert_finite(shared_exp_out, "shared_exp_out")
    outlier_val = mul_pow2(outlier_val, -shared_exp_out)
    outlier_val = quantize_elemwise_core(
        outlier_val, mbits_out, ebits_out, max_norm_out, round=round,
        allow_denorm=True, saturate_normals=True)
    outlier_val = mx_assert_finite(outlier_val, "outlier_val (quantized)")
    outlier_code = outlier_val
    outlier_val = mul_pow2(mul_pow2(outlier_val, shared_exp_out),
                           -shared_exp_in)

    A = inlier_val + outlier_val
    if block_size:
        A = undo_reshape_to_blocks(A, padded_shape, orig_shape, axes)
    if want_decisions:
        def undo(x):
            return (undo_reshape_to_blocks(x, padded_shape, orig_shape, axes)
                    if block_size else x)

        dims = tuple(shared_exp_axes)
        decisions = {"inl_code": undo(inlier_code),
                     "out_code": undo(outlier_code),
                     "mask": undo(outlier_pos),
                     "se_in": torch.squeeze(shared_exp_in, dim=dims),
                     "se_out": torch.squeeze(shared_exp_out, dim=dims)}
        return A, num_outliers, decisions
    return A, num_outliers


_GPTQ_STATS = dict(stats_use_abs=True, stats_unbiased=False,
                   stats_on_block_axis=False, underflow_floor_20=True)


def quantize_mx_outlier_hessian(A, inlier_scale_bits: int,
                                outlier_scale_bits: int, inlier_elem_format,
                                outlier_elem_format,
                                shared_exp_method: str = "max",
                                std_dev: float = 2, axes=None,
                                block_size: int = 0, round: str = "nearest",
                                flush_fp32_subnorms: bool = False,
                                max_outliers_per_block: int = 0):
    """GPTQ-loop outlier quantizer; returns (quantized A, outlier counts).
    ``max_outliers_per_block`` (0: unbounded, the reference) keeps only the
    k largest-|A| outliers of each block."""
    if inlier_elem_format is None:
        return A, torch.zeros((), dtype=torch.int8)
    return _outlier_quantize_core(
        A, inlier_scale_bits, outlier_scale_bits, inlier_elem_format,
        outlier_elem_format, shared_exp_method, std_dev, axes, block_size,
        round, flush_fp32_subnorms, **_GPTQ_STATS, want_num_outliers=True,
        max_outliers_per_block=max_outliers_per_block)


def quantize_mx_outlier_hessian_decisions(A, inlier_scale_bits: int,
                                          outlier_scale_bits: int,
                                          inlier_elem_format,
                                          outlier_elem_format,
                                          shared_exp_method: str = "max",
                                          std_dev: float = 2, axes=None,
                                          block_size: int = 0,
                                          round: str = "nearest",
                                          flush_fp32_subnorms: bool = False,
                                          max_outliers_per_block: int = 0):
    """:func:`quantize_mx_outlier_hessian` plus its *decisions*: pre-scale
    codes, outlier mask and both shared exponents, from which
    :func:`..packing.pack_outlier_nb` packs losslessly."""
    if inlier_elem_format is None:
        return A, torch.zeros((), dtype=torch.int8), None
    return _outlier_quantize_core(
        A, inlier_scale_bits, outlier_scale_bits, inlier_elem_format,
        outlier_elem_format, shared_exp_method, std_dev, axes, block_size,
        round, flush_fp32_subnorms, **_GPTQ_STATS, want_num_outliers=True,
        want_decisions=True, max_outliers_per_block=max_outliers_per_block)


def quantize_mx_outlier_v1(A, inlier_scale_bits: int,
                           outlier_scale_bits: int, inlier_elem_format,
                           outlier_elem_format,
                           shared_exp_method: str = "max",
                           std_dev: float = 2, axes=None,
                           block_size: int = 0, round: str = "nearest",
                           flush_fp32_subnorms: bool = False):
    """RTN outlier quantizer (no counts)."""
    if inlier_elem_format is None:
        return A
    out, _ = _outlier_quantize_core(
        A, inlier_scale_bits, outlier_scale_bits, inlier_elem_format,
        outlier_elem_format, shared_exp_method, std_dev, axes, block_size,
        round, flush_fp32_subnorms, **_GPTQ_STATS, want_num_outliers=False)
    return out


def quantize_mx_outlier_op_v1(A, inlier_scale_bits: int,
                              outlier_scale_bits: int, inlier_elem_format,
                              outlier_elem_format,
                              shared_exp_method: str = "max",
                              std_dev: float = 5, axes=None,
                              block_size: int = 0, round: str = "nearest",
                              flush_fp32_subnorms: bool = False):
    """nn-layer outlier quantizer (``mx_ops.py:210-330``)."""
    if inlier_elem_format is None:
        return A
    out, _ = _outlier_quantize_core(
        A, inlier_scale_bits, outlier_scale_bits, inlier_elem_format,
        outlier_elem_format, shared_exp_method, std_dev, axes, block_size,
        round, flush_fp32_subnorms, stats_use_abs=False, stats_unbiased=True,
        stats_on_block_axis=True, underflow_floor_20=False,
        want_num_outliers=False)
    return out


def quantize_mx_outlier_op(A, mx_specs, inlier_elem_format=None,
                           outlier_elem_format=None,
                           block_size: Optional[int] = None, axes=None,
                           round: str = "nearest"):
    """Spec-driven wrapper (reference: ``mx_ops.py:492-533``)."""
    if inlier_elem_format is None or outlier_elem_format is None:
        return A
    if block_size is None:
        block_size = mx_specs["block_size"]
    scale_bits = mx_specs["scale_bits"] if mx_specs["scale_bits"] != 0 else 4
    return quantize_mx_outlier_op_v1(
        A, scale_bits, scale_bits, inlier_elem_format, outlier_elem_format,
        block_size=block_size, axes=axes, round=round,
        shared_exp_method=mx_specs["shared_exp_method"],
        flush_fp32_subnorms=mx_specs["mx_flush_fp32_subnorms"])
