"""Offline profilers of weights and formats.

Counterpart of ``microscopiq_tpu/utils/profiling.py``: per-layer weight
outlier statistics under a k-sigma rule (with the adjacent-outlier rate
that motivated the SCOPE NoC design), and the MSE of element-wise or MX
block quantization of a synthetic N(mean, std) tensor per format.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from .. import resolve_device
from ..ops.elemwise import quantize_elemwise
from ..ops.mx import quantize_mx


def analyze_outliers(W, std_dev: float = 2.5,
                     block_size: int = 16) -> Dict[str, float]:
    """Outlier share and adjacency of a weight matrix: the fraction of
    outliers (|w| above mean + std_dev * std of |W|), of blocks holding
    one, the most and the mean outliers a block, and the rate of two
    outliers in consecutive positions."""
    a = torch.abs(torch.as_tensor(W))
    mean = a.mean()
    std = a.std(correction=0)
    mask = (a > mean + std_dev * std).to(torch.float32)
    flat = mask.reshape(-1)
    adj = (flat[1:] * flat[:-1]).sum() / torch.clamp(flat.sum(), min=1)
    n = (flat.shape[0] // block_size) * block_size
    per_block = flat[:n].reshape(-1, block_size).sum(1)
    return {
        "outlier_fraction": float(mask.mean()),
        "blocks_with_outliers": float((per_block > 0).to(
            torch.float32).mean()),
        "max_outliers_per_block": float(per_block.max()),
        "mean_outliers_per_block": float(per_block.mean()),
        "adjacent_outlier_rate": float(adj),
    }


def profile_model_outliers(params, std_dev: float = 2.5,
                           block_size: int = 16) -> Dict[str, Dict]:
    """:func:`analyze_outliers` of every linear kernel of a weight tree,
    keyed by its "/"-joined path."""
    from ..nn.mapping import find_linear_params

    return {"/".join(path): analyze_outliers(w, std_dev, block_size)
            for path, w in find_linear_params(params, skip=()).items()}


def format_mse_profile(formats: Iterable[str] = ("int8", "int4", "fp8_e4m3",
                                                 "fp6_e3m2", "fp6_e2m3",
                                                 "fp4_e2m1"),
                       mean: float = 0.0, std: float = 1.0,
                       n: int = 1 << 16, seed: int = 0,
                       block_size: int = 0, scale_bits: int = 8,
                       device="cuda") -> Dict[str, float]:
    """MSE of quantizing ``n`` seeded N(mean, std) values per format,
    element-wise (saturating) or, with ``block_size``, MX blocks."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((rng.standard_normal(n) * std + mean).astype(
        np.float32), device=resolve_device(device))
    out = {}
    for fmt in formats:
        if block_size > 0:
            q = quantize_mx(x[None, :], scale_bits, fmt, axes=[-1],
                            block_size=block_size)[0]
        else:
            q = quantize_elemwise(x, fmt, saturate_normals=True)
        out[fmt] = float(torch.mean((q - x) ** 2))
    return out
