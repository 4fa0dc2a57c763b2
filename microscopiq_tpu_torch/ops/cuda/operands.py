"""Operand checks shared by the kernel wrappers of ``ops/cuda``.

Each check raises ``ValueError`` for operands its kernel does not take;
:func:`on_cpu` tells a wrapper to use its plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import packing as pk
from . import dequant_matmul as dm

OUT_DTYPES = (torch.bfloat16, torch.float32)


def stream(x: torch.Tensor) -> int:
    """The current CUDA stream of x's device, as a launch argument."""
    return torch.cuda.current_stream(x.device).cuda_stream


def compiled(what: str, cfg, table) -> None:
    """ValueError unless configuration ``cfg`` of ``what`` is in the
    compiled ``table``."""
    if cfg not in table:
        raise ValueError(f"{what}: {cfg} was not compiled; the kernel takes "
                         f"{list(table)}")


def x2d(x: torch.Tensor, K: int) -> Tuple[int, int]:
    """(M, K) of a 2-D x whose K matches the weight's."""
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x must be (M, {K}), got {tuple(x.shape)}")
    return x.shape[0], K


def serving_packed(w: pk.PackedMX, decodes
                   ) -> Tuple[pk.PackedMX, str, int, int]:
    """(serving-layout weight, decode, fold, mw) of a (K, N) weight whose
    K is a whole number of blocks and whose decode is in ``decodes``."""
    decode, fold, mw, _ = dm.sad_decode_params(w)
    if decode not in decodes or w.axis != 0:
        raise ValueError(f"the kernel takes (K, N) weights blocked on axis 0 "
                         f"in {decodes}, got {w.transport} ({decode}) on "
                         f"axis {w.axis}")
    ww = pk.to_serving_layout(w)
    NB, rows, N = ww.codes.shape
    if rows != ww.block_size or ww.scale_exp.shape != (NB, N):
        raise ValueError(f"codes {tuple(ww.codes.shape)} and exponents "
                         f"{tuple(ww.scale_exp.shape)} are not a one-byte "
                         f"serving layout of block {ww.block_size}")
    if w.orig_dim != NB * ww.block_size:
        raise ValueError(f"K = {w.orig_dim} is not a multiple of the block "
                         f"{ww.block_size}")
    return ww, decode, fold, mw


def on_card(x: torch.Tensor, *ts: torch.Tensor) -> None:
    """ValueError unless x and the weight tensors ``ts`` lie on one CUDA
    device, the weight's contiguous and 16-byte aligned."""
    if not x.is_cuda or any(t.device != x.device for t in ts):
        raise ValueError("x and the weight must be on one CUDA device")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError("weight tensors must be contiguous and 16-byte "
                         "aligned")


def on_cpu(x: torch.Tensor, tensors) -> bool:
    """True when x and the weight lie on the CPU (the twin's case); raises
    when they lie on different devices."""
    if any(t.device != x.device for t in tensors):
        raise ValueError("x and the packed weight must be on one device")
    return x.device.type == "cpu"


def nb_tensors(w: pk.PackedOutlierNB):
    """The four streams of the compact NB transport."""
    return (w.codes, w.scale_exp, w.out_byte, w.out_scale_exp)


def nb_operands(x: torch.Tensor, w: pk.PackedOutlierNB, out_dtype
                ) -> torch.Tensor:
    """x as a contiguous (M, K) bf16 CUDA tensor, after checking that the
    compact NB weight is one the NB kernels decode."""
    if not x.is_cuda:
        raise ValueError("the NB kernel takes CUDA tensors")
    if w.block_size != 16:
        raise ValueError("the compact transport is specified for block 16")
    if w.elem_format != "int2" or w.outlier_format not in ("fp4",
                                                           "fp4_e2m1"):
        raise ValueError(f"the NB kernel decodes int2 + fp4, got "
                         f"{w.elem_format} + {w.outlier_format}")
    tensors = nb_tensors(w)
    if any(t.dtype != torch.int8 for t in tensors):
        raise ValueError("NB codes, exponents and slot bytes must be int8")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("packed weight must be contiguous")
    Np4, K = w.codes.shape
    NB = Np4 // 4
    if (w.scale_exp.shape != (NB, K) or w.out_scale_exp.shape != (NB, K)
            or w.out_byte.shape[1:] != (NB, K) or 4 * Np4 < w.orig_n
            or K != w.orig_k):
        raise ValueError(f"NB operands disagree: codes {tuple(w.codes.shape)}"
                         f", scale_exp {tuple(w.scale_exp.shape)}, out_byte "
                         f"{tuple(w.out_byte.shape)}, orig ({w.orig_n}, "
                         f"{w.orig_k})")
    if x.shape[-1] != K:
        raise ValueError(f"x has K={x.shape[-1]}, weight has K={K}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not in {OUT_DTYPES}")
    return x.reshape(-1, K).to(torch.bfloat16).contiguous()
