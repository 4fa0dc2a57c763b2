"""MX block quantizer on the last axis: the CUDA kernel ``csrc/mx_quant.cu``,
its wrapper and its plain PyTorch version.

Counterpart of ``microscopiq_tpu/ops/pallas/mx_quant.py::quantize_mx_pallas``
(kernel ``_quantize_block_kernel``): float32 in, container codes and int8
shared exponents out, with the exact power-of-two scale (no +1e-6). Its
plain version is ``pack_mx(..., exact_scale=True)`` on the last axis, and
the kernel is bit-exact to it (``chip_smoke.py`` and
``tests/test_torch_kernels_gpu.py`` hold it so on the card).

A tensor on the CPU goes to the plain version; one on a CUDA device goes to
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...formats import get_format_params
from .. import packing as pk
from . import build

# container dtype -> the Container id of csrc/mx_quant.cu
_CONTAINERS = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2,
               torch.float16: 3, torch.bfloat16: 4}

launch_counts = {"quantize_mx": 0}

_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float]
         + [ctypes.c_void_p])


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def quantize_mx_reference(x: torch.Tensor, scale_bits: int, elem_format: str,
                          block_size: int) -> pk.PackedMX:
    """Plain version: ``pack_mx`` with the exact scale on the last axis,
    returned as the kernel returns it (``axis=-1``)."""
    p = pk.pack_mx(x.to(torch.float32), scale_bits, elem_format, block_size,
                   exact_scale=True)
    p.axis = -1
    return p


def block_size_ok(block_size: int) -> bool:
    """Block sizes the kernel takes: a divisor of 32, or a multiple of 32
    up to 256 (whole blocks per warp, or one block per warp)."""
    return (block_size <= 32 and 32 % block_size == 0) or (
        block_size % 32 == 0 and block_size <= 256)


def quantize_mx_block(x: torch.Tensor, scale_bits: int, elem_format: str,
                      block_size: int) -> pk.PackedMX:
    """Block-quantize the last axis of x into packed storage: codes (...,
    Kp) in the format's container (K padded to the block size with zeros,
    kept), scale_exp (..., Kp / B) int8, ``orig_dim = K``; exact
    power-of-two scale, as the TPU ``quantize_mx_pallas``."""
    if x.device.type == "cpu":
        return quantize_mx_reference(x, scale_bits, elem_format, block_size)
    if not block_size_ok(block_size):
        raise ValueError(f"block size {block_size} is neither a divisor of "
                         "32 nor a multiple of 32 up to 256")
    if not x.is_cuda:
        raise ValueError(f"x lies on {x.device}, neither the CPU nor a "
                         "CUDA device")
    if not 1 <= scale_bits <= 8:
        raise ValueError(f"scale_bits {scale_bits} does not fit int8")
    ebits, mbits, emax, max_norm, _ = get_format_params(elem_format)
    cdt = pk.container_dtype(elem_format)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).to(torch.float32).contiguous()
    M = x2.shape[0]
    Kp = -(-K // block_size) * block_size
    codes = torch.empty((M, Kp), dtype=cdt, device=x.device)
    se = torch.empty((M, Kp // block_size), dtype=torch.int8,
                     device=x.device)
    if M and Kp:
        fn = build.entry("mx_quant", "quantize_mx_block", _ARGS)
        err = fn(x2.data_ptr(), codes.data_ptr(), se.data_ptr(), M, K, Kp,
                 block_size, _CONTAINERS[cdt], scale_bits, ebits, mbits, emax,
                 max_norm, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "quantize_mx")
        launch_counts["quantize_mx"] += 1
    return pk.PackedMX(codes=codes.reshape(lead + (Kp,)),
                       scale_exp=se.reshape(lead + (Kp // block_size,)),
                       elem_format=elem_format, block_size=block_size,
                       scale_bits=scale_bits, orig_dim=K)
