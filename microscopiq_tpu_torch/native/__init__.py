"""Host-side C++ MX codec, called through ctypes.

Counterpart of ``microscopiq_tpu/native``, with its own copy of
``mx_codec.cpp``: multithreaded packing of a float32 matrix along its last
axis into container bytes and int8 shared exponents, bit-identical to
:func:`microscopiq_tpu_torch.ops.packing.pack_mx` with ``exact_scale=True``,
and the inverse. The library is built with ``g++`` at first use into
``_build/`` beside this file (git-ignored), named by a hash of the source,
the flags and the host (``-march=native`` code runs only where it was
built), so that an edit or another machine rebuilds it; a build writes a
temporary file and renames it, so concurrent builds do not collide.
Where the JAX module returns ``None`` from a failed build, :func:`get_lib`
raises with the compiler's output; :func:`available` says whether it
builds. The wrappers take numpy arrays or CPU tensors and return
the same kind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mx_codec.cpp")
_BUILD = os.path.join(_DIR, "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_FMT_IDS = {"int8": 0, "int4": 1, "int2": 2, "fp8_e4m3": 3, "fp8_e5m2": 4,
            "fp6_e3m2": 5, "fp6_e2m3": 6, "fp4_e2m1": 7, "fp4": 7}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_f32p = ctypes.POINTER(ctypes.c_float)


def lib_path() -> str:
    host = " ".join((*_FLAGS, os.uname().nodename, os.uname().machine))
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + host.encode())
    return os.path.join(_BUILD, f"libmxcodec-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC, "-lpthread"],
                             capture_output=True, text=True, timeout=300)
        if out.returncode:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{out.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL:
    """The codec library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.msq_pack_mx.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _u8p, _i8p, ctypes.c_int]
        lib.msq_dequant_mx.argtypes = [
            _u8p, _i8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, _f32p, ctypes.c_int]
        lib.msq_pack_fp6_transport.argtypes = [_u8p, ctypes.c_int64, _u8p]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False


def _threads(n: int) -> int:
    return n if n > 0 else min(os.cpu_count() or 1, 16)


def _numpy(a, dtype) -> np.ndarray:
    """A CPU tensor or array as a contiguous array of ``dtype``; one-byte
    tensors (float8 codes too) are taken by their bits."""
    if hasattr(a, "detach"):
        import torch

        if a.device.type != "cpu":
            raise ValueError(f"the host codec takes CPU tensors, got "
                             f"{a.device}")
        if a.element_size() == 1 and dtype in (np.uint8, np.int8):
            a = a.view(torch.uint8 if dtype == np.uint8 else torch.int8)
        a = a.detach().numpy()
    return np.ascontiguousarray(a, dtype)


def _like(a, *outs):
    if hasattr(a, "detach"):
        import torch

        outs = tuple(torch.from_numpy(o) for o in outs)
    return outs if len(outs) > 1 else outs[0]


def pack_mx_native(W, scale_bits: int, elem_format: str, block_size: int,
                   nthreads: int = 0):
    """Pack a (rows, cols) float32 matrix along its last axis: (codes uint8
    (rows, cols), scales int8 (rows, cols // block_size)). fp containers
    come back as raw bytes (view them as ``float8_e4m3fn``, or
    ``float8_e5m2`` for fp8_e5m2)."""
    lib = get_lib()
    w = _numpy(W, np.float32)
    rows, cols = w.shape
    if cols % block_size:
        raise ValueError(f"cols {cols} is not a multiple of block "
                         f"{block_size}")
    codes = np.empty((rows, cols), np.uint8)
    scales = np.empty((rows, cols // block_size), np.int8)
    lib.msq_pack_mx(w.ctypes.data_as(_f32p), rows, cols, block_size,
                    scale_bits, _FMT_IDS[elem_format],
                    codes.ctypes.data_as(_u8p), scales.ctypes.data_as(_i8p),
                    _threads(nthreads))
    return _like(W, codes, scales)


def dequant_mx_native(codes, scales, elem_format: str, block_size: int,
                      nthreads: int = 0):
    """Inverse of :func:`pack_mx_native`: float32 (rows, cols)."""
    lib = get_lib()
    c = _numpy(codes, np.uint8)
    s = _numpy(scales, np.int8)
    rows, cols = c.shape
    out = np.empty((rows, cols), np.float32)
    lib.msq_dequant_mx(c.ctypes.data_as(_u8p), s.ctypes.data_as(_i8p), rows,
                       cols, block_size, _FMT_IDS[elem_format],
                       out.ctypes.data_as(_f32p), _threads(nthreads))
    return _like(codes, out)


def pack_fp6_transport_native(codes6):
    """Raw 6-bit codes, four to three bytes, in the layout of
    :func:`microscopiq_tpu_torch.ops.packing.pack_fp6`."""
    lib = get_lib()
    c = _numpy(codes6, np.uint8).reshape(-1)
    if c.size % 4:
        raise ValueError("the fp6 transport packs codes four at a time")
    out = np.empty(c.size // 4 * 3, np.uint8)
    lib.msq_pack_fp6_transport(c.ctypes.data_as(_u8p), c.size,
                               out.ctypes.data_as(_u8p))
    return _like(codes6, out)
