"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, on first use,
into ``_build/lib<name>-<hash>.so`` (the hash is of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source never loads a
stale library):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

``-Xptxas -v`` output (registers, shared memory, spills per kernel) is kept
beside the library as ``<name>-<hash>.ptxas.txt``. Nothing here runs at
import time: this module imports on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("dequant_gemv", "dequant_matmul", "quant_attention", "nb_matmul",
           "outlier_matmul", "dequant_gemv_s8", "mx_quant", "exp_prefill",
           "exp_gemv", "gemm_any", "gemv_any")
# the sources whose nvcc sets the build's wall time (quant_attention.cu
# ~90-150 s, dequant_matmul.cu ~70-100 s on the H100 machine's 8 cores);
# the others start at a lower priority, so that ten processes on eight
# cores slow these two the least
CRITICAL_SOURCES = ("quant_attention", "dequant_matmul")

_loaded: Dict[str, ctypes.CDLL] = {}
# the anonymous namespace of a kernel's mangled name, e.g.
# "_ZN47_GLOBAL__N__cb217a5d_14_exp_prefill_cu_e541f9617" before "gemm_rx..."
_ANON = re.compile(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str):
    """Start nvcc for ``name`` into a temporary file; None if built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    nice = shutil.which("nice")
    lower = [nice, "-n", "10"] if nice and name not in CRITICAL_SOURCES \
        else []
    proc = subprocess.Popen(
        lower + [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                 str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".ptxas.txt").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)            # atomic: concurrent builds agree


def build_all(names=SOURCES) -> float:
    """Compile every source that is not built yet, all nvcc processes at
    once (those of CRITICAL_SOURCES at the caller's priority, the others
    under ``nice -n 10`` where the machine has it); returns the wall
    seconds taken."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return time.perf_counter() - t0


def ptxas_report(names=SOURCES) -> List[str]:
    """One line per kernel of each built library: ``<source> <kernel>:
    <registers>; <spills>`` from its ``-Xptxas -v`` log (the kernel's
    mangled name, without its anonymous-namespace prefix)."""
    lines = []
    for n in names:
        log = _lib_path(n).with_suffix(".ptxas.txt")
        if not log.exists():
            continue
        kernel = spill = ""
        for ln in log.read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                kernel, spill = _ANON.sub("", m.group(1)), ""
            elif "spill" in ln:
                spill = ln.strip()
            elif "registers" in ln:
                lines.append(f"{n} {kernel}: {ln.split(':', 1)[-1].strip()}"
                             f"; {spill}")
    return lines


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def entry(source: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, which returns a
    ``cudaError_t`` as int; typed with ``argtypes`` on first use."""
    fn = getattr(load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise when a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
