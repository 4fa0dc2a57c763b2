"""Setup, timing and records shared by the experiment scripts: the
prefill-GEMM ones here, the decode-GEMV ones (``_gemv``) with setups of
their own.

The setup is that of ``scripts/exp_prefill_*.py``: the Llama-3-8B gate_up
shape (K 4096, N 28672) at M = 1024 (8 x 128 tokens), block 32, W ~ N(0,
0.02) and x ~ N(0, 1) from seed 0 (here a ``torch.Generator`` on the
device, so the weights are made where they are used). W is held three ways:
bf16 (``wd``), MX-FP6 emi8 (``emi8``) and MX int8 in its container
(``int8``), the packed two in the serving layout.

Each arm is called once and held to the plain version of its weight (the
plain output is computed once per weight), then, on a card, timed with CUDA
events over copies of its weight that together pass the 50 MB L2 cache four
times, so each call streams the weight from HBM (x, 8 MB, stays in L2 for
every arm alike). The card's clocks drift under sustained load, so every
arm is timed in three passes over all arms, forwards and backwards, and
the median is kept. ``torch.matmul`` on the bf16 weight (arm ``dense``) is the
yardstick, as the XLA dot was on the TPU; ``inkernel`` is the shipped GEMM.
An arm may name its own plain version (``Arm.plain``, a key of
``Setup.plains``), as the GEMV scripts' ablations and decode variants do.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import resolve_device
from ..ops import packing as pk
from ..ops.cuda import dequant_matmul as dm
from ..ops.cuda import exp_prefill as ep
from ..utils.observability import card_line, copies_for, cuda_ms

K, N, M = 4096, 28672, 1024       # gate_up of Llama-3-8B; 8 x 128 tokens
BLOCK = 32
SEED = 0
BF16_FLOPS = 989e12               # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
ROUNDS = 3                        # timing passes over all arms


def card_name(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card; "cpu" off it."""
    return card_line(device.index or 0) if device.type == "cuda" else "cpu"


def nbytes(w) -> int:
    if isinstance(w, torch.Tensor):
        return w.numel() * w.element_size()
    return w.nbytes()


def code_bytes(w) -> int:
    """The bytes of a weight's codes (a packed weight's exponents and slots
    left out, except for the compact NB transport, whose streams all count),
    for a rate in GB/s of codes as the TPU scripts report it."""
    if isinstance(w, torch.Tensor):
        return nbytes(w)
    if isinstance(w, pk.PackedOutlierNB):
        return w.nbytes()
    return w.codes.numel() * w.codes.element_size()


def _clone(w):
    if isinstance(w, torch.Tensor):
        return w.clone()
    return dataclasses.replace(w, **{
        f.name: getattr(w, f.name).clone() for f in dataclasses.fields(w)
        if isinstance(getattr(w, f.name), torch.Tensor)})


def with_copies(weights: Dict[str, list], dev: torch.device) -> None:
    """On a card, add to each weight's list the copies that together pass
    the L2 cache four times (``copies_for``)."""
    if dev.type == "cuda":
        for ws in weights.values():
            ws += [_clone(ws[0]) for _ in range(copies_for(nbytes(ws[0]))
                                                - 1)]


@dataclasses.dataclass
class Setup:
    """x and the weights of one run, with each weight's rotated copies (the
    first is the weight) and its plain outputs, computed once. ``plains``
    maps a plain version's key to (weight kind, fn(x, w)); a key that it
    lacks is a weight kind, whose plain version is ``ep.reference``."""

    device: torch.device
    card: str
    x: torch.Tensor                       # (M, K) bf16
    weights: Dict[str, list]              # "wd" (K, N) bf16, ... -> copies
    block: int = BLOCK
    plains: Dict[str, Tuple[str, Callable]] = dataclasses.field(
        default_factory=dict)
    _plain: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    _plain_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def shape(self):
        """(M, K, N)."""
        return (self.x.shape[0], self.x.shape[1],
                self.weights["wd"][0].shape[1])

    def _plain_fn(self, key: str):
        kind, fn = self.plains.get(key, (key, ep.reference))
        return fn, self.weights[kind][0]

    def plain(self, key: str) -> torch.Tensor:
        """The f32 output of plain version ``key``."""
        if key not in self._plain:
            fn, w = self._plain_fn(key)
            self._plain[key] = fn(self.x, w).float()
        return self._plain[key]

    def plain_ms(self, key: str) -> float:
        if key not in self._plain_ms:
            fn, w = self._plain_fn(key)
            self._plain_ms[key] = cuda_ms(lambda i: fn(self.x, w), 1,
                                          target_ms=20.0)
        return self._plain_ms[key]


def make_setup(device="cuda", *, K: int = K, N: int = N,
               M: int = M) -> Setup:
    """The scripts' operands, made on ``device`` (the card unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    W = torch.randn((K, N), generator=gen, device=dev) * 0.02
    weights = {
        "wd": [W.to(torch.bfloat16)],
        "emi8": [pk.to_serving_layout(pk.pack_mx(
            W, 8, "fp6_e3m2", BLOCK, axis=0, transport="emi8"))],
        "int8": [pk.to_serving_layout(pk.pack_mx(W, 8, "int8", BLOCK,
                                                 axis=0))]}
    del W
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    with_copies(weights, dev)
    return Setup(device=dev, card=card_name(dev), x=x, weights=weights)


@dataclasses.dataclass
class Arm:
    """One line of a script: ``call(x, w)`` on weight ``weight``; held to
    plain version ``plain`` (default: that weight's) when ``compared``.
    ``reads(w)`` is the bytes of the weight that the arm's function needs,
    for its bound and its GB/s (default: all of them)."""

    name: str
    kernel: str                   # launch-count key, or the library call
    weight: str
    call: Callable[[torch.Tensor, object], torch.Tensor]
    compared: bool = True
    tiles: Optional[dict] = None
    out_dtype: torch.dtype = torch.float32
    plain: Optional[str] = None
    reads: Optional[Callable[[object], int]] = None

    @property
    def plain_key(self) -> str:
        return self.plain or self.weight


def dense_arm() -> Arm:
    """``torch.matmul`` on the bf16 weight: the yardstick."""
    return Arm("dense", "torch.matmul", "wd", torch.matmul, compared=False,
               out_dtype=torch.bfloat16)


def shipped_arm(name: str, weight: str = "emi8") -> Arm:
    """The shipped in-kernel-decode GEMM (``dm.dequant_gemm``)."""
    key = {"emi8": "dequant_matmul_emi8", "int8": "dequant_matmul_native"}
    return Arm(name, key[weight], weight, dm.dequant_gemm)


def bound_ms(nbytes_moved: int, M: int, N: int, K: int):
    """(bound ms, bound_by): the operands' bytes over HBM against 2MNK over
    the bf16 peak, the larger."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * N * K / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def run(script: str, arms: List[Arm], setup: Setup) -> List[dict]:
    """One record per arm. Each arm is called once and its output held to
    the plain version; then, on a card, every arm is timed in ``ROUNDS``
    passes over all arms, in turn forwards and backwards, and its ms is the
    median (``ms_min``, ``ms_max``: the spread). ``vs_dense`` and
    ``library_ms`` are the ``dense`` arm's median from the same passes;
    ``codes_GBps`` the weight's code bytes (or the arm's ``reads``) over the
    median."""
    M_, K_, N_ = setup.shape
    recs = []
    for arm in arms:
        y = arm.call(setup.x, setup.weights[arm.weight][0])
        if tuple(y.shape) != (M_, N_) or y.dtype != arm.out_dtype:
            raise AssertionError(f"{script} {arm.name}: {tuple(y.shape)} "
                                 f"{y.dtype}")
        err = rel = None
        if arm.compared:
            # against the f32 plain output: a bf16 output's own rounding
            # (at most 2^-8 of max |plain|) counts in its error
            ref = setup.plain(arm.plain_key)
            err = (y.float() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            del ref
        del y
        out = "bf16" if arm.out_dtype == torch.bfloat16 else "f32"
        w = setup.weights[arm.weight][0]
        bound, by = bound_ms(
            setup.x.numel() * 2 + (arm.reads or nbytes)(w)
            + M_ * N_ * (2 if out == "bf16" else 4), M_, N_, K_)
        recs.append(dict(
            script=script, arm=arm.name, kernel=arm.kernel, tiles=arm.tiles,
            out=out, M=M_, K=K_, N=N_, block=setup.block, ms=None,
            ms_min=None, ms_max=None, codes_GBps=None, bound_ms=bound,
            bound_by=by, bound_share=None, vs_dense=None, rel_err=rel,
            max_abs_err=err, plain_ms=None, library_ms=None, card=setup.card,
            device=str(setup.device)))
    if setup.device.type != "cuda":
        return recs
    times = {arm.name: [] for arm in arms}
    for r in range(ROUNDS):
        for arm in (arms if r % 2 == 0 else arms[::-1]):
            ws = setup.weights[arm.weight]
            times[arm.name].append(cuda_ms(
                lambda i: arm.call(setup.x, ws[i]), len(ws), target_ms=20.0))
    dense_ms = statistics.median(times["dense"])
    for arm, rec in zip(arms, recs):
        ms = statistics.median(times[arm.name])
        rec.update(ms=ms, ms_min=min(times[arm.name]),
                   ms_max=max(times[arm.name]),
                   codes_GBps=(arm.reads or code_bytes)(
                       setup.weights[arm.weight][0]) / ms / 1e6,
                   bound_share=rec["bound_ms"] / ms, vs_dense=ms / dense_ms,
                   library_ms=dense_ms,
                   plain_ms=(setup.plain_ms(arm.plain_key) if arm.compared
                             else None))
    return recs


def parser(doc: str) -> argparse.ArgumentParser:
    return argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        epilog="Runs on the CUDA card; prints one JSON line per arm.")


def main(script: str, arms: Callable[[], List[Arm]], *, device="cuda",
         K: int = K, N: int = N, M: int = M,
         setup: Optional[Setup] = None,
         make: Callable[..., Setup] = make_setup) -> List[dict]:
    """Run ``arms()`` on ``setup`` (made here by ``make`` when not given)
    and print one JSON line per arm; returns the records."""
    setup = setup if setup is not None else make(device, K=K, N=N, M=M)
    recs = run(script, arms(), setup)
    for r in recs:
        print(json.dumps(r), flush=True)
    return recs
