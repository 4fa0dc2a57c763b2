"""Counters, gauges and timers; CUDA-event kernel timing.

Counterpart of ``Metrics`` and ``metrics`` in
``microscopiq_tpu/utils/observability.py``. Profiler traces and per-kernel
device-time stats are ROADMAP queue 1 item 8. :func:`cuda_ms`,
:func:`copies_for` and :func:`card_line` time kernels on the card for
``chip_smoke.py`` and the experiment scripts.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator

L2_BYTES = 50 * 2 ** 20           # the H100's L2 cache


class Metrics:
    """Counters, gauges and timers."""

    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}
        self.timers: Dict[str, list] = defaultdict(list)

    def count(self, name: str, n: float = 1.0):
        self.counters[name] += n

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        """Host wall time of the block; the caller synchronizes the device
        inside the block if device work must be counted."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name].append(time.perf_counter() - t0)

    def snapshot(self) -> dict:
        out = {"counters": dict(self.counters), "gauges": dict(self.gauges)}
        out["timers"] = {
            k: {"n": len(v), "total_s": sum(v), "min_s": min(v),
                "mean_s": sum(v) / len(v)}
            for k, v in self.timers.items() if v}
        return out


metrics = Metrics()          # default process-wide registry


def cuda_ms(fn: Callable[[int], object], n_args: int,
            target_ms: float = 40.0) -> float:
    """Mean ms per call of fn(i), i cycling over n_args operand copies,
    between CUDA events, after a warm-up call; as many calls as fill about
    ``target_ms`` (3 to 200)."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(1 % n_args)
    torch.cuda.synchronize()
    est = max((time.perf_counter() - t0) * 1e3, 1e-3)
    iters = int(min(200, max(3, target_ms / est)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    """Operand copies whose total exceeds the L2 cache four times over, so
    that each timed call streams its operand from HBM (at most 16)."""
    return int(min(16, max(1, -(-4 * L2_BYTES // nbytes))))


def card_line(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
