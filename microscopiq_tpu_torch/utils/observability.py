"""Counters, gauges and timers; profiler traces and their device-time
readers; CUDA-event kernel timing.

Counterpart of ``microscopiq_tpu/utils/observability.py``:
:class:`Metrics` (with ``dump``), :func:`trace`, :func:`device_kernel_stats`,
:func:`achieved_bandwidth`, :func:`assert_bandwidth`,
:func:`decode_token_stats` and :func:`device_busy_us` (the union of device
intervals). :func:`trace` runs ``torch.profiler`` (CUDA activity on a card)
and writes a gzipped Chrome trace (``*.trace.json.gz``) that the same
readers parse as JAX's. On the H100 machines a profiler window loses the
kernel records of its first N launches, N growing with the process's age,
and sometimes its last ones: :func:`trace` pads its window on each side
with ``torch.cuda._sleep`` spin kernels, which the readers leave out, and
:func:`device_kernel_stats` raises on a window that holds fewer kernel
events than the caller's launch count. :func:`cuda_ms`, :func:`copies_for`
and :func:`card_line` time kernels on the card for ``chip_smoke.py`` and
the experiment scripts.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional, Tuple

L2_BYTES = 50 * 2 ** 20           # the H100's L2 cache
HBM_BYTES_PER_S = 3.35e12         # the H100 SXM's HBM3, data sheet
PROFILE_FILLER = 4096             # spin kernels on each side of a trace
FILLER_KERNEL = "spin_kernel"     # torch.cuda._sleep's kernel


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

    def dump(self, path: str, **extra) -> dict:
        """Append one JSON line (snapshot, ``extra`` fields, timestamp)."""
        rec = {"ts": time.time(), **self.snapshot(), **extra}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


metrics = Metrics()          # default process-wide registry


# ---------------------------------------------------------------------------
# Profiler traces
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write ``log_dir/<host>.<pid>.<ns>.trace.json.gz``;
    yields ``log_dir``. On a card the window opens and closes with
    ``PROFILE_FILLER`` one-cycle spin kernels, which take the records that
    the profiler loses at a window's ends; the readers drop them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)

    def spin():
        for _ in range(PROFILE_FILLER):
            torch.cuda._sleep(1)

    with profile(activities=acts) as prof:
        if cuda:
            spin()
        yield log_dir
        if cuda:
            spin()
            torch.cuda.synchronize()
    name = f"{os.uname().nodename}.{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, name + ".trace.json.gz"))


_SUFFIX = re.compile(r"\.\d+$")
# Process rows of device events. A TPU trace names them "/device:TPU:0" or
# "XLA Ops" (process_name). torch.profiler's Chrome trace (torch 2.11, H100)
# puts the kernels, memcpys and memsets of card i on pid i, whose
# process_name is the program's ("python") and whose process_labels is
# "GPU i"; the host's ops sit on the process's pid, labelled "CPU". A row's
# name here is its process_name and its labels, so both kinds match.
_DEVICE_ROWS = ("/device:", "TPU", "XLA Ops", "GPU")


def _iter_trace_events(trace_dir: str):
    """(process row name, event) of every complete ("X") event with a
    duration in the traces under ``trace_dir``."""
    for path in glob.glob(os.path.join(
            trace_dir, "**", "*.trace.json.gz"), recursive=True):
        with gzip.open(path, "rt") as f:
            doc = json.load(f)
        pid_names = {}
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "M" and ev.get("name") in ("process_name",
                                                          "process_labels"):
                args = ev.get("args", {})
                part = args.get("name", args.get("labels", ""))
                pid = ev.get("pid")
                pid_names[pid] = f"{pid_names.get(pid, '')} {part}".strip()
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") == "X" and "dur" in ev:
                yield pid_names.get(ev.get("pid"), ""), ev


def _device_events(trace_dir: str):
    """Device-row events other than the filler."""
    for proc, ev in _iter_trace_events(trace_dir):
        if (any(t in proc for t in _DEVICE_ROWS)
                and FILLER_KERNEL not in ev.get("name", "")):
            yield ev


def device_kernel_stats(trace_dir: str, device_only: bool = True,
                        min_events: Optional[int] = None
                        ) -> Dict[str, dict]:
    """{name: {count, total_us, mean_us}} of a trace's events, the
    ``.NNN`` launch suffix stripped so that replays of a kernel aggregate;
    ``device_only`` keeps the device rows (``_DEVICE_ROWS``). The filler of
    :func:`trace` is left out. With ``min_events`` (the kernel wrappers'
    launch count over the window), a window that holds fewer events raises
    AssertionError naming both counts: its stats would read low."""
    agg: Dict[str, dict] = {}
    events = (_device_events(trace_dir) if device_only else
              (ev for _, ev in _iter_trace_events(trace_dir)
               if FILLER_KERNEL not in ev.get("name", "")))
    for ev in events:
        name = _SUFFIX.sub("", ev.get("name", ""))
        a = agg.setdefault(name, {"count": 0, "total_us": 0.0})
        a["count"] += 1
        a["total_us"] += float(ev["dur"])
    for a in agg.values():
        a["mean_us"] = a["total_us"] / a["count"]
    got = sum(a["count"] for a in agg.values())
    if min_events is not None and got < min_events:
        raise AssertionError(
            f"the trace in {trace_dir} holds {got} events, the kernel "
            f"wrappers launched {min_events}: the window lost records")
    return agg


def filler_kept(trace_dir: str) -> Tuple[int, int]:
    """(filler kernels before the first other device event, after the
    last): both above 0 show that the window kept its ends."""
    spins, other = [], []
    for proc, ev in _iter_trace_events(trace_dir):
        if any(t in proc for t in _DEVICE_ROWS):
            ts = float(ev.get("ts", 0.0))
            (spins if FILLER_KERNEL in ev.get("name", "") else other).append(
                ts)
    if not other:
        return len(spins), 0
    return (sum(t < min(other) for t in spins),
            sum(t > max(other) for t in spins))


def achieved_bandwidth(bytes_moved: int, seconds: float) -> float:
    """GB/s actually achieved for a kernel that moves ``bytes_moved``."""
    return bytes_moved / seconds / 1e9


def assert_bandwidth(bytes_moved: int, seconds: float,
                     target_gbps: float = HBM_BYTES_PER_S / 1e9,
                     fraction: float = 0.5, name: str = "kernel") -> float:
    """Raise if a kernel achieves under ``fraction`` of ``target_gbps``
    (default the H100 SXM's 3350 GB/s of HBM3, ``HBM_BYTES_PER_S``)."""
    got = achieved_bandwidth(bytes_moved, seconds)
    if got < fraction * target_gbps:
        raise AssertionError(
            f"{name}: {got:.1f} GB/s < {fraction:.0%} of "
            f"{target_gbps:.0f} GB/s target")
    return got


def decode_token_stats(step_seconds: list, batch: int) -> dict:
    """Median, mean and p90 seconds of decode steps, and tokens/s at the
    median."""
    per_tok = sorted(step_seconds)
    return {
        "median_s": statistics.median(per_tok),
        "mean_s": sum(per_tok) / len(per_tok),
        "p90_s": per_tok[int(0.9 * (len(per_tok) - 1))],
        "tokens_per_s": batch / statistics.median(per_tok),
    }


def device_busy_us(trace_dir: str) -> float:
    """Union of the device rows' [ts, ts + dur) intervals (the filler left
    out): rows overlap across streams and within one, so a sum of
    durations can exceed the wall clock."""
    iv = sorted((float(ev.get("ts", 0.0)),
                 float(ev.get("ts", 0.0)) + float(ev["dur"]))
                for ev in _device_events(trace_dir))
    covered, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    return covered


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
