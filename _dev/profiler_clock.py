"""Which kernel records does a torch.profiler window lose as a process ages?

One process, on a card: a set of profiler windows every ``--every`` seconds,
first for ``--idle`` seconds with the card idle between sets, then for
``--busy`` seconds with it running large matmuls between sets. Each window
holds 16 calls of three small kernels (48 launches), CUDA activity only (as
``chip_smoke`` takes it), and

- ``bare``: the calls alone;
- ``filler``: ``--filler`` one-cycle ``torch.cuda._sleep`` kernels on each
  side of the calls (``chip_smoke.profile_window``'s form);
- ``gpu_pad``: one ``torch.cuda._sleep`` of ``--pad-ms`` on each side;
- ``host_pad``: ``time.sleep(--pad-ms)`` on the host on each side.

One JSON line a set: the process age, CLOCK_REALTIME's move against
CLOCK_MONOTONIC since the start (us), and for each window, from its exported
chrome trace: the launches and kernel records; the calls' kernels kept; the
launch-order positions (0 = the window's first launch) of the launches
whose kernel record is missing; the least distance (us) of a kept kernel
from the trace span's start and end; and the least and largest (kernel
start - its launch) in us.

    python _dev/profiler_clock.py [--idle 150] [--busy 150] [--every 15]
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def pad_fn(kind: str, pad_ms: float, filler: int):
    def pad():
        if kind == "gpu_pad":
            torch.cuda._sleep(int(pad_ms * 1.4e6))
        elif kind == "host_pad":
            time.sleep(pad_ms / 1e3)
        elif kind == "filler":
            for _ in range(filler):
                torch.cuda._sleep(1)
    return pad


def window(calls_fn, kind: str, pad_ms: float, filler: int,
           tmp: Path) -> dict:
    pad = pad_fn(kind, pad_ms, filler)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad()
        calls_fn()
        pad()
        torch.cuda.synchronize()
    path = tmp / f"{kind}.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    span = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
            if e.get("cat") in ("Trace", "trace")]
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in ev
                      if e.get("cat") == "cuda_runtime"
                      and "Launch" in e.get("name", "")
                      and "correlation" in e.get("args", {}))
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    kept = {k["args"].get("correlation") for k in kernels}
    ours = [k for k in kernels if "spin" not in k["name"]
            and "sleep" not in k["name"]]
    launch_ts = {c: t for t, c in launches}
    offs = [k["ts"] - launch_ts[k["args"]["correlation"]] for k in ours
            if k["args"].get("correlation") in launch_ts]
    rec = {"launches": len(launches), "kernels": len(kernels),
           "ours": len(ours),
           "missing_at": [i for i, (_, c) in enumerate(launches)
                          if c not in kept]}
    if span and kernels:
        s, e = span[0]
        rec["kernel_from_start_us"] = min(k["ts"] for k in kernels) - s
        rec["kernel_to_end_us"] = e - max(k["ts"] + k.get("dur", 0)
                                          for k in kernels)
    if launches and span:
        rec["launch_from_start_us"] = launches[0][0] - span[0][0]
        rec["launch_to_end_us"] = span[0][1] - launches[-1][0]
    if offs:
        rec.update(off_min_us=min(offs), off_max_us=max(offs))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--idle", type=float, default=150.0)
    ap.add_argument("--busy", type=float, default=150.0)
    ap.add_argument("--every", type=float, default=15.0)
    ap.add_argument("--pad-ms", type=float, default=20.0)
    ap.add_argument("--filler", type=int, default=128)
    args = ap.parse_args()

    t0 = time.monotonic()
    skew0 = time.time_ns() - time.monotonic_ns()
    a = torch.randn(64, 4096, device="cuda")
    big = torch.randn(8192, 8192, device="cuda")
    torch.cuda.synchronize()

    def calls():
        for _ in range(16):
            b = a * 2.0
            b.add_(1.0)
            b.relu_()

    tmp = Path(tempfile.mkdtemp())
    for stage, seconds in (("idle", args.idle), ("busy", args.busy)):
        t_stage = time.monotonic()
        while time.monotonic() - t_stage < seconds:
            rec = {"stage": stage, "age_s": round(time.monotonic() - t0, 1),
                   "realtime_minus_monotonic_us":
                       (time.time_ns() - time.monotonic_ns() - skew0) / 1e3}
            for kind in ("bare", "filler", "gpu_pad", "host_pad"):
                rec[kind] = window(calls, kind, args.pad_ms, args.filler, tmp)
            print(json.dumps(rec), flush=True)
            end = time.monotonic() + args.every
            while time.monotonic() < end:
                if stage == "busy":
                    big @ big
                    torch.cuda.synchronize()
                else:
                    time.sleep(0.05)


if __name__ == "__main__":
    main()
