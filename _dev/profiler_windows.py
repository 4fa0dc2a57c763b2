"""Are chip_smoke.py's profiler windows whole in a fresh process?

Runs the W8A8 phase (``chip_smoke.s8_phase``) right after building its two
sources, with ``kernel_split_ms`` replaced by a recorder: each window is
taken twice (CUDA activity alone, as chip_smoke takes it, and CPU + CUDA),
and one JSON line a window gives the kernel events each recorded against
the wrappers' launch counts over the same calls; the last line counts the
whole windows. In the full ``chip_smoke.py`` run the same windows came out
short late in the process (30 of 48 events), which is why chip_smoke runs
this phase first.

    python _dev/profiler_windows.py     (from the repository root, on a card)
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity  # noqa: E402

import chip_smoke as cs  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import build  # noqa: E402


def events(fn, n_args, calls, activities):
    """Kernel events with device time in one window, and the wrappers'
    launches over the same calls."""
    from torch.profiler import profile

    before = sum(cs.launches().values())
    with profile(activities=activities) as prof:
        for i in range(calls):
            fn(i % n_args)
        torch.cuda.synchronize()
    got = sum(e.count for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0.0) > 0)
    return got, sum(cs.launches().values()) - before


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(("dequant_gemv", "dequant_gemv_s8"))
    card = cs.card_line()
    tally = {"windows": 0, "whole_cuda": 0, "whole_cpu_cuda": 0}
    split = cs.kernel_split_ms

    def record(fn, n_args, calls=16, phase="", **_):
        fn(0)
        torch.cuda.synchronize()
        rec = {"phase": phase, "calls": calls}
        for tag, acts in (("cuda", [ProfilerActivity.CUDA]),
                          ("cpu_cuda", [ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])):
            got, want = events(fn, n_args, calls, acts)
            rec[tag] = {"events": got, "wrapper_launches": want}
            tally[f"whole_{tag}"] += got >= want and got % calls == 0
        tally["windows"] += 1
        print(json.dumps(rec), flush=True)
        return split(fn, n_args, calls, phase)

    cs.kernel_split_ms = record
    try:
        cs.s8_phase(card)
    finally:
        cs.kernel_split_ms = split
    print(json.dumps({**tally, "card": card}), flush=True)


if __name__ == "__main__":
    main()
