"""Builds every CUDA source of the checkout it runs in, all nvcc processes
at once as build.build_all does, and prints one JSON line: the wall
seconds of the whole build and the seconds at which each source's nvcc
finished. Run from a checkout's root (PYTHONPATH=.) with its _build
directory empty, to compare two checkouts' builds in one call.

    env PYTHONPATH=. python /path/to/_dev/build_times.py
"""

import json
import threading
import time

from microscopiq_tpu_torch.ops.cuda import build


def main():
    t0 = time.perf_counter()
    started = {n: build._start(n) for n in build.SOURCES}
    done = {}

    def finish(name, proc):
        build._finish(name, proc)
        done[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=finish, args=(n, s))
               for n, s in started.items() if s is not None]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "finished_s": dict(sorted(done.items(),
                                                key=lambda kv: kv[1]))}),
          flush=True)


if __name__ == "__main__":
    main()
