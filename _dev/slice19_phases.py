"""Run chip_smoke.py's slice-19 phases alone on the card (quicker than the
whole script while iterating): builds the GEMV, GEMM, NB and quantized-KV
attention sources, then ``tp_main_path``, ``tp_check``, ``posit_vq`` and
``parity_grid`` against their CPU references (computed in a process of
their own from the start); one JSON line a phase, then their seconds. With
``--tests``, first the card tests of the slice (``-k "posit or vq or
tp_wrappers"`` on tests/test_torch_kernels_gpu.py).

    python _dev/slice19_phases.py [--tests]
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import build  # noqa: E402


def main(argv):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    refs19 = cs.start_cpu_references_19()
    cs.log(phase="build", seconds=build.build_all(
        ("dequant_gemv", "dequant_matmul", "nb_matmul", "quant_attention")))
    if "--tests" in argv:
        r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                            "-k", "posit or vq or tp_wrappers",
                            "-p", "no:cacheprovider",
                            "tests/test_torch_kernels_gpu.py"], cwd=ROOT,
                           capture_output=True, text=True)
        print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    secs, paths, flat = cs.slice19_phases(card, refs19)
    cs.log(phase="slice19_counts", paths=paths, flat=flat)
    cs.log(phase="slice19_phases", seconds=secs, total_s=sum(secs.values()))


if __name__ == "__main__":
    main(sys.argv[1:])
