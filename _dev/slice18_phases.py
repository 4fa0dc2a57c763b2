"""Run chip_smoke.py's training-path phases alone on the card (quicker than
the whole script while iterating): builds the GEMV and NB sources, then
``mx_layers``, ``actquant_ppl`` and ``train_main_path`` against the CPU
references (computed in a process of their own from the start); one JSON
line a phase, then their seconds. With ``--tests``, first the card tests of the
MX layers (``-k mx_`` on tests/test_torch_kernels_gpu.py).

    python _dev/slice18_phases.py [--tests]
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
    if "--tests" in argv:
        r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                            "-k", "mx_", "-p", "no:cacheprovider",
                            "tests/test_torch_kernels_gpu.py"], cwd=ROOT,
                           capture_output=True, text=True)
        print(r.stdout[-3000:], r.stderr[-2000:], flush=True)
    refs = cs.start_cpu_references()
    cs.log(phase="build", seconds=build.build_all(
        ("dequant_gemv", "dequant_matmul", "nb_matmul")))
    secs = cs.slice18_phases(card, refs)
    cs.log(phase="slice18_phases", seconds=secs, total_s=sum(secs.values()))


if __name__ == "__main__":
    main(sys.argv[1:])
