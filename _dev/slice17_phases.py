"""Run chip_smoke.py's serving, eval, probe, family and HF-loading phases
alone on the card (quicker than the whole script while iterating): builds
the GEMV, GEMM and quantized-attention sources, then the 32-layer MX-FP6
Llama-3-8B model for ``frontends`` and ``cot_evals``, then
``kv_accuracy``, ``families`` and ``hf_loading``; one JSON line a phase.

    python _dev/slice17_phases.py [phase ...]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import build  # noqa: E402


def main(which):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    cs.log(phase="build", seconds=build.build_all(
        ("dequant_gemv", "dequant_matmul", "quant_attention")))
    secs = {}
    if {"frontends", "cot_evals"} & set(which):
        packed, _ = cs.build(True)
        for name in ("frontends", "cot_evals"):
            if name in which:
                t0 = time.perf_counter()
                getattr(cs, f"{name}_phase")(packed, card)
                secs[name] = time.perf_counter() - t0
        del packed
        torch.cuda.empty_cache()
    for name in ("kv_accuracy", "families", "hf_loading"):
        if name in which:
            t0 = time.perf_counter()
            getattr(cs, f"{name}_phase")(card)
            secs[name] = time.perf_counter() - t0
    cs.log(phase="seconds", **secs)


if __name__ == "__main__":
    main(sys.argv[1:] or ["frontends", "cot_evals", "kv_accuracy",
                          "families", "hf_loading"])
