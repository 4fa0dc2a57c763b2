"""Variants of the MX block quantizer (csrc/mx_quant.cu) beside the shipped
kernel, on the same operands:

- "steps2" / "steps8": 2 or 8 warp steps of loads in flight (shipped: 4);
- "cs_store": the codes written with streaming stores (st.global.cs);
- "steps8_cs": both.

Each variant is the shipped source with its text replaced, built with the
shipped flags; its codes and exponents must equal the shipped kernel's.
CUDA events over L2-cold copies (copies_for), at gate_up (4096 x 28672,
f32) in fp6_e3m2 and int8 at block 32 and the ragged 4000 x 4100 at block
16; one JSON line per case with the card's name and power limit.

    python _dev/mx_quant_variants.py      (from the repository root, on a card)
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from microscopiq_tpu_torch.formats import get_format_params  # noqa: E402
from microscopiq_tpu_torch.ops import packing as pk  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import build  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import mx_quant as mq  # noqa: E402
from microscopiq_tpu_torch.utils.observability import (  # noqa: E402
    card_line, copies_for, cuda_ms)

STEPS = "static constexpr int kSteps = kQuads > 1 ? 2 : 4;"
STORE = "      *reinterpret_cast<uint32_t*>(dst) = w.x;"
PATCHES = {
    "steps2": {STEPS: "static constexpr int kSteps = 2;"},
    "steps8": {STEPS: "static constexpr int kSteps = kQuads > 1 ? 4 : 8;"},
    "cs_store": {STORE: "      __stcs(reinterpret_cast<unsigned*>(dst), "
                        "w.x);"},
}
PATCHES["steps8_cs"] = {**PATCHES["steps8"], **PATCHES["cs_store"]}
CASES = (("gate_up", 4096, 28672, 32, "fp6_e3m2"),
         ("gate_up", 4096, 28672, 32, "int8"),
         ("ragged", 4000, 4100, 16, "fp6_e3m2"))


def build_variants() -> dict:
    src = (build.CSRC / "mx_quant.cu").read_text()
    out = ROOT / "_tree_check" / "mx_quant_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, reps in PATCHES.items():
        text = src
        for old, new in reps.items():
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).quantize_mx_block
        fn.argtypes = mq._ARGS
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    fns = {"shipped": build.entry("mx_quant", "quantize_mx_block", mq._ARGS),
           **build_variants()}
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(4016)
    for lin, M, K, bs, fmt in CASES:
        W = torch.randn((M, K), generator=gen, device="cuda") * 0.02
        W[::97] *= 30.0
        Ws = [W] + [W.clone() for _ in range(copies_for(W.numel() * 4) - 1)]
        ebits, mbits, emax, max_norm, _ = get_format_params(fmt)
        cdt = pk.container_dtype(fmt)
        Kp = -(-K // bs) * bs
        codes = torch.empty((M, Kp), dtype=cdt, device="cuda")
        se = torch.empty((M, Kp // bs), dtype=torch.int8, device="cuda")

        def launch(fn, x):
            err = fn(x.data_ptr(), codes.data_ptr(), se.data_ptr(), M, K, Kp,
                     bs, mq._CONTAINERS[cdt], 8, ebits, mbits, emax,
                     max_norm, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        row = {"linear": lin, "M": M, "K": K, "block": bs, "format": fmt}
        want = None
        for name, fn in fns.items():
            launch(fn, W)
            got = (codes.view(torch.uint8).clone(), se.clone())
            if want is None:
                want = got
            elif not (torch.equal(got[0], want[0])
                      and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} {lin} {fmt}: output differs")
            row[f"{name}_ms"] = cuda_ms(lambda i: launch(fn, Ws[i]), len(Ws))
        print(json.dumps({**row, "card": card}), flush=True)


if __name__ == "__main__":
    main()
