"""Where the tensor-core GEMV's time goes (csrc/dequant_gemv.cu, gemv_tc):
the shipped kernel beside three builds of the same source with parts taken
out, at gate_up (K = 4096, N = 28672), M = 1, 8 and 64, for emi8 (block 32,
the MX-FP6 main path), the int8 container and sb4:

- "shipped": the kernel as it is (its C entry, called as the variants'
  are, without the wrapper);
- "no_decode": every weight a constant (no code loads, no decode), the
  TMA stream, x, the mma and the scales kept;
- "no_mma": the decode kept, each mma replaced by one add of its operands
  (the decode's results stay live);
- "stream": neither (the TMA stream, x loads, scales, partials and the
  split reduce).

CUDA events over L2-cold operand copies (copies_for); one JSON line per
(decode, M) with the card's name and power limit.

    python _dev/tc_gemv_floor.py       (from the repository root, on a card)
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from microscopiq_tpu_torch.ops import packing as pk  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import build  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm  # noqa: E402
from microscopiq_tpu_torch.utils.observability import (  # noqa: E402
    card_line, copies_for, cuda_ms)

DECODE = ("decode_step<D>(sub, b * p.rows, ks, t, byte, p.B, p.mw, p.ebits, "
          "v);")
MMA = ("          mma_bf16(acc[n][0], a[0], b0, b1);\n"
       "          mma_bf16(acc[n][1], a[1], b0, b1);")
PATCHES = {
    "no_decode": {DECODE: "for (int i = 0; i < 16; ++i) v[i / 4][i % 4] = "
                          "1.f + ks;"},
    "no_mma": {MMA: "          acc[n][0][0] += __uint_as_float(a[0][0] ^ b0);"
                    "\n          acc[n][1][0] += __uint_as_float(a[1][1] ^ "
                    "b1);"},
}
PATCHES["stream"] = {**PATCHES["no_decode"], **PATCHES["no_mma"]}
CASES = (("emi8", "fp6_e3m2", "emi8", 32), ("native", "int8", "native", 32),
         ("sb4", "int4", "sb4", 32))


def build_variants() -> dict:
    """name -> the C entry dequant_gemv of the shipped source built with
    that variant's text replaced, compiled in parallel."""
    src = (build.CSRC / "dequant_gemv.cu").read_text()
    out = ROOT / "_tree_check" / "tc_gemv_floor"
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
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).dequant_gemv
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = {"shipped": dm._kernel("dequant_gemv"), **build_variants()}
    card = card_line()
    K, N = 4096, 28672
    gen = torch.Generator(device="cuda").manual_seed(808)
    for decode, fmt, transport, bs in CASES:
        p = pk.to_serving_layout(pk.pack_mx(
            cs.int_weight(fmt, (K, N), gen).float(), 8, fmt, bs, axis=0,
            transport=transport))
        ps = [p] + [cs._clone_packed(p)
                    for _ in range(copies_for(p.nbytes()) - 1)]
        _, fold, mw, ebits = dm.sad_decode_params(p)
        for M in (1, 8, 64):
            x = torch.randn((M, K), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            plan = dm.gemv_plan(decode, N, K, bs, M)
            ws = torch.empty((plan["ksplit"], M, N), device="cuda")
            out = torch.empty((M, N), device="cuda")

            def launch(fn, w):
                err = fn(x.data_ptr(), w.codes.data_ptr(),
                         w.scale_exp.data_ptr(), ws.data_ptr(),
                         out.data_ptr(), M, K, N, w.codes.shape[0], bs,
                         dm._DECODES[decode], mw, ebits, fold,
                         plan["ksplit"], plan["split_blocks"],
                         plan["stage_blocks"], plan["stages"], plan["ctas"],
                         plan["smem_bytes"], 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            row = {"decode": decode, "block": bs, "M": M, "K": K, "N": N}
            for name, fn in fns.items():
                row[f"{name}_ms"] = cuda_ms(lambda i: launch(fn, ps[i]),
                                            len(ps))
            print(json.dumps({**row, "card": card}), flush=True)


if __name__ == "__main__":
    main()
