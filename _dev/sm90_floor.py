"""The floor of the wgmma + TMA mainloop (csrc/gemm_sm90.cuh): the same
loop with a bf16 weight whose decode is a copy (_dev/sm90_floor.cu), at
every Llama-3-8B shape, M = 1024, beside torch.matmul on the same bf16
weight and the shipped pf6, side-band, pf4, fp16-container, emi8, emi8m,
compact-NB, sb4 and sb2 GEMMs on chip_smoke.py's seeded operands. CUDA
events over L2-cold operand copies (copies_for), one JSON line per shape;
the floor's output is held to torch.matmul first.

    python _dev/sm90_floor.py          (from the repository root, on a card)
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
from microscopiq_tpu_torch.ops.cuda import build  # noqa: E402
from microscopiq_tpu_torch.utils.observability import (  # noqa: E402
    card_line, copies_for, cuda_ms)


def floor_lib() -> ctypes.CDLL:
    out = ROOT / "_tree_check" / "sm90_floor" / "libsm90_floor.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(out),
                    str(ROOT / "_dev" / "sm90_floor.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.gemm_bf16_sm90_floor
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    fn = floor_lib().gemm_bf16_sm90_floor
    card = card_line()
    shipped = {(r["kernel"], r["linear"]): r["ms"]
               for r in cs.sm90_gemm_times()}
    gen = torch.Generator(device="cuda").manual_seed(909)
    for lin, K, N in cs.SHAPES:
        x = torch.randn((cs.SM90_M, K), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn((K, N), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 0.02
        nc = copies_for(w.numel() * 2)
        ws = [w] + [w.clone() for _ in range(nc - 1)]
        out = torch.empty((cs.SM90_M, N), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run(i):
            build.check(fn(x.data_ptr(), ws[i].data_ptr(), out.data_ptr(),
                           cs.SM90_M, K, N, stream), "gemm_bf16_sm90_floor")

        run(0)
        ref = torch.matmul(x.float(), w.float())
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        if not rel < cs.GEMM_REL_TOL:
            raise AssertionError(f"floor {lin}: rel err {rel}")
        bound, by = cs.row_bound(w.numel() * 2 + x.numel() * 2
                                 + cs.SM90_M * N * 4, cs.SM90_M, N, K)
        print(json.dumps(dict(
            phase="sm90_floor", linear=lin, M=cs.SM90_M, K=K, N=N,
            floor_ms=cuda_ms(run, nc),
            matmul_ms=cuda_ms(lambda i: torch.matmul(x, ws[i]), nc),
            pf6_ms=shipped[("pf6", lin)],
            sideband_ms=shipped[("sideband", lin)],
            pf4_ms=shipped[("pf4", lin)], fp16_ms=shipped[("fp16", lin)],
            emi8_ms=shipped[("emi8", lin)], emi8m_ms=shipped[("emi8m", lin)],
            nb_ms=shipped[("nb", lin)], sb4_ms=shipped[("sb4", lin)],
            sb2_ms=shipped[("sb2", lin)],
            bound_ms=bound,
            bound_by=by, rel_err=rel, card=card)), flush=True)
        del ws, w, out, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
