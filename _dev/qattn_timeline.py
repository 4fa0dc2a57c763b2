"""Where the quantized decode attention's time goes (csrc/quant_attention.cu):
a build of the shipped source with %globaltimer stamps at the phases of
every CTA (its consumer thread 0), run through quant_attention_decode on
chip_smoke.py's timed operands (B = 4 x 3136 and B = 8 x 1024 live tokens,
Llama-3-8B geometry, 4 bits), with the plan's ring depth forced to 4, 3, 2
and 1 stages. Phases, in us from the first CTA's start, as [min, median,
90th percentile, max] over the CTAs:

- "pre_landed": q and the split's K scales in shared memory;
- "q_converted": q rounded to bf16 in f32;
- "prepped": every chunk's scaled q made (the chunk loop starts);
- "tiles_done": the split's chunks reduced (the ring drained);
- "cta_merged": the warps' states merged;
- "counted": the split's row written and counted in;
- "finished": the last CTA of a (b, g) has merged the splits.

Beside them, the unstamped decode's device time (torch.profiler). The
stamped build goes to _tree_check/qattn_timeline/ (git-ignored). One JSON
line with the card's name and power limit.

    python _dev/qattn_timeline.py      (from the repository root, on a card)
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import build  # noqa: E402
from microscopiq_tpu_torch.ops.cuda import quant_attention as qa  # noqa: E402

PHASES = ("start", "prepped", "pre_landed", "q_converted", "tiles_done",
          "cta_merged", "counted", "finished")


def stamped_source() -> str:
    """The shipped source with a stamp (PHASES index) at each phase."""
    def sub(s, a, b):
        if a not in s:
            raise RuntimeError(f"the source no longer has {a!r}")
        return s.replace(a, b, 1)

    stamp = lambda k: (  # noqa: E731
        "if (threadIdx.x == 0) qa_dbg[blockIdx.x + gridDim.x * (blockIdx.y"
        f" + gridDim.y * blockIdx.z)][{k}] = gtime();")
    s = (build.CSRC / "quant_attention.cu").read_text()
    s = sub(s, "namespace {\n", """namespace {
__device__ unsigned long long qa_dbg[1 << 14][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
""")
    s = sub(s, "  const int tid = threadIdx.x;\n\n  // folded chunks",
            "  const int tid = threadIdx.x;\n  " + stamp(0)
            + "\n\n  // folded chunks")
    s = sub(s, "  bar_wait(pre, 0);\n", "  bar_wait(pre, 0);\n  " + stamp(2)
            + "\n")
    s = sub(s, "a.q_kind));\n  }\n  consumer_sync();\n",
            "a.q_kind));\n  }\n  consumer_sync();\n  " + stamp(3) + "\n")
    s = sub(s, "    consumer_sync();\n  }\n\n  // the merge area",
            "    consumer_sync();\n  }\n  " + stamp(1)
            + "\n\n  // the merge area")
    s = sub(s, "  consumer_sync();                          // the ring is "
            "drained", "  consumer_sync();                          // the "
            "ring is drained\n  " + stamp(4))
    s = sub(s, "  // one scratch row a split (O as rep rows",
            "  " + stamp(5) + "\n  // one scratch row a split (O as rep rows")
    s = sub(s, "  if (!last) return;", "  " + stamp(6)
            + "\n  if (!last) return;")
    s = sub(s, "  if (tid == 0) a.cnt[bg] = 0;",
            "  if (tid == 0) a.cnt[bg] = 0;\n  " + stamp(7))
    return s + """
extern "C" int qa_dbg_get(void* out) {
  return (int)cudaMemcpyFromSymbol(out, qa_dbg, sizeof(qa_dbg));
}
extern "C" int qa_dbg_clear() {
  static unsigned long long z[1 << 14][8];
  return (int)cudaMemcpyToSymbol(qa_dbg, z, sizeof(z));
}
"""


def main() -> None:
    work = ROOT / "_tree_check" / "qattn_timeline"
    work.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        shutil.copy(h, work / h.name)
    (work / "quant_attention.cu").write_text(stamped_source())
    lib_path = work / "libqattn_timeline.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(work / "quant_attention.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.qa_dbg_get.argtypes = [ctypes.c_void_p]
    plan0, res = qa.attention_plan, {}
    for name in ("b4_3136", "b8_1024"):
        c = cs.QATTN_TIMED[name]
        full, lengths = cs.qattn_state(**c, seed=100)
        q = torch.randn((c["B"], cs.QKV_H, cs.QKV_HD), device="cuda"
                        ).to(torch.bfloat16)
        call = lambda f: qa.quant_attention_decode(  # noqa: E731
            q, f, 0, lengths, c["v_group"], cs.QKV_HD ** -0.5)
        for stages in (4, 3, 2, 1):
            def plan(*geom, st=stages):
                p = plan0(*geom)
                st = min(st, p["cps"])
                return dict(p, stages=st, smem_bytes=qa.smem_bytes(
                    *geom[2:], st, p["slots"]))
            qa.attention_plan = plan
            build._loaded["quant_attention"] = lib
            for _ in range(3):
                call(full)
            torch.cuda.synchronize()
            lib.qa_dbg_clear()
            call(full)
            torch.cuda.synchronize()
            buf = np.zeros((1 << 14, 8), np.uint64)
            lib.qa_dbg_get(buf.ctypes.data)
            p = plan(c["C"], cs.QKV_KVH, cs.QKV_H // cs.QKV_KVH, cs.QKV_HD,
                     cs.QKV_GAP, c["bits"], 1)
            ctas = p["nsplit"] * cs.QKV_KVH * c["B"]
            t = buf[:ctas].astype(np.float64)
            t0 = t[:, 0][t[:, 0] > 0].min()
            rel = np.where(t > 0, (t - t0) / 1e3, np.nan)
            row = {"ctas": ctas, "plan": p}
            for k, ph in enumerate(PHASES):
                col = rel[:, k]
                row[ph] = ([round(float(np.nanpercentile(col, x)), 2)
                            for x in (0, 50, 90, 100)]
                           if np.isfinite(col).any() else None)
            build._loaded.pop("quant_attention")
            fulls = [full] + [tuple(x.clone() for x in full)
                              for _ in range(7)]
            row["decode_ms"] = cs.device_ms(lambda j: call(fulls[j]), 8)
            del fulls
            qa.attention_plan = plan0
            res[f"{name}/stages{stages}"] = row
        del full
        torch.cuda.empty_cache()
    print(json.dumps({"qattn_timeline": res, "card": cs.card_line()}))


if __name__ == "__main__":
    main()
