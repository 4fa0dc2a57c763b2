"""Check the tensor-parallel kernel wrappers against the plain versions.

    python -m microscopiq_tpu_torch.scripts.check_tp [--world 1] \
        [--backend nccl] [--device cuda]

Counterpart of ``scripts/check_tpu_tp_pallas.py``, at its shapes: an
MX-FP6 emi8 (K=512, N=1024) weight (block 32) times x of 8 rows (the
GEMV) and of 256 rows (the GEMM) through :func:`tp_dequant_matmul`, and a
rank-2 GEAR 4-bit cache (B=2, KVH=4, hd=128, gap=64, 100 live tokens, 8
query heads) through :func:`tp_quant_attention_decode`, each against
``dequant_matmul_reference`` / ``quant_attention_decode_reference`` on the
whole operands, at the port's bounds: GEMV 1e-5 of max, GEMM 2e-3,
quantized attention 2e-2. ``--world 1`` runs one rank, the degenerate
(1, 1) mesh, joined to a one-rank ``--backend`` group; ``--world N``
starts N processes of this script that join a gloo (or ``--backend``)
group on localhost, each on its N-th of the columns and heads. Operands
come from seeded CPU generators, so every rank draws the same. Rank 0
prints one JSON line (errors, bounds, each rank's kernel launches) and
writes no file; the exit code is 1 if a bound is missed.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import Optional, Sequence

import torch

GEMV_TOL, GEMM_TOL, ATTN_TOL = 1e-5, 2e-3, 2e-2
K, N, GEMV_M, GEMM_M = 512, 1024, 8, 256
B, KVH, HD, GAP, MAXLEN, LENGTH = 2, 4, 128, 64, 128, 100


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def operands(device):
    """(packed weight, GEMV x, GEMM x, cache layer tuple, q, cache cfg)."""
    from ..kv.cache import (QuantizedDecodeCache, QuantKVConfig,
                            init_quant_cache)
    from ..ops.packing import pack_mx, to_serving_layout

    W = torch.randn((K, N), generator=_gen(2)) * 0.02
    w = to_serving_layout(pack_mx(W.to(device), 8, "fp6_e3m2", 32, axis=0,
                                  transport="emi8"))
    xs = [torch.randn((m, K), generator=_gen(3 + i)).to(device)
          for i, m in enumerate((GEMV_M, GEMM_M))]
    cfg = QuantKVConfig(bits=4, gap=GAP, v_group=HD, rank=2)
    cache = QuantizedDecodeCache(init_quant_cache(
        1, B, MAXLEN, KVH, HD, cfg, device=device), cfg)
    k = torch.randn((B, LENGTH, KVH, HD), generator=_gen(4)).to(device)
    v = torch.randn((B, LENGTH, KVH, HD), generator=_gen(5)).to(device)
    cache.update(0, k, v, torch.arange(LENGTH, device=device)[None], None)
    st = cache.finalize()
    full = (st.kq, st.k_mn, st.k_sc, st.vq, st.v_mn, st.v_sc, st.res_k,
            st.res_v, st.k_p, st.k_q, st.v_p, st.v_q)
    q = torch.randn((B, 2 * KVH, HD), generator=_gen(6)).to(device)
    return w, xs, full, q, cfg


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def check(device, world: int) -> dict:
    """This rank's errors and launch counts on a (1, world) mesh."""
    from ..ops.cuda import dequant_matmul as dm
    from ..ops.cuda import quant_attention as qa
    from ..ops.cuda.dequant_matmul import dequant_matmul_reference
    from ..ops.cuda.quant_attention import quant_attention_decode_reference
    from ..parallel import make_mesh
    from ..parallel.tp_kernels import (tp_dequant_matmul,
                                       tp_quant_attention_decode)

    mesh = make_mesh(world, data=1, model=world)
    w, xs, full, q, cfg = operands(device)
    dm.reset_launch_counts()
    qa.reset_launch_counts()
    ys = [tp_dequant_matmul(mesh, x, w) for x in xs]
    ya = tp_quant_attention_decode(mesh, q, full, 0, LENGTH, cfg.v_group,
                                   HD ** -0.5)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {k: v for k, v in {**dm.launch_counts,
                                  **qa.launch_counts}.items() if v}
    errs = {"gemv_rel_err": _rel(ys[0], dequant_matmul_reference(xs[0], w)),
            "gemm_rel_err": _rel(ys[1], dequant_matmul_reference(xs[1], w)),
            "attention_rel_err": _rel(ya, quant_attention_decode_reference(
                q, full, 0, LENGTH, cfg.v_group, HD ** -0.5))}
    return dict(errs, launches=launches)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_rank(rank: int, world: int, port: int, backend: str,
             device: str) -> Optional[dict]:
    """One rank: join the group, check, gather every rank's record; rank
    0 returns the merged record."""
    import torch.distributed as dist

    from .. import resolve_device
    from ..parallel import init_distributed

    dev = resolve_device(device)
    init_distributed(f"localhost:{port}", world, rank, backend=backend)
    rec = check(dev, world)
    every = [None] * world
    dist.all_gather_object(every, rec)
    dist.destroy_process_group()
    return None if rank else merge(every, world, backend, dev)


def merge(every, world: int, backend: str, device) -> dict:
    """One record of every rank's :func:`check`: the largest errors, each
    rank's launches, the bounds and whether every error meets its own."""
    dev = torch.device(device)
    out = {k: max(r[k] for r in every) for k in every[0] if k != "launches"}
    out.update(world=world, backend=backend, device=str(dev),
               launches_by_rank=[r["launches"] for r in every],
               tol={"gemv": GEMV_TOL, "gemm": GEMM_TOL,
                    "attention": ATTN_TOL},
               shapes=dict(K=K, N=N, gemv_m=GEMV_M, gemm_m=GEMM_M, B=B,
                           KVH=KVH, head_dim=HD, gap=GAP, live=LENGTH))
    out["ok"] = (out["gemv_rel_err"] <= GEMV_TOL
                 and out["gemm_rel_err"] <= GEMM_TOL
                 and out["attention_rel_err"] <= ATTN_TOL)
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--backend", default=None,
                   help="nccl (default at world 1 on the card) or gloo "
                        "(default otherwise)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    backend = a.backend or ("nccl" if a.world == 1 and a.device != "cpu"
                            else "gloo")
    if a.rank is not None:                       # a child of --world N
        out = run_rank(a.rank, a.world, a.port, backend, a.device)
    elif a.world == 1:
        out = run_rank(0, 1, _free_port(), backend, a.device)
    else:
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "microscopiq_tpu_torch.scripts.check_tp",
             "--world", str(a.world), "--backend", backend, "--device",
             a.device, "--rank", str(r), "--port", str(port)],
            stdout=subprocess.PIPE, text=True, env=os.environ.copy())
            for r in range(a.world)]
        outs = [pr.communicate(timeout=600)[0] for pr in procs]
        if any(pr.returncode for pr in procs):
            print(f"check_tp: a rank failed: "
                  f"{[pr.returncode for pr in procs]}", file=sys.stderr)
            return 1
        out = json.loads(outs[0].strip().splitlines()[-1])
    if out is None:
        return 0
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
