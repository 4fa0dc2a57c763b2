"""Prefill floor on the H100: where the packed prefill GEMM's time goes.

    python -m microscopiq_tpu_torch.scripts.exp_prefill_floor [--out PATH]

Counterpart of ``scripts/exp_prefill_floor.py``. At the Llama-3-8B gate_up
shape (K 4096, N 28672), M = 1024, block 32, its arms are:

  dense        torch.matmul on bf16 weights (the yardstick)
  inkernel     the shipped GEMM with the fp6 (emi8) decode inside
  predecoded   bf16 weights through the shipped GEMM's own tile loop, no
               decode (``gemm_pre``, the port of ``pre_kernel``)
  native_int8  the shipped GEMM on int8-container codes: one convert and a
               scale, the least any byte transport pays
  emi8         the TPU script's name for the shipped emi8 GEMM: the same
               call as ``inkernel``, timed again in the same run, so the two
               show the spread between timings

It prints one JSON line per arm, then one line ``{"decomposition": ...}``:
the tile loop (predecoded against dense), the convert (native_int8 against
predecoded) and the decode (emi8 against predecoded). With ``--out PATH`` it
also writes that record to PATH. It never writes the TPU record
``PREFILL_FLOOR_r05.json``.
"""

from __future__ import annotations

import json
import pathlib
from typing import List

from ..ops.cuda import exp_prefill as ep
from . import _prefill
from ._prefill import Arm

NAME = "exp_prefill_floor"
TPU_RECORD = "PREFILL_FLOOR_r05.json"


def arms() -> List[Arm]:
    return [_prefill.dense_arm(), _prefill.shipped_arm("inkernel"),
            Arm("predecoded", "exp_gemm_pre", "wd", ep.gemm_pre,
                tiles=dict(zip(("bm", "bn", "bk"), ep.PRE_TILE))),
            _prefill.shipped_arm("native_int8", "int8"),
            _prefill.shipped_arm("emi8")]


def _diff(a, b):
    return None if a is None or b is None else a - b


def decomposition(recs: List[dict]) -> dict:
    """The floor's record: each arm's ms, share of the bound and ratio to
    dense, and the differences that split the shipped GEMM's time."""
    by = {r["arm"]: r for r in recs}
    ms = {a: r["ms"] for a, r in by.items()}
    first = recs[0]
    return {
        "script": NAME,
        "shape": {k: first[k] for k in ("K", "N", "M", "block")},
        "card": first["card"], "bound_ms": first["bound_ms"],
        "arms_ms": ms,
        "bound_share": {a: r["bound_share"] for a, r in by.items()},
        "vs_dense": {a: r["vs_dense"] for a, r in by.items()},
        "tile_loop_over_dense_ms": _diff(ms["predecoded"], ms["dense"]),
        "convert_ms": _diff(ms["native_int8"], ms["predecoded"]),
        "decode_ms": _diff(ms["inkernel"], ms["predecoded"])}


def main(argv=None, *, device="cuda", K: int = _prefill.K,
         N: int = _prefill.N, M: int = _prefill.M, setup=None):
    p = _prefill.parser(__doc__)
    p.add_argument("--out", help="also write the decomposition record here")
    args = p.parse_args(argv)
    if args.out and pathlib.Path(args.out).name == TPU_RECORD:
        raise ValueError(f"{TPU_RECORD} is the TPU's record; choose another "
                         "path")
    recs = _prefill.main(NAME, arms, device=device, K=K, N=N, M=M,
                         setup=setup)
    dec = decomposition(recs)
    print(json.dumps({"decomposition": dec}), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(dec, indent=1))
    return recs


if __name__ == "__main__":
    main()
