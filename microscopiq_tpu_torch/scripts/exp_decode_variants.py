"""Decode variants of the MX-FP6 GEMV on the H100, against a zero-decode floor.

    python -m microscopiq_tpu_torch.scripts.exp_decode_variants

Counterpart of ``scripts/exp_decode_variants.py``, which timed five decode
bodies of the TPU's scale-after-dot GEMV at (4096, 16384), M = 8. Here
``exp_gemv.gemv_variant`` runs each body (``i32``, ``i16``, ``ebf8``,
``f32dot``, ``zero``; ``csrc/exp_gemv.cu`` says what each one does on the
card) in one kernel, at one tile and one summation order, one arm each;
beside them ``dense`` (``torch.matmul`` on the bf16 weight) and ``shipped``
(``dequant_gemv``, the shipped GEMV). ``zero`` is held to its own plain
version (the codes as values), the others to the emi8 weight's. Then one
line ``{"parity": ...}``: ``i16``, ``ebf8`` and ``f32dot`` against ``i32``,
bit for bit, with the largest difference of each; the records of those
arms carry the same. One JSON line per arm.
"""

from __future__ import annotations

import functools
import json
from typing import List

import torch

from ..ops.cuda import dequant_matmul as dm
from ..ops.cuda import exp_gemv as eg
from . import _gemv, _prefill
from ._prefill import Arm

NAME = "exp_decode_variants"
PARITY = ("i16", "ebf8", "f32dot")       # each bit-equal to i32


def _weight(variant: str) -> str:
    return "ebf8" if variant == "ebf8" else "emi8"


def arms() -> List[Arm]:
    mt, tn, kb = eg.VARIANT_TILE
    return ([_prefill.dense_arm(),
             Arm("shipped", "dequant_gemv_emi8", "emi8", dm.dequant_gemv)]
            + [Arm(v, eg.variant_key(v), _weight(v),
                   functools.partial(eg.gemv_variant, variant=v), plain=v,
                   tiles=dict(mt=mt, tn=tn, kb=kb))
               for v in eg.VARIANTS])


def parity(setup: _prefill.Setup) -> dict:
    """i16, ebf8 and f32dot against i32 on the setup: bit-equal or not, and
    the largest difference of each."""
    ys = {v: eg.gemv_variant(setup.x, setup.weights[_weight(v)][0], v)
          for v in ("i32",) + PARITY}
    exact = {v: bool(torch.equal(ys[v], ys["i32"])) for v in PARITY}
    delta = {v: (ys[v] - ys["i32"]).abs().max().item() for v in PARITY}
    return {"exact": all(exact.values()), "exact_by_variant": exact,
            "max_delta": delta}


def main(argv=None, *, device="cuda", K: int = _gemv.DECODE_SHAPE[0],
         N: int = _gemv.DECODE_SHAPE[1], M: int = _gemv.M, setup=None):
    _prefill.parser(__doc__).parse_args(argv)
    setup = setup if setup is not None else _gemv.decode_setup(
        device, K=K, N=N, M=M)
    par = parity(setup)
    recs = _prefill.run(NAME, arms(), setup)
    for r in recs:
        if r["arm"] in PARITY:
            r.update(parity_exact=par["exact_by_variant"][r["arm"]],
                     parity_max_delta=par["max_delta"][r["arm"]])
        print(json.dumps(r), flush=True)
    print(json.dumps({"parity": par, "card": setup.card}), flush=True)
    return recs


if __name__ == "__main__":
    main()
