"""Tile sweep of the MX-FP6 decode GEMV on the H100.

    python -m microscopiq_tpu_torch.scripts.exp_sad_tiles

Counterpart of ``scripts/exp_sad_tiles.py``, which re-ran the TPU's GEMV
under 16 (TM, TN, TK) settings at (4096, 28672), M = 8. The TPU's tiles do
not carry over; the card's knobs are ``exp_gemv.TILES``: rows of x a block
(``tm``), columns a block (``tn``: 4 a thread) and K blocks a split
(``kb``), each compiled, one arm each, named ``tm<tm>_tn<tn>_kb<kb>``.
``tm0_tn0_kb0`` is the production default, the shipped ``dequant_gemv``
(8 rows, 512 columns, its K split from the shape: 7 blocks here, so
``tm8_tn512_kb7`` repeats its arithmetic); ``dense`` is ``torch.matmul`` on
the bf16 weight. One JSON line per configuration: ms, GB/s of codes, share
of the byte bound, error against the plain version.
"""

from __future__ import annotations

import functools
from typing import List

from ..ops.cuda import dequant_matmul as dm
from ..ops.cuda import exp_gemv as eg
from . import _gemv, _prefill
from ._prefill import Arm

NAME = "exp_sad_tiles"


def _arm(mt: int, tn: int, kb: int) -> Arm:
    return Arm(f"tm{mt}_tn{tn}_kb{kb}", eg.tiles_key(mt, tn, kb), "emi8",
               functools.partial(eg.gemv_tiles, mt=mt, tn=tn, kb=kb),
               tiles=dict(mt=mt, tn=tn, kb=kb))


def arms() -> List[Arm]:
    return ([_prefill.dense_arm(),
             Arm("tm0_tn0_kb0", "dequant_gemv_emi8", "emi8", dm.dequant_gemv,
                 tiles=dict(mt=0, tn=0, kb=0))]
            + [_arm(*t) for t in eg.TILES])


def main(argv=None, *, device="cuda", K: int = _gemv.TILES_SHAPE[0],
         N: int = _gemv.TILES_SHAPE[1], M: int = _gemv.M, setup=None):
    _prefill.parser(__doc__).parse_args(argv)
    return _prefill.main(NAME, arms, device=device, K=K, N=N, M=M,
                         setup=setup, make=_gemv.tiles_setup)


if __name__ == "__main__":
    main()
