"""Tile sweep of the prefill GEMM on the H100, pure dot and emi8 decode.

    python -m microscopiq_tpu_torch.scripts.exp_prefill_tiles2

Counterpart of ``scripts/exp_prefill_tiles2.py``, which swept the TPU's
(TM, TN, TK) for the bf16-weight body and the emi8-decode body of one
kernel. Here ``gemm_tiles`` runs both bodies at the card's own tiles
(``exp_prefill.TILES``: BM in {64, 128, 256}, BN in {64, 128, 256}, BK in
{32, 64}, each within a block's 227 KB of shared memory and 255 registers a
thread), one arm each, named ``<body>_bm<BM>_bn<BN>_bk<BK>``, and the emi8
body at the shipped tile with bf16 out (``..._bf16``); beside them
``dense`` (torch.matmul on bf16) and ``inkernel`` (the shipped GEMM) at the
shipped 128 x 128 x 32. The TPU's tiles (TM 1024, TN up to 7168) do not
carry over. One JSON line per arm.
"""

from __future__ import annotations

import functools
from typing import List

import torch

from ..ops.cuda import exp_prefill as ep
from . import _prefill
from ._prefill import Arm

NAME = "exp_prefill_tiles2"
BF16_OUT = ("emi8", 128, 128, 32)        # the sweep's one bf16-out arm


def _arm(src, bm, bn, bk, out_dtype=torch.float32) -> Arm:
    bf16 = out_dtype == torch.bfloat16
    return Arm(f"{src}_bm{bm}_bn{bn}_bk{bk}" + ("_bf16" if bf16 else ""),
               ep.tiles_key(src, bm, bn, bk), "wd" if src == "pre" else "emi8",
               functools.partial(ep.gemm_tiles, bm=bm, bn=bn, bk=bk,
                                 out_dtype=out_dtype),
               tiles=dict(bm=bm, bn=bn, bk=bk, out="bf16" if bf16 else "f32"),
               out_dtype=out_dtype)


def arms() -> List[Arm]:
    return ([_prefill.dense_arm(), _prefill.shipped_arm("inkernel")]
            + [_arm(*cfg) for cfg in ep.TILES]
            + [_arm(*BF16_OUT, out_dtype=torch.bfloat16)])


def main(argv=None, *, device="cuda", K: int = _prefill.K,
         N: int = _prefill.N, M: int = _prefill.M, setup=None):
    _prefill.parser(__doc__).parse_args(argv)
    return _prefill.main(NAME, arms, device=device, K=K, N=N, M=M,
                         setup=setup)


if __name__ == "__main__":
    main()
