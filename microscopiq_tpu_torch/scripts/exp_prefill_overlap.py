"""Decode/MMA overlap inside a K step of the prefill GEMM, on the H100.

    python -m microscopiq_tpu_torch.scripts.exp_prefill_overlap

Counterpart of ``scripts/exp_prefill_overlap.py``. ``gemm_unroll`` cuts each
BK-deep K step into S sub-chunks; interleaved, every warp issues its share
of the decode of sub-chunk s+1 into a second buffer before its MMAs on s,
sequential it decodes s, then runs the MMAs on s. Arms, under the TPU
script's names, at the card's tiles (BM x BN x BK):

  dense           torch.matmul on bf16 weights
  inkernel        the shipped GEMM (128 x 128 x 32, decode then MMAs)
  native_floor    int8 container, S = 1, sequential (128 x 128 x 64): the
                  convert-and-scale floor
  seq1_tk2048     emi8, S = 1, sequential (128 x 128 x 64)
  seq4            emi8, S = 4, sequential (128 x 128 x 64)
  unroll4         emi8, S = 4, interleaved (128 x 128 x 64)
  unroll8         emi8, S = 8, interleaved (128 x 128 x 128)
  unroll4_tn1024  emi8, S = 4, interleaved, a wider tile (128 x 256 x 64)
  unroll8_tk4096  emi8, S = 8, interleaved, a deeper step (128 x 128 x 256)

The TPU asked whether Mosaic overlaps the VPU decode with the MXU; on the
card the warps of a block overlap them anyway, so interleaved against
sequential measures the overlap within a warp. One JSON line per arm.
"""

from __future__ import annotations

import functools
from typing import List

from ..ops.cuda import exp_prefill as ep
from . import _prefill
from ._prefill import Arm

NAME = "exp_prefill_overlap"
# arm -> (weight, s, interleave, bm, bn, bk)
ARMS = {"native_floor": ("int8", 1, False, 128, 128, 64),
        "seq1_tk2048": ("emi8", 1, False, 128, 128, 64),
        "seq4": ("emi8", 4, False, 128, 128, 64),
        "unroll4": ("emi8", 4, True, 128, 128, 64),
        "unroll8": ("emi8", 8, True, 128, 128, 128),
        "unroll4_tn1024": ("emi8", 4, True, 128, 256, 64),
        "unroll8_tk4096": ("emi8", 8, True, 128, 128, 256)}


def arms() -> List[Arm]:
    out = [_prefill.dense_arm(), _prefill.shipped_arm("inkernel")]
    for name, (weight, s, il, bm, bn, bk) in ARMS.items():
        out.append(Arm(name, "exp_gemm_unroll", weight,
                       functools.partial(ep.gemm_unroll, s=s, interleave=il,
                                         bm=bm, bn=bn, bk=bk),
                       tiles=dict(bm=bm, bn=bn, bk=bk, s=s, interleave=il)))
    return out


def main(argv=None, *, device="cuda", K: int = _prefill.K,
         N: int = _prefill.N, M: int = _prefill.M, setup=None):
    _prefill.parser(__doc__).parse_args(argv)
    return _prefill.main(NAME, arms, device=device, K=K, N=N, M=M,
                         setup=setup)


if __name__ == "__main__":
    main()
