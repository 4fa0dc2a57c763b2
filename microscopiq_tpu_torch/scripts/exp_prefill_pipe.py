"""Software-pipelined and resident-x prefill GEMMs on the H100.

    python -m microscopiq_tpu_torch.scripts.exp_prefill_pipe

Counterpart of ``scripts/exp_prefill_pipe.py``. Arms, under the TPU
script's names, at the card's tiles:

  dense            torch.matmul on bf16 weights
  inkernel         the shipped GEMM
  pipe_tn256       ``gemm_pipe``, two A/B stages along K, 128 x 128 x 32
  pipe_tn512       the same at 128 x 256 x 32
  residentx_tn256  ``gemm_rx``: 16 rows of x resident for the whole K (128
                   KB of shared memory), N tiles of 256 columns
  residentx_tn512  the same with N tiles of 512

On the TPU x (8 MB) sat whole in VMEM; a block of the card holds 16 rows
of it, so each W tile is decoded M / 16 times. One JSON line per arm.
"""

from __future__ import annotations

import functools
from typing import List

from ..ops.cuda import exp_prefill as ep
from . import _prefill
from ._prefill import Arm

NAME = "exp_prefill_pipe"
PIPE_ARMS = {"pipe_tn256": (128, 128, 32), "pipe_tn512": (128, 256, 32)}
RX_ARMS = {"residentx_tn256": (256, 32), "residentx_tn512": (512, 32)}


def arms() -> List[Arm]:
    out = [_prefill.dense_arm(), _prefill.shipped_arm("inkernel")]
    for name, (bm, bn, bk) in PIPE_ARMS.items():
        out.append(Arm(name, "exp_gemm_pipe", "emi8",
                       functools.partial(ep.gemm_pipe, bm=bm, bn=bn, bk=bk),
                       tiles=dict(bm=bm, bn=bn, bk=bk)))
    for name, (tn, bk) in RX_ARMS.items():
        out.append(Arm(name, "exp_gemm_rx", "emi8",
                       functools.partial(ep.gemm_rx, tn=tn, bk=bk),
                       tiles=dict(rows=ep.RX_ROWS, tn=tn, bk=bk)))
    return out


def main(argv=None, *, device="cuda", K: int = _prefill.K,
         N: int = _prefill.N, M: int = _prefill.M, setup=None):
    _prefill.parser(__doc__).parse_args(argv)
    return _prefill.main(NAME, arms, device=device, K=K, N=N, M=M,
                         setup=setup)


if __name__ == "__main__":
    main()
