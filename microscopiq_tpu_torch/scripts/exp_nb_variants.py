"""Field-decomposed compact NB GEMVs on the H100, one arm a mode.

    python -m microscopiq_tpu_torch.scripts.exp_nb_variants

Counterpart of ``scripts/exp_nb_variants.py``, which timed the TPU's
field-decomposed NB GEMV (int2 inliers, fp4 outliers, block 16, budget 2)
at (4096, 4096), M = 8, in the outlier strategies ``pdot`` and ``pdot3``
(and at a K span of 1024), the outlier-only ablation ``out_pdot``, the
shipped kernel ``cur`` and a dense bf16 GEMV. Here ``exp_gemv.fd_matmul``
runs every mode of the TPU kernel (``exp_gemv``'s docstring maps each to
its strategy on the card), one arm each, plus ``pdot_k1024`` and
``pdot3_k1024``; ``cur`` is the shipped ``dequant_matmul_nb`` and ``dense``
``torch.matmul`` on the dequantized bf16 weight. The full modes are held to
``dequant_matmul_nb_reference``, each ablation (``in_only``, ``in_dot1``,
``out_only``, ``out_pdot``) to its own plain version, its bound and GB/s
counted on the streams its function reads (``exp_gemv.STREAMS``). One JSON
line per arm.
"""

from __future__ import annotations

import functools
from typing import List

from ..ops.cuda import exp_gemv as eg
from ..ops.cuda import outlier_matmul as om
from . import _gemv, _prefill
from ._prefill import Arm

NAME = "exp_nb_variants"
TK0 = 512                         # the TPU script's default K span
K1024 = ("pdot", "pdot3")         # modes also run at a K span of 1024


def _arm(mode: str, tk0: int = TK0) -> Arm:
    name = mode if tk0 == TK0 else f"{mode}_k{tk0}"
    plain = mode if mode in eg.ABLATIONS else "nb"
    return Arm(name, eg.fd_key(mode), "nb",
               functools.partial(eg.fd_matmul, mode=mode, tk0=tk0),
               plain=plain, tiles=dict(tk0=tk0),
               reads=functools.partial(eg.fd_bytes, mode=mode))


def arms() -> List[Arm]:
    return ([_prefill.dense_arm(),
             Arm("cur", "dequant_gemv_nb", "nb", om.dequant_matmul_nb)]
            + [_arm(m) for m in eg.MODES]
            + [_arm(m, 1024) for m in K1024])


def main(argv=None, *, device="cuda", K: int = _gemv.NB_SHAPE[0],
         N: int = _gemv.NB_SHAPE[1], M: int = _gemv.M, setup=None):
    _prefill.parser(__doc__).parse_args(argv)
    return _prefill.main(NAME, arms, device=device, K=K, N=N, M=M,
                         setup=setup, make=_gemv.nb_setup)


if __name__ == "__main__":
    main()
