"""Setups of the decode-GEMV experiment scripts.

Each is the setup of the TPU script of the same name, with W and x drawn
from a ``torch.Generator`` seeded 0 on the device, so that the weights are
made where they are used; timing and records are ``_prefill``'s (three
interleaved passes, median, L2-cold operand copies), so that every weight,
the 8.4 MB NB weight too, streams from HBM in each timed call:

* :func:`decode_setup` (``scripts/exp_decode_variants.py:41-72``): K 4096,
  N 16384, M 8, W ~ N(0, 0.02) as MX-FP6 (``fp6_e3m2``) emi8, block 32
  (``emi8``), its ebf8 re-encode (``ebf8``) and bf16 (``wd``); x ~ N(0, 1)
  in bf16. Plain versions: one a decode variant (``exp_gemv.VARIANTS``);
* :func:`tiles_setup` (``scripts/exp_sad_tiles.py:38-46``): K 4096,
  N 28672 (gate_up of Llama-3-8B), M 8, the same weights but ebf8;
* :func:`nb_setup` (``scripts/exp_nb_variants.py:245-269``): K = N = 4096,
  M 8, W ~ N(0, 0.02) with 3% of the elements scaled by 10, int2 inliers
  and fp4 outliers at block 16 from 2-sigma ``"max"`` decisions on the
  (N, K) transpose, budget 2, in the compact transport (``nb``), and its
  dequantized bf16 weight as (K, N) (``wd``). Plain versions: ``nb`` (the
  full weight) and one an ablation mode (``exp_gemv.ABLATIONS``).
"""

from __future__ import annotations

import functools

import torch

from .. import resolve_device
from ..ops import outlier as tol
from ..ops import packing as pk
from ..ops.cuda import exp_gemv as eg
from ..ops.cuda import outlier_matmul as om
from ._prefill import SEED, Setup, card_name, with_copies

M = 8                             # decode rows
BLOCK = 32
DECODE_SHAPE = (4096, 16384)      # (K, N) of exp_decode_variants
TILES_SHAPE = (4096, 28672)       # (K, N) of exp_sad_tiles
NB_SHAPE = (4096, 4096)           # (K, N) of exp_nb_variants
NB_BLOCK, NB_BUDGET = 16, 2


def _emi8(W: torch.Tensor) -> pk.PackedMX:
    return pk.to_serving_layout(pk.pack_mx(W, 8, "fp6_e3m2", BLOCK, axis=0,
                                           transport="emi8"))


def _setup(dev, gen, weights, M_, K, **kw) -> Setup:
    x = torch.randn((M_, K), generator=gen, device=dev).to(torch.bfloat16)
    with_copies(weights, dev)
    return Setup(device=dev, card=card_name(dev), x=x, weights=weights, **kw)


def decode_setup(device="cuda", *, K: int = DECODE_SHAPE[0],
                 N: int = DECODE_SHAPE[1], M: int = M) -> Setup:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    W = torch.randn((K, N), generator=gen, device=dev) * 0.02
    emi8 = _emi8(W)
    weights = {"wd": [W.to(torch.bfloat16)], "emi8": [emi8],
               "ebf8": [eg.ebf8_weight(emi8)]}
    del W
    plains = {v: ("ebf8" if v == "ebf8" else "emi8",
                  functools.partial(eg.variant_reference, variant=v))
              for v in eg.VARIANTS}
    return _setup(dev, gen, weights, M, K, plains=plains)


def tiles_setup(device="cuda", *, K: int = TILES_SHAPE[0],
                N: int = TILES_SHAPE[1], M: int = M) -> Setup:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    W = torch.randn((K, N), generator=gen, device=dev) * 0.02
    weights = {"wd": [W.to(torch.bfloat16)], "emi8": [_emi8(W)]}
    del W
    return _setup(dev, gen, weights, M, K)


def nb_weight(K: int, N: int, gen: torch.Generator,
              dev: torch.device) -> pk.PackedOutlierNB:
    """The compact NB weight of the NB script's setup."""
    W = torch.randn((K, N), generator=gen, device=dev) * 0.02
    hit = torch.rand((K, N), generator=gen, device=dev) < 0.03
    W = torch.where(hit, W * 10, W)
    _, _, dec = tol.quantize_mx_outlier_hessian_decisions(
        W.T.contiguous(), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0],
        NB_BLOCK, max_outliers_per_block=NB_BUDGET)
    dec["block_size"] = NB_BLOCK
    return pk.pack_outlier_nb(dec, budget=NB_BUDGET)


def nb_setup(device="cuda", *, K: int = NB_SHAPE[0], N: int = NB_SHAPE[1],
             M: int = M) -> Setup:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nb = nb_weight(K, N, gen, dev)
    wd = pk.dequantize_outlier_nb(nb, dtype=torch.bfloat16).T.contiguous()
    plains = {"nb": ("nb", om.dequant_matmul_nb_reference),
              **{m: ("nb", functools.partial(eg.fd_reference, mode=m))
                 for m in eg.ABLATIONS}}
    return _setup(dev, gen, {"wd": [wd], "nb": [nb]}, M, K,
                  block=NB_BLOCK, plains=plains)
