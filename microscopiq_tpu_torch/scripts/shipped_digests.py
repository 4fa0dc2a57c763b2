"""Digests of the shipped GEMV's and GEMM's outputs, one per decode.

    python -m microscopiq_tpu_torch.scripts.shipped_digests

Packs a seeded (512, 384) weight in each decode of ``csrc/common.cuh``
(the float8 containers as fp8_e4m3, fp8_e5m2 and fp6 codes in
``float8_e4m3fn``), in the compact NB format (int2 + fp4, block 16, budget
2) and in the side-band format (int2 + fp4, block 16, budget 4), runs the
GEMV (M = 8) and the GEMM (M = 300: ``dequant_gemm``, ``dequant_gemm_nb``,
``dequant_gemm_outlier``) on seeded x, and prints
one JSON object: {decode: {"gemv": sha256, "gemm": sha256}} (the first 16
hex digits of the f32 outputs' bytes). Run it in two checkouts on one card (this file copied
into the older one) and compare the lines: equal lines show that an edit of
the shared decode left every shipped decode's outputs bit for bit as they
were. The digests depend on the build, so they are compared, never pinned.

Every GEMM digested here runs on the wgmma + TMA mainloop of
``csrc/gemm_sm90.cuh`` at these blocks (``dequant_matmul.gemm_route``); the
bf16 line's ran on ``csrc/common.cuh``'s ``gemm_tile`` before. A line that
stays equal across a move from one loop to the other shows the new loop's
B tile and K order to be the old one's. A GEMV redesigned with another
order of its f32 sums changes its line: that line is held to the twin
instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json

import numpy as np
import torch

from .. import resolve_device
from ..ops import packing as pk
from ..ops.cuda import dequant_matmul as dm
from ..ops.cuda import outlier_matmul as om
from ..ops.outlier import quantize_mx_outlier_hessian_decisions

# (format, transport, block, weight scale); the bfloat16 weights are
# N(0, 64) so that no block exponent clamps at -127
DECODES = (("int4", "sb4", 32, 1.0), ("int2", "sb2", 16, 1.0),
           ("int8", "native", 32, 1.0), ("int2", "native", 32, 1.0),
           ("fp4_e2m1", "pf4", 32, 1.0), ("fp6_e3m2", "pf6", 32, 1.0),
           ("fp6_e2m3", "pf6", 32, 1.0), ("bfloat16", "native", 32, 8.0),
           ("fp16", "native", 16, 1.0), ("fp6_e3m2", "emi8", 16, 1.0),
           ("fp6_e3m2", "emi8", 32, 1.0), ("fp8_e4m3", "native", 32, 1.0),
           ("fp8_e5m2", "native", 32, 1.0), ("fp6_e3m2", "native", 32, 1.0))


def _case(fmt: str, transport: str, bs: int, scale: float, dev):
    """Operands made on the CPU from numpy, then moved to ``dev``."""
    rng = np.random.default_rng(len(fmt) * 7 + bs)
    W = (rng.standard_normal((512, 384)) * scale).astype(np.float32)
    p = pk.to_serving_layout(pk.pack_mx(torch.from_numpy(W), 8, fmt, bs,
                                        axis=0, transport=transport))
    p = dataclasses.replace(p, codes=p.codes.to(dev),
                            scale_exp=p.scale_exp.to(dev))
    x = torch.from_numpy(rng.standard_normal((300, 512)).astype(np.float32))
    return p, x.to(dev)


def _nb_case(dev):
    """A compact NB weight (budget 2, from RTN decisions on the (N, K)
    transpose, made on the CPU) and x, moved to ``dev``."""
    rng = np.random.default_rng(2)
    W = (rng.standard_normal((512, 384)) * 0.02).astype(np.float32)
    W[rng.random(W.shape) < 0.03] *= 10.0
    _, _, dec = quantize_mx_outlier_hessian_decisions(
        torch.from_numpy(W.T.copy()), 8, 8, "int2", "fp4_e2m1", "max", 2.0,
        [0], 16, max_outliers_per_block=2)
    dec["block_size"] = 16
    p = pk.pack_outlier_nb(dec, budget=2)
    p = dataclasses.replace(p, **{f: getattr(p, f).to(dev) for f in (
        "codes", "scale_exp", "out_byte", "out_scale_exp")})
    x = torch.from_numpy(rng.standard_normal((300, 512)).astype(np.float32))
    return p, x.to(dev)


def _sideband_case(dev):
    """A side-band weight (int2 inliers, fp4 outliers, block 16, budget 4,
    made on the CPU) and x, moved to ``dev``."""
    rng = np.random.default_rng(4)
    W = (rng.standard_normal((512, 384)) * 0.02).astype(np.float32)
    W[rng.random(W.shape) < 0.03] *= 10.0
    p = pk.pack_mx_outlier(torch.from_numpy(W), 8, 8, "int2", "fp4_e2m1",
                           std_dev=2.0, block_size=16, outlier_budget=4,
                           axis=0)
    p = dataclasses.replace(
        p, inlier=dataclasses.replace(p.inlier,
                                      codes=p.inlier.codes.to(dev),
                                      scale_exp=p.inlier.scale_exp.to(dev)),
        **{f: getattr(p, f).to(dev) for f in ("out_codes", "out_pos",
                                             "out_scale_exp")})
    x = torch.from_numpy(rng.standard_normal((300, 512)).astype(np.float32))
    return p, x.to(dev)


def _digest(y: torch.Tensor) -> str:
    return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]


def digests(device="cuda") -> dict:
    dev = resolve_device(device)
    out = {}
    for fmt, transport, bs, scale in DECODES:
        p, x = _case(fmt, transport, bs, scale, dev)
        out[f"{fmt}_{transport}_b{bs}"] = {
            kind: _digest(fn(x[:m], p))
            for kind, fn, m in (("gemv", dm.dequant_gemv, 8),
                                ("gemm", dm.dequant_gemm, 300))}
    p, x = _nb_case(dev)
    out["int2_fp4_nb_b16"] = {
        kind: _digest(fn(x[:m], p))
        for kind, fn, m in (("gemv", om.dequant_gemv_nb, 8),
                            ("gemm", om.dequant_gemm_nb, 300))}
    p, x = _sideband_case(dev)
    out["int2_fp4_sideband_b16"] = {
        kind: _digest(fn(x[:m], p))
        for kind, fn, m in (("gemv", om.dequant_gemv_outlier, 8),
                            ("gemm", om.dequant_gemm_outlier, 300))}
    return out


def main(argv=None, *, device="cuda") -> dict:
    argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0],
        epilog="Runs on the CUDA card; prints one JSON line.").parse_args(argv)
    got = digests(device)
    print(json.dumps(got, sort_keys=True), flush=True)
    return got


if __name__ == "__main__":
    main()
