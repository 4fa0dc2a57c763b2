"""Train a small residual MLP with MX fake-quant layers.

    python -m microscopiq_tpu_torch.scripts.mx_ffn [--steps 200] [--dim 128]
        [--device cuda] [--seed 0] [MX spec flags]

Counterpart of ``examples/mx_ffn.py``: y = x + W2 gelu(W1 x) with both
products through ``nn.linear``'s MX linear and the GELU quantized, fit to
sin(x) on 256 rows by full-batch SGD at lr 0.1. Without spec flags the
config is the reference's canonical one (fp6_e3m2 weights and
activations, scale_bits 4, block 32, bfloat16 containers) with
``quantize_backprop`` off: at scale_bits 4 the shared exponent is clamped
to [-8, 7], and the training gradients (~2^-13) would flush to zero.

The start (W1 (D, 4D), W2 (4D, D), x (256, D)) is drawn by numpy from
``--seed``; :func:`train` also takes a start from the caller. Prints the
mse at every 50th step and the last, then the final mse.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..nn import gelu, linear
from ..specs import MxSpecs, add_mx_args, finalize_mx_specs, get_mx_specs

ROWS = 256
LR = 0.1


def default_specs() -> MxSpecs:
    """The canonical config, with quantize_backprop off."""
    return finalize_mx_specs({
        "w_elem_format": "fp6_e3m2", "a_elem_format": "fp6_e3m2",
        "scale_bits": 4, "block_size": 32, "bfloat": 16,
        "quantize_backprop": False})


def numpy_start(dim: int = 128, seed: int = 0, rows: int = ROWS):
    """(W1, W2, x) as float32 numpy arrays: N(0, 1/D) and N(0, 1/4D)
    weights, N(0, 1) rows."""
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((dim, 4 * dim)) * dim ** -0.5
    w2 = rng.standard_normal((4 * dim, dim)) * (4 * dim) ** -0.5
    x = rng.standard_normal((rows, dim))
    return tuple(a.astype(np.float32) for a in (w1, w2, x))


def forward(w1, w2, x, specs):
    h = gelu(linear(x, w1.T, None, specs), specs)
    return x + linear(h, w2.T, None, specs)


def train(start, steps: int = 200, specs: Optional[MxSpecs] = None,
          device="cuda", lr: float = LR, log=None) -> List[float]:
    """Full-batch SGD from ``start`` = (W1, W2, x) (numpy or tensors) on
    ``device``; returns the mse before each step's update. ``log(i, mse)``
    is called at every 50th step and the last."""
    dev = resolve_device(device)
    specs = default_specs() if specs is None else specs
    # copies: the updates below are in place, and the start stays as given
    w1, w2, x = (torch.tensor(np.asarray(a), dtype=torch.float32,
                              device=dev) for a in start)
    w1.requires_grad_(True)
    w2.requires_grad_(True)
    target = torch.sin(x)
    losses = []
    for i in range(steps):
        loss = torch.mean((forward(w1, w2, x, specs) - target) ** 2)
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        with torch.no_grad():
            w1 -= lr * g1
            w2 -= lr * g2
        losses.append(float(loss.detach()))
        if log is not None and (i % 50 == 0 or i == steps - 1):
            log(i, losses[-1])
    return losses


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_mx_args(parser)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.w_elem_format is None:
        specs = default_specs()
    else:
        specs = finalize_mx_specs(dataclasses.replace(
            get_mx_specs(args), quantize_backprop=False))
    losses = train(numpy_start(args.dim, args.seed), args.steps, specs,
                   args.device,
                   log=lambda i, m: print(f"step {i:4d}  mse {m:.5f}"))
    print(f"final mse (MX {specs['w_elem_format']}): {losses[-1]:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
