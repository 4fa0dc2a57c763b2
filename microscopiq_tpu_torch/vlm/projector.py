"""Multimodal projector (vision features -> the language model's embedding
space).

Counterpart of ``microscopiq_tpu/vlm/projector.py``: ``identity``,
``linear``, and ``mlpNx_gelu`` (N linears with exact, erf-based GELU
between them). Each linear is flax's ``Dense`` in ``dtype`` (the text
tower's), a plain ``torch.matmul`` as XLA computes it in JAX.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from .clip import Dense, _tensor


def projector_depth(projector_type: str) -> int:
    """Linears of a projector type; unknown types raise ValueError."""
    if projector_type == "identity":
        return 0
    if projector_type == "linear":
        return 1
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if not m:
        raise ValueError(f"unknown projector type {projector_type!r}")
    return int(m.group(1))


class VisionProjector(nn.Module):
    """projector_type in {'linear', 'mlp2x_gelu', ..., 'identity'}; the
    linears ``layers_{i}`` hold (in, out) kernels and biases. The type is
    checked when the module is built (JAX checks it when called)."""

    def __init__(self, out_features: int, projector_type: str = "mlp2x_gelu",
                 dtype=torch.float32):
        super().__init__()
        self.out_features = out_features
        self.projector_type = projector_type
        self.dtype = dtype
        self.layers = nn.ModuleList(
            [Dense(dtype) for _ in range(projector_depth(projector_type))])

    def forward(self, x):
        if not len(self.layers):
            return x
        x = self.layers[0](x)
        for lin in self.layers[1:]:
            x = lin(F.gelu(x, approximate="none"))
        return x


def convert_hf_projector(state_dict, projector_type: str = "mlp2x_gelu",
                         prefix: str = "model.mm_projector.") -> dict:
    """HF LLaVA ``mm_projector`` weights (0.weight, 2.weight, ...: GELU
    modules sit at the odd indices) -> the projector's weight tree."""
    params = {}
    i_tree = i_hf = 0
    while f"{prefix}{i_hf}.weight" in state_dict:
        params[f"layers_{i_tree}"] = {
            "kernel": _tensor(state_dict[f"{prefix}{i_hf}.weight"]
                              ).T.contiguous(),
            "bias": _tensor(state_dict[f"{prefix}{i_hf}.bias"])}
        i_tree += 1
        i_hf += 2
    if not params and projector_type != "identity":
        raise KeyError(f"no projector weights under {prefix}")
    return params
