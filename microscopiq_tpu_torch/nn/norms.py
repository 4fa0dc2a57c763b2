"""RMSNorm and LayerNorm (the plain branches of
``microscopiq_tpu/nn/norms.py``).

The fake-quant ``mx_specs`` branches belong to the training path (ROADMAP
queue 1 item 9).
"""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x*x) + eps) * scale``, computed in x's dtype (bf16 at
    serving) exactly as the JAX module does; a float32 ``scale`` promotes
    the output to float32, as in JAX."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.scale


class LayerNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * scale (+ bias)`` over the last
    axis, the population variance, in x's dtype as the JAX module computes
    it: OPT's norms with a bias, MPT's without (``use_bias=False``)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 use_bias: bool = True):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features) if use_bias
                             else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale
        return y if self.bias is None else y + self.bias
