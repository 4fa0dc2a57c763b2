"""OPT (facebook/opt-*) in PyTorch.

Counterpart of ``microscopiq_tpu/models/opt.py``: learned positional
embeddings with OPT's +2 offset, pre-LayerNorm decoder blocks (post-LN with
``do_layer_norm_before=False``), a ReLU FFN, a final LayerNorm and tied
embeddings (the opt-125m configuration). Linears are the Llama module's
:class:`QLinear` with a bias: a dense (K, N) kernel or a packed weight,
through the kernels or their plain twins. The fake-quant ``mx_specs``
branch of LayerNorm and ReLU is ROADMAP queue 1 item 9 and raises.

Weights are a flax-named nested dict (``layers_{i}/self_attn/q_proj/
{kernel,bias}``, ``layers_{i}/self_attn_layer_norm/{scale,bias}``,
``embed_tokens``, ``embed_positions``, ``final_layer_norm/...``), made by
:func:`build_params` or ``convert.params_from_jax`` and installed with
:meth:`OPTForCausalLM.load_params`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .llama import QLinear, causal_mask, install_tree


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    tie_word_embeddings: bool = True
    dtype: Any = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        """Every head keeps its own K/V (the KV cache's geometry)."""
        return self.num_attention_heads

    @staticmethod
    def opt_125m(**kw) -> "OPTConfig":
        return OPTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "OPTConfig":
        base = dict(vocab_size=256, hidden_size=64, ffn_dim=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=128)
        base.update(kw)
        return OPTConfig(**base)


class LayerNorm(nn.Module):
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over the last axis
    (the plain branch of ``microscopiq_tpu/nn/norms.py::LayerNorm``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale \
            + self.bias


class OPTAttention(nn.Module):
    def __init__(self, cfg: OPTConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.q_proj = QLinear(cfg.dtype, use_kernels)
        self.k_proj = QLinear(cfg.dtype, use_kernels)
        self.v_proj = QLinear(cfg.dtype, use_kernels)
        self.out_proj = QLinear(cfg.dtype, use_kernels)

    def forward(self, x, mask, cache=None, layer_idx: int = 0,
                positions=None):
        H, hd = self.cfg.num_attention_heads, self.cfg.head_dim
        B, S, _ = x.shape
        q = self.q_proj(x).reshape(B, S, H, hd)
        k = self.k_proj(x).reshape(B, S, H, hd)
        v = self.v_proj(x).reshape(B, S, H, hd)
        if cache is not None:
            k, v, mask = cache.update(layer_idx, k, v, positions, mask)
        dt = torch.promote_types(q.dtype, k.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(dt), k.to(dt)
                              ) * hd ** -0.5
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits.to(torch.float32), -1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, -1)
        return self.out_proj(out)


class OPTLayer(nn.Module):
    def __init__(self, cfg: OPTConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.self_attn_layer_norm = LayerNorm(cfg.hidden_size)
        self.final_layer_norm = LayerNorm(cfg.hidden_size)
        self.self_attn = OPTAttention(cfg, use_kernels)
        self.fc1 = QLinear(cfg.dtype, use_kernels)
        self.fc2 = QLinear(cfg.dtype, use_kernels)

    def forward(self, x, mask, cache=None, layer_idx: int = 0,
                positions=None):
        ln1, ln2 = self.self_attn_layer_norm, self.final_layer_norm
        if self.cfg.do_layer_norm_before:
            x = x + self.self_attn(ln1(x), mask, cache, layer_idx, positions)
            return x + self.fc2(F.relu(self.fc1(ln2(x))))
        x = ln1(x + self.self_attn(x, mask, cache, layer_idx, positions))
        return ln2(x + self.fc2(F.relu(self.fc1(x))))


class OPTForCausalLM(nn.Module):
    """OPT decoder with tied logits; weights go in with :meth:`load_params`.
    ``device`` defaults to "cuda" and must exist; pass ``device="cpu"`` to
    run the plain versions on the CPU."""

    def __init__(self, cfg: OPTConfig, use_kernels: bool = True,
                 mx_specs=None, device="cuda"):
        super().__init__()
        if mx_specs is not None:
            raise NotImplementedError(
                "fake-quant mx_specs layers (LayerNorm, ReLU, linears) are "
                "not ported yet (ROADMAP queue 1 item 9)")
        if not cfg.tie_word_embeddings:
            raise NotImplementedError(
                "an untied OPT lm_head is not ported (the JAX package's "
                "configs all tie it)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.embed_tokens = None        # (vocab, D), set by load_params
        self.embed_positions = None     # (max_positions + 2, D)
        self.layers = nn.ModuleList([OPTLayer(cfg, use_kernels)
                                     for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = LayerNorm(cfg.hidden_size)

    def load_params(self, params) -> "OPTForCausalLM":
        """Install a flax-named weight tree (``{"params": ...}`` or bare)."""
        install_tree(self, params.get("params", params), self.device)
        for name, mod in self.named_modules():
            if isinstance(mod, QLinear) and mod.kernel is None:
                raise KeyError(f"no kernel for {name} in the weight tree")
        if self.embed_tokens is None or self.embed_positions is None:
            raise KeyError("no embed_tokens / embed_positions in the tree")
        return self

    def forward(self, input_ids, positions=None, mask=None, cache=None,
                last_only: bool = False, logit_index=None):
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, device=input_ids.device
                                     )[None, :].expand(B, S)
        if mask is None and cache is None:
            mask = causal_mask(S, positions)
        x = self.embed_tokens[input_ids] + self.embed_positions[positions + 2]
        for i, layer in enumerate(self.layers):
            x = layer(x, mask, cache, i, positions)
        if self.cfg.do_layer_norm_before:
            x = self.final_layer_norm(x)
        if last_only:
            x = x[:, -1:]
        elif logit_index is not None:
            idx = torch.as_tensor(logit_index, device=x.device).long()
            x = torch.gather(x, 1, idx[:, None, None].expand(
                x.shape[0], 1, x.shape[-1]))
        return x @ self.embed_tokens.T


def build_params(cfg: OPTConfig, seed: int = 0, device="cuda"):
    """Random weight tree for :class:`OPTForCausalLM`: N(0, 0.02) weights in
    ``cfg.dtype`` from ``seed``, zero biases, unit LayerNorm scales."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, F_ = cfg.hidden_size, cfg.ffn_dim

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02
                ).to(cfg.dtype)

    def linear(k, n):
        return {"kernel": normal((k, n)),
                "bias": torch.zeros(n, dtype=cfg.dtype, device=dev)}

    def norm():
        return {"scale": torch.ones(D, dtype=cfg.dtype, device=dev),
                "bias": torch.zeros(D, dtype=cfg.dtype, device=dev)}

    tree = {"embed_tokens": normal((cfg.vocab_size, D)),
            "embed_positions": normal((cfg.max_position_embeddings + 2, D))}
    for i in range(cfg.num_hidden_layers):
        tree[f"layers_{i}"] = {
            "self_attn": {p: linear(D, D) for p in
                          ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": norm(), "final_layer_norm": norm(),
            "fc1": linear(D, F_), "fc2": linear(F_, D)}
    tree["final_layer_norm"] = norm()
    return {"params": tree}
