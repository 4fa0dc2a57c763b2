"""CLIP ViT vision tower in PyTorch.

Counterpart of ``microscopiq_tpu/vlm/clip.py``: a pre-LN ViT (LLaVA-1.5's
``openai/clip-vit-large-patch14-336`` by default) whose hidden states the
LLaVA tower selects from (``select_layer``, default -2; ``"patch"`` drops
the CLS token, ``"cls_patch"`` keeps it). Every linear is a plain
``torch.matmul`` plus bias, as flax's ``Dense`` computes it in XLA outside
any kernel; the tower is never weight-quantized (LLaVA's GPTQ calibration
quantizes only the language model).

Layouts follow the flax tree, so that a tree moved from the JAX package by
``convert.params_from_jax`` installs as it is:

- pixels are NHWC, (B, H, W, 3);
- the patch embedding's ``kernel`` is flax's conv layout (kh, kw, in, out).
  The convolution (stride = kernel = patch) is one matmul of each patch,
  flattened in (kh, kw, c) order, by that kernel reshaped to
  (kh * kw * in, out). flax's default ``SAME`` padding pads nothing when
  the image size is a multiple of the patch size, which every config has;
  another size raises ValueError here (in JAX the position embedding then
  fails to broadcast);
- a linear's ``kernel`` is (in, out); LayerNorms hold ``scale`` and
  ``bias``. The HF name ``pre_layrnorm`` (sic) is kept.

LayerNorm is flax's arithmetic: the fast variance mean(x^2) - mean(x)^2
(clamped at 0) and ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.
Attention divides q.k by sqrt(head_dim) and takes the softmax in float32,
cast back to the activations' dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # + CLS

    @staticmethod
    def tiny(**kw) -> "CLIPVisionConfig":
        base = dict(hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    image_size=16, patch_size=8)
        base.update(kw)
        return CLIPVisionConfig(**base)

    @staticmethod
    def vit_large_336(**kw) -> "CLIPVisionConfig":
        """openai/clip-vit-large-patch14-336 (LLaVA-1.5 default tower)."""
        return CLIPVisionConfig(**kw) if kw else CLIPVisionConfig()


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Dense(nn.Module):
    """flax ``Dense``: ``x @ kernel + bias`` with the inputs, the (in, out)
    kernel and the bias cast to ``dtype``."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = None          # set by install_tree
        self.bias = None

    def forward(self, x):
        dt = self.dtype
        return torch.matmul(x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


class FlaxLayerNorm(nn.Module):
    """flax ``LayerNorm`` over the last axis (statistics in float32)."""

    def __init__(self, eps: float, dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = None
        self.bias = None

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, Dense(cfg.dtype))

    def forward(self, x):
        cfg = self.cfg
        H = cfg.num_attention_heads
        hd = cfg.hidden_size // H
        B, S, D = x.shape
        q = self.q_proj(x).reshape(B, S, H, hd).transpose(1, 2)
        k = self.k_proj(x).reshape(B, S, H, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(B, S, H, hd).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.softmax(attn.to(torch.float32), dim=-1).to(x.dtype)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(B, S, D)
        return self.out_proj(o)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = Dense(cfg.dtype)
        self.fc2 = Dense(cfg.dtype)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN block: attention and MLP each on a LayerNorm of the residual."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layer_norm1 = FlaxLayerNorm(cfg.layer_norm_eps, cfg.dtype)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = FlaxLayerNorm(cfg.layer_norm_eps, cfg.dtype)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class PatchEmbedding(nn.Module):
    """The stride-``p`` convolution of kernel ``p`` (no bias) on NHWC
    pixels, as one matmul of the (kh, kw, c)-ordered patches."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.kernel = None          # (p, p, 3, D), flax's conv layout

    def forward(self, pixel_values):
        p, dt = self.cfg.patch_size, self.cfg.dtype
        B, Hh, Ww, C = pixel_values.shape
        if Hh % p or Ww % p:
            raise ValueError(f"image {Hh}x{Ww} is no multiple of the patch "
                             f"size {p}")
        x = pixel_values.to(dt).reshape(B, Hh // p, p, Ww // p, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, -1, p * p * C)
        return torch.matmul(x, self.kernel.to(dt).reshape(p * p * C, -1))


class CLIPVisionModel(nn.Module):
    """Returns the hidden states (the embeddings', then one per layer)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embedding = PatchEmbedding(cfg)
        self.class_embedding = None         # (D,)
        self.position_embedding = None      # (num_positions, D)
        self.pre_layrnorm = FlaxLayerNorm(cfg.layer_norm_eps, cfg.dtype)
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])

    def forward(self, pixel_values, num_layers: Optional[int] = None
                ) -> List[torch.Tensor]:
        """Every hidden state, or the first ``num_layers + 1`` of them (the
        later layers are not run: their states would go unused)."""
        cfg, dt = self.cfg, self.cfg.dtype
        patches = self.patch_embedding(pixel_values)
        B = patches.shape[0]
        cls = self.class_embedding.to(dt).expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, patches], dim=1)
        x = x + self.position_embedding.to(dt)[None]
        x = self.pre_layrnorm(x)
        hidden_states = [x]
        n = cfg.num_hidden_layers if num_layers is None else num_layers
        for layer in self.layers[:n]:
            x = layer(x)
            hidden_states.append(x)
        return hidden_states


class CLIPVisionTower(nn.Module):
    """Feature-select wrapper: the hidden state ``select_layer`` (an index
    into the L + 1 states), without CLS (``"patch"``) or with it
    (``"cls_patch"``); any other ``select_feature`` raises ValueError when
    called, as in JAX."""

    def __init__(self, cfg: CLIPVisionConfig, select_layer: int = -2,
                 select_feature: str = "patch"):
        super().__init__()
        self.cfg = cfg
        self.select_layer = select_layer
        self.select_feature = select_feature
        self.vision_model = CLIPVisionModel(cfg)

    def forward(self, pixel_values):
        n = self.cfg.num_hidden_layers + 1
        if not -n <= self.select_layer < n:
            raise IndexError(f"select_layer {self.select_layer} of {n} "
                             "hidden states")
        idx = self.select_layer % n
        feats = self.vision_model(pixel_values, num_layers=idx)[idx]
        if self.select_feature == "patch":
            feats = feats[:, 1:]
        elif self.select_feature != "cls_patch":
            raise ValueError(f"bad select_feature {self.select_feature}")
        return feats


def _tensor(v) -> torch.Tensor:
    """A state-dict value as a tensor (torch tensors stay where they are,
    numpy arrays come to the CPU)."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def convert_hf_clip_vision(state_dict, cfg: CLIPVisionConfig,
                           prefix: str = "vision_model.") -> dict:
    """HF ``CLIPVisionModel`` state dict (torch tensors or numpy arrays) ->
    the CLIPVisionTower weight tree: conv (out, in, kh, kw) -> (kh, kw, in,
    out), linears (out, in) -> (in, out)."""
    def a(k):
        return _tensor(state_dict[prefix + k])

    vm = {
        "class_embedding": a("embeddings.class_embedding"),
        "position_embedding": a("embeddings.position_embedding.weight"),
        "patch_embedding": {"kernel": a(
            "embeddings.patch_embedding.weight").permute(2, 3, 1, 0
                                                         ).contiguous()},
        "pre_layrnorm": {"scale": a("pre_layrnorm.weight"),
                         "bias": a("pre_layrnorm.bias")},
    }
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layers.{i}."

        def lin(n):
            return {"kernel": a(p + n + ".weight").T.contiguous(),
                    "bias": a(p + n + ".bias")}

        def ln(n):
            return {"scale": a(p + n + ".weight"), "bias": a(p + n + ".bias")}

        vm[f"layers_{i}"] = {
            "self_attn": {n: lin("self_attn." + n)
                          for n in ("q_proj", "k_proj", "v_proj",
                                    "out_proj")},
            "mlp": {"fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")},
            "layer_norm1": ln("layer_norm1"),
            "layer_norm2": ln("layer_norm2"),
        }
    return {"vision_model": vm}
