"""Llama-family decoder (Llama 2/3 geometry) in PyTorch.

Counterpart of ``microscopiq_tpu/models/llama.py`` for the serving path:
RoPE, RMSNorm, GQA attention by grouped einsum (K/V are never repeated),
SwiGLU MLP, optional fused ``qkv_proj``/``gate_up_proj``, a dense or quantized
KV cache, and ``last_only``/``logit_index`` logits. Linears hold a dense
(K, N) kernel, a :class:`PackedMX`, a side-band :class:`PackedMXOutlier` or a
compact :class:`PackedOutlierNB`; packed ones run through the CUDA kernels
(``use_kernels=True``, the counterpart of ``use_pallas``) or their plain twin.
A decode step over a quantized cache goes through the fused flash-decode
kernel (``ops/cuda/quant_attention.py``) where the cache's layout allows and
the kernel takes the geometry (``decode_route``: head_dim, query heads per
KV head, gap, bits, V group, rank), else through ``cache.update``; the
choice is the same on every device.

Weights are a flax-named nested dict (``model/layers_{i}/self_attn/
qkv_proj/kernel``, ``model/norm/scale``, ``lm_head/kernel``, ...), made by
:func:`build_params` or :func:`microscopiq_tpu_torch.convert.params_from_jax`
and installed with :meth:`LlamaForCausalLM.load_params`.

Branches of the JAX module outside this slice raise ``NotImplementedError``
naming their ROADMAP item: ALiBi/MPT, sliding window, MoE (queue 1 item 10)
and fake-quant ``mx_specs`` (item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..kv.cache import QuantizedDecodeCache, SlotQuantizedDecodeCache
from ..nn.norms import RMSNorm
from ..ops.cuda.dequant_matmul import (dequant_matmul,
                                       dequant_matmul_reference)
from ..ops.cuda.outlier_matmul import (dequant_matmul_nb,
                                       dequant_matmul_nb_reference,
                                       dequant_matmul_outlier,
                                       dequant_matmul_outlier_reference)
from ..ops.cuda.quant_attention import decode_route, quant_attention_decode
from ..ops.packing import (PackedMX, PackedMXOutlier, PackedOutlierNB,
                           pack_mx, to_serving_layout)

_PACKED = (PackedMX, PackedMXOutlier, PackedOutlierNB)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    tie_word_embeddings: bool = False
    pos_emb: str = "rope"
    norm_type: str = "rms"
    mlp_type: str = "swiglu"
    alibi_bias_max: float = 8.0
    dtype: Any = torch.float32
    fused_projections: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=128256, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=8192, rope_theta=500000.0)
        base.update(kw)
        return LlamaConfig(**base)


def _check_in_slice(cfg: LlamaConfig) -> None:
    family = {"pos_emb": (cfg.pos_emb, "rope"),
              "norm_type": (cfg.norm_type, "rms"),
              "mlp_type": (cfg.mlp_type, "swiglu"),
              "tie_word_embeddings": (cfg.tie_word_embeddings, False),
              "sliding_window": (cfg.sliding_window, None),
              "num_local_experts": (cfg.num_local_experts, 0)}
    for name, (got, want) in family.items():
        if got != want:
            raise NotImplementedError(
                f"{name}={got!r} (MPT/ALiBi, Mistral sliding window, Mixtral "
                "MoE) is not ported yet (ROADMAP queue 1 item 10)")


def rope(q, k, positions, head_dim, theta):
    """Rotary embeddings, computed in float32 and cast back."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=q.device) / head_dim))
    angles = positions[..., None].to(torch.float32) * freqs   # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


class QLinear(nn.Module):
    """Linear whose kernel is a dense (K, N) tensor or a packed weight.

    With ``use_kernels`` every packed weight goes to its kernel wrapper,
    which picks the GEMV or the GEMM by token count: ``dequant_matmul``
    for a PackedMX, ``dequant_matmul_nb`` and ``dequant_matmul_outlier``
    for the outlier formats (their GEMMs take the 256 tokens and more that
    the JAX ``QLinear`` leaves to XLA). Without it, the plain twins. A
    ``bias`` (OPT's linears) is added to the product.
    """

    def __init__(self, dtype, use_kernels: bool = True):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.kernel = None          # set by load_params
        self.bias = None            # (N,), added after the product (OPT)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel
        if isinstance(w, PackedMX):
            f = dequant_matmul if self.use_kernels else dequant_matmul_reference
            y = f(x, w, out_dtype=self.dtype)
        elif isinstance(w, PackedOutlierNB):
            f = (dequant_matmul_nb if self.use_kernels
                 else dequant_matmul_nb_reference)
            y = f(x, w, out_dtype=self.dtype)
        elif isinstance(w, PackedMXOutlier):
            f = (dequant_matmul_outlier if self.use_kernels
                 else dequant_matmul_outlier_reference)
            y = f(x, w, out_dtype=self.dtype)
        elif isinstance(w, torch.Tensor):
            dt = torch.promote_types(x.dtype, w.dtype)
            y = torch.matmul(x.to(dt), w.to(dt))
        else:
            raise TypeError(f"kernel of type {type(w).__name__} is neither a "
                            "dense tensor nor a packed weight")
        return y if self.bias is None else y + self.bias


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        mk = lambda: QLinear(cfg.dtype, use_kernels)
        if cfg.fused_projections:
            self.qkv_proj = mk()
        else:
            self.q_proj = mk()
            self.k_proj = mk()
            self.v_proj = mk()
        self.o_proj = mk()

    def forward(self, x, positions, mask, cache=None, layer_idx: int = 0):
        cfg = self.cfg
        H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        B, S, _ = x.shape
        if cfg.fused_projections:
            qkv = self.qkv_proj(x)
            q = qkv[..., :H * hd].reshape(B, S, H, hd)
            k = qkv[..., H * hd:(H + KVH) * hd].reshape(B, S, KVH, hd)
            v = qkv[..., (H + KVH) * hd:].reshape(B, S, KVH, hd)
        else:
            q = self.q_proj(x).reshape(B, S, H, hd)
            k = self.k_proj(x).reshape(B, S, KVH, hd)
            v = self.v_proj(x).reshape(B, S, KVH, hd)
        q, k = rope(q, k, positions, hd, cfg.rope_theta)

        scale = hd ** -0.5
        if cache is not None:
            if (S == 1 and self.use_kernels and cfg.pos_emb == "rope"
                    and isinstance(cache, (QuantizedDecodeCache,
                                           SlotQuantizedDecodeCache))
                    and cache.cfg.n_k_groups == 1
                    and cache.cfg.residual_len == 0
                    and cache.cfg.out_k == 0
                    and decode_route(hd, H // KVH, cache.cfg.gap,
                                     cache.cfg.bits, cache.cfg.v_group,
                                     cache.cfg.rank) == "fused"):
                # fused flash decode over the packed KV cache, where the
                # kernel takes the geometry: the dense K/V of the chunks
                # never exist in device memory
                full, new_len = cache.ingest_for_fused(layer_idx, k, v)
                out = quant_attention_decode(q[:, 0], full, layer_idx,
                                             new_len, cache.cfg.v_group,
                                             scale)
                return self.o_proj(out.reshape(B, 1, H * hd))
            k, v, mask = cache.update(layer_idx, k, v, positions, mask)
        # a bf16 cache under a float32 model promotes as jnp.einsum does
        dt = torch.promote_types(q.dtype, k.dtype)
        q, k = q.to(dt), k.to(dt)
        neg = torch.finfo(torch.float32).min
        G = k.shape[2]
        rep = H // G
        if rep > 1:
            # GQA by grouped einsum: repeated K/V are never materialized
            qg = q.reshape(B, S, G, rep, hd)
            logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k
                                  ).to(torch.float32) * scale
            logits = torch.where(mask[:, :, None], logits, neg)
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k
                                  ).to(torch.float32) * scale
            logits = torch.where(mask, logits, neg)
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.o_proj(out.reshape(B, S, H * hd))


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        I = cfg.intermediate_size
        mk = lambda: QLinear(cfg.dtype, use_kernels)
        if cfg.fused_projections:
            self.gate_up_proj = mk()
        else:
            self.gate_proj = mk()
            self.up_proj = mk()
        self.down_proj = mk()

    def forward(self, x):
        I = self.cfg.intermediate_size
        if self.cfg.fused_projections:
            gu = self.gate_up_proj(x)
            gate, up = gu[..., :I], gu[..., I:]
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Attention(cfg, use_kernels)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = MLP(cfg, use_kernels)

    def forward(self, x, positions, mask, cache=None, layer_idx: int = 0):
        x = x + self.self_attn(self.input_layernorm(x), positions, mask,
                               cache, layer_idx)
        return x + self.mlp(self.post_attention_layernorm(x))


def causal_mask(S: int, positions) -> torch.Tensor:
    """(B, 1, S, S) boolean mask: key position <= query position."""
    qp = positions[:, :, None]
    kp = positions[:, None, :]
    return (kp <= qp)[:, None, :, :]


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = None        # (vocab, D), set by load_params
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, use_kernels)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids, positions=None, mask=None, cache=None):
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, device=input_ids.device
                                     )[None, :].expand(B, S)
        if mask is None and cache is None:
            mask = causal_mask(S, positions)
        x = self.embed_tokens[input_ids]
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, mask, cache, i)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama decoder with its lm_head; weights go in with :meth:`load_params`.

    ``device`` defaults to "cuda" and must exist; pass ``device="cpu"`` to
    run the plain versions on the CPU.
    """

    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True,
                 mx_specs=None, device="cuda"):
        super().__init__()
        if mx_specs is not None:
            raise NotImplementedError(
                "fake-quant mx_specs layers are not ported yet "
                "(ROADMAP queue 1 item 9)")
        _check_in_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = LlamaModel(cfg, use_kernels)
        self.lm_head = QLinear(cfg.dtype, use_kernels)

    def load_params(self, params) -> "LlamaForCausalLM":
        """Install a flax-named weight tree (``{"params": ...}`` or bare)."""
        install_tree(self, params.get("params", params), self.device)
        for name, mod in self.named_modules():
            if isinstance(mod, QLinear) and mod.kernel is None:
                raise KeyError(f"no kernel for {name} in the weight tree")
        if self.model.embed_tokens is None:
            raise KeyError("no model/embed_tokens in the weight tree")
        return self

    def forward(self, input_ids, positions=None, mask=None, cache=None,
                last_only: bool = False, logit_index=None):
        x = self.model(input_ids, positions, mask, cache)
        if last_only:
            x = x[:, -1:]
        elif logit_index is not None:
            # right-padded prefill: the hidden state at each row's last real
            # token, gathered before the lm_head
            idx = torch.as_tensor(logit_index, device=x.device).long()
            x = torch.gather(x, 1, idx[:, None, None].expand(
                x.shape[0], 1, x.shape[-1]))
        return self.lm_head(x)


def install_tree(module: nn.Module, tree: dict, device: torch.device,
                 path: str = "") -> None:
    """Install a flax-named weight tree into ``module``: a subtree goes to
    the child module of its name (``layers_{i}`` to ``layers[i]``); a leaf
    to the buffer or the attribute of its name (``kernel``, ``bias``,
    ``scale``, ``embed_tokens``, ...), which the module must have; every
    leaf a tensor or a packed weight on ``device``."""
    for key, val in tree.items():
        where = f"{path}/{key}" if path else key
        if isinstance(val, dict):
            layers = getattr(module, "layers", None)
            if isinstance(layers, nn.ModuleList) and key.startswith(
                    "layers_"):
                child = layers[int(key[len("layers_"):])]
            elif isinstance(getattr(module, key, None), nn.Module):
                child = getattr(module, key)
            else:
                raise KeyError(f"weight tree entry {where} has no module")
            install_tree(child, val, device, where)
            continue
        held = getattr(module, key, KeyError)
        if not (held is None or isinstance(held, (torch.Tensor,) + _PACKED)):
            raise KeyError(f"unexpected weight {where}")
        if not isinstance(val, (torch.Tensor,) + _PACKED):
            raise TypeError(f"{where}: {type(val).__name__} is not a tensor "
                            "or a packed weight")
        if val.device.type != device.type or (
                device.index is not None and val.device.index != device.index):
            raise ValueError(f"{where} is on {val.device}, model on {device}")
        if key in module._buffers:
            module.register_buffer(key, val)
        else:
            setattr(module, key, val)


def build_params(cfg: LlamaConfig, seed: int = 0, packed_specs=None,
                 device="cuda"):
    """Random weight tree for :class:`LlamaForCausalLM`, layer by layer.

    Counterpart of ``bench.py::build_params``: N(0, 0.02) bf16 weights made
    on ``device`` from ``seed``; with ``packed_specs`` every linear (the
    lm_head included) is packed by :func:`pack_mx` (axis 0, emi8 for fp4/fp6
    formats) into the pre-blocked serving layout. Projections stay unfused;
    pass the tree through ``nn.fuse_projections`` for a fused model.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def dense(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16) * 0.02

    def kernel(shape):
        w = dense(shape)
        if packed_specs is None:
            return w
        fmt = packed_specs["w_elem_format"]
        transport = ("emi8" if fmt in ("fp4", "fp4_e2m1", "fp6_e3m2",
                                       "fp6_e2m3") else "native")

        def one(wc):
            return to_serving_layout(pack_mx(
                wc.to(torch.float32), packed_specs["scale_bits"] or 8, fmt,
                packed_specs["block_size"], axis=0, transport=transport))

        K, N = shape
        if K * N > 256 * 1024 * 1024 and N % 8 == 0:
            # chunk giant matrices (lm_head) along N to bound the quantizer's
            # float32 temporaries; packing is per column, so codes are equal
            parts = [one(w[:, i * (N // 8):(i + 1) * (N // 8)])
                     for i in range(8)]
            return dataclasses.replace(
                parts[0], codes=torch.cat([q.codes for q in parts], dim=-1),
                scale_exp=torch.cat([q.scale_exp for q in parts], dim=-1))
        return one(w)

    ones = lambda: torch.ones(D, dtype=cfg.dtype, device=dev)
    model = {"embed_tokens": dense((cfg.vocab_size, D)).to(cfg.dtype)}
    lm_head = kernel((D, cfg.vocab_size))
    for i in range(cfg.num_hidden_layers):
        model[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": {"kernel": kernel((D, H * hd))},
                "k_proj": {"kernel": kernel((D, KVH * hd))},
                "v_proj": {"kernel": kernel((D, KVH * hd))},
                "o_proj": {"kernel": kernel((H * hd, D))},
            },
            "mlp": {
                "gate_proj": {"kernel": kernel((D, I))},
                "up_proj": {"kernel": kernel((D, I))},
                "down_proj": {"kernel": kernel((I, D))},
            },
            "input_layernorm": {"scale": ones()},
            "post_attention_layernorm": {"scale": ones()},
        }
    model["norm"] = {"scale": ones()}
    return {"params": {"model": model, "lm_head": {"kernel": lm_head}}}
