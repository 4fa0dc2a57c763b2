"""Llama-family decoder (Llama 2/3, Mistral, Mixtral, MPT) in PyTorch.

Counterpart of ``microscopiq_tpu/models/llama.py`` for the serving path:
RoPE or ALiBi, RMSNorm or a biasless LayerNorm, GQA attention by grouped
einsum (K/V are never repeated), a SwiGLU or exact-GELU MLP or Mixtral's
top-k mixture of experts (every expert computed on every token, combined by
the JAX module's one-hot einsums), Mistral's sliding window on a cacheless
forward, optional fused ``qkv_proj``/``gate_up_proj``, a dense or quantized
KV cache, tied or separate logits, and ``last_only``/``logit_index``
logits. Linears hold a dense (K, N) kernel, a :class:`PackedMX`, a
side-band :class:`PackedMXOutlier` or a compact :class:`PackedOutlierNB`;
packed ones run through the CUDA kernels (``use_kernels=True``, the
counterpart of ``use_pallas``) or their plain twin.
A cache with an ``observe`` method (the H2O caches of ``kv/h2o.py``) is
handed the float32 attention mass of each key slot after the softmax.
A decode step over a quantized cache goes through the fused flash-decode
kernel (``ops/cuda/quant_attention.py``) where the cache's layout allows and
the kernel takes the geometry (``decode_route``: head_dim, query heads per
KV head, gap, bits, V group, rank), else through ``cache.update``; the
choice is the same on every device.

Weights are a flax-named nested dict (``model/layers_{i}/self_attn/
qkv_proj/kernel``, ``model/layers_{i}/block_sparse_moe/experts_{e}/...``,
``model/norm/scale``, ``lm_head/kernel`` unless the embeddings are tied,
...), made by :func:`build_params`, :func:`microscopiq_tpu_torch.convert.
params_from_jax` or ``models/loading.py`` and installed with
:meth:`LlamaForCausalLM.load_params`.

With ``tp_group`` (a ``torch.distributed`` process group of the mesh's
``model`` axis) the model is this rank's part of a tensor-parallel model
whose weights ``parallel.mesh.shard_params`` split: q/k/v (fused or not),
gate/up and the lm_head are column-parallel, attention runs on the local
query and KV heads (both must divide by the group's size), ``o_proj`` and
``down_proj`` are row-parallel with their partial products summed in
float32 across the group and rounded once, the lm_head's logits are
gathered, and embeddings and norms are replicated. A layer whose split the
rules refused (a replicated weight) multiplies the whole weight: a
column-parallel one keeps this rank's columns, a row-parallel one gathers
its input and sums nothing. Without a group the model is the single-card
one.

With ``mx_specs`` (the fake-quant training path) every linear with a dense
kernel, the lm_head apart, is ``nn.linear``'s MX linear (its bias through
it too), and the norms quantize every intermediate; packed kernels still
take their kernels. For training, install leaves that require gradients
(:func:`trainable_leaves`); the serving paths are unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..kv.cache import QuantizedDecodeCache, SlotQuantizedDecodeCache
from ..nn.linear import linear as mx_linear
from ..nn.linear import packed_matmul
from ..nn.norms import LayerNorm, RMSNorm
from ..ops.cuda.quant_attention import decode_route, quant_attention_decode
from ..ops.packing import (PackedMX, PackedMXOutlier, PackedOutlierNB,
                           pack_mx, to_serving_layout)
from ..parallel.distributed import all_gather, all_reduce
from ..parallel.mesh import packed_kn

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

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=11008, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=32,
                    max_position_embeddings=4096)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def mistral_7b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=4096, sliding_window=4096)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def mixtral_8x7b(**kw) -> "LlamaConfig":
        """Mixtral-8x7B geometry (HF MixtralConfig defaults: Mistral-7B's
        attention, 8 experts of intermediate 14336, top 2, rope theta 1e6,
        32768 positions)."""
        base = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=14336, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=32768, rope_theta=1e6,
                    num_local_experts=8, num_experts_per_tok=2)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def mpt_7b(**kw) -> "LlamaConfig":
        """MPT-7B geometry (HF MptConfig defaults: d_model=4096, n_heads=32,
        n_layers=32, ffn = 4*d, ALiBi, biasless LayerNorm, exact GELU,
        tied embeddings)."""
        base = dict(vocab_size=50432, hidden_size=4096,
                    intermediate_size=16384, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=32,
                    max_position_embeddings=2048, rms_norm_eps=1e-5,
                    pos_emb="alibi", norm_type="ln", mlp_type="gelu",
                    tie_word_embeddings=True)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def tiny_mpt(**kw) -> "LlamaConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=4, max_position_embeddings=128,
                    rms_norm_eps=1e-5, pos_emb="alibi", norm_type="ln",
                    mlp_type="gelu", tie_word_embeddings=True)
        base.update(kw)
        return LlamaConfig(**base)


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


def alibi_slopes(num_heads: int, bias_max: float = 8.0,
                 device=None) -> torch.Tensor:
    """Per-head ALiBi slopes, as HF ``build_mpt_alibi_tensor``: geometric
    over the next power of two, interleave-selected when num_heads is not a
    power of two."""
    npow = 2 ** math.ceil(math.log2(num_heads))
    base = torch.arange(1, npow + 1, dtype=torch.float32,
                        device=device) * (bias_max / npow)
    slopes = 1.0 / torch.exp2(base)
    if npow != num_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:num_heads]
    return slopes


class TensorParallel:
    """The ``model`` axis's process group as a model sees it: its size and
    this rank's index in it."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def split(self, n: int, what: str) -> int:
        if n % self.size:
            raise ValueError(f"{what} ({n}) does not split over "
                             f"{self.size} ranks")
        return n // self.size


def kernel_kn(w):
    """The logical (K, N) of a dense or packed kernel."""
    return tuple(w.shape) if isinstance(w, torch.Tensor) else packed_kn(w)


class QLinear(nn.Module):
    """Linear whose kernel is a dense (K, N) tensor or a packed weight.

    A packed weight goes through ``nn.linear.packed_matmul``: with
    ``use_kernels`` to its kernel wrapper, which picks the GEMV or the GEMM
    by token count (the outlier formats' GEMMs take the 256 tokens and
    more that the JAX ``QLinear`` leaves to XLA); without, the plain
    twins. A
    ``bias`` (OPT's linears) is added to the product. With ``mx_specs`` a
    dense kernel goes through the MX linear, the bias with it.

    Under tensor parallelism (``tp``) ``parallel`` is ``"column"`` (the
    output's local columns; a fused kernel's ``sections`` in the rank's
    order), ``"vocab"`` (column-parallel, the outputs gathered) or
    ``"row"`` (the local input features; the float32 partial products
    summed over the group, rounded once to the output dtype, the bias added
    once). ``full_kn`` is the unsplit (K, N): a kernel of that size is a
    replicated one.
    """

    def __init__(self, dtype, use_kernels: bool = True, mx_specs=None,
                 tp: Optional[TensorParallel] = None, parallel=None,
                 full_kn=None, sections=None):
        super().__init__()
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.mx_specs = mx_specs
        self.kernel = None          # set by load_params
        self.bias = None            # (N,), added after the product (OPT)
        self.tp = tp if parallel is not None else None
        self.parallel = parallel if tp is not None else None
        self.full_kn = full_kn
        self.sections = sections

    def _product(self, x, out_dtype=None):
        w = self.kernel
        if isinstance(w, _PACKED):
            return packed_matmul(x, w, out_dtype or self.dtype,
                                 self.use_kernels)
        if isinstance(w, torch.Tensor):
            dt = torch.promote_types(x.dtype, w.dtype)
            if out_dtype is None or out_dtype == dt:
                return torch.matmul(x.to(dt), w.to(dt))
            if (x.is_cuda and dt in (torch.bfloat16, torch.float16)
                    and out_dtype == torch.float32):
                # the half-precision product on the tensor cores, its f32
                # accumulator returned unrounded (CUDA only in PyTorch)
                y = torch.mm(x.reshape(-1, x.shape[-1]).to(dt), w.to(dt),
                             out_dtype=out_dtype)
                return y.reshape(*x.shape[:-1], w.shape[-1])
            return torch.matmul(x.to(out_dtype), w.to(out_dtype))
        raise TypeError(f"kernel of type {type(w).__name__} is neither a "
                        "dense tensor nor a packed weight")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel
        if self.parallel is not None:
            y = self._tp_forward(x)
        elif isinstance(w, torch.Tensor) and self.mx_specs is not None:
            return mx_linear(x, w.T, self.bias, self.mx_specs)
        else:
            y = self._product(x)
        return y if self.bias is None else y + self.bias

    def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        tp, (K, N) = self.tp, kernel_kn(self.kernel)
        if self.parallel == "row":
            if K == self.full_kn[0]:       # replicated: the whole input
                return self._product(all_gather(x, tp.group, dim=-1))
            w = self.kernel
            out = (self.dtype if isinstance(w, _PACKED)
                   else torch.promote_types(x.dtype, w.dtype))
            y = all_reduce(self._product(x, torch.float32), tp.group)
            return y.to(out)
        y = self._product(x)
        if N != self.full_kn[1]:
            return (all_gather(y, tp.group, dim=-1)
                    if self.parallel == "vocab" else y)
        if self.parallel == "vocab":       # replicated: every logit here
            return y
        # replicated column-parallel kernel: this rank's columns
        secs = self.sections or [N]
        parts, s0 = [], 0
        for n in secs:
            w = tp.split(n, "a section of columns")
            parts.append(y[..., s0 + tp.rank * w:s0 + (tp.rank + 1) * w])
            s0 += n
        return torch.cat(parts, dim=-1)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True,
                 mx_specs=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.tp = tp
        H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        D = cfg.hidden_size
        # the heads this rank attends over (all without a group)
        self.heads = H if tp is None else tp.split(H, "query heads")
        self.kv_heads = KVH if tp is None else tp.split(KVH, "KV heads")
        mk = lambda kind=None, kn=None, secs=None: QLinear(
            cfg.dtype, use_kernels, mx_specs, tp, kind, kn, secs)
        if cfg.fused_projections:
            self.qkv_proj = mk("column", (D, (H + 2 * KVH) * hd),
                               [H * hd, KVH * hd, KVH * hd])
        else:
            self.q_proj = mk("column", (D, H * hd))
            self.k_proj = mk("column", (D, KVH * hd))
            self.v_proj = mk("column", (D, KVH * hd))
        self.o_proj = mk("row", (H * hd, D))

    def decode_route(self, cache) -> str:
        """The route of a decode step over ``cache``: ``"fused"``, the
        flash-decode kernel, where the model runs its kernels, the cache
        is quantized with one K group a chunk, no residual window and no
        GEAR-S outliers, and ``decode_route`` takes the geometry; else
        ``"update"`` (``cache.update`` and the einsum attention)."""
        cfg, c = self.cfg, getattr(cache, "cfg", None)
        if (self.use_kernels and cfg.pos_emb == "rope"
                and isinstance(cache, (QuantizedDecodeCache,
                                       SlotQuantizedDecodeCache))
                and c.n_k_groups == 1 and c.residual_len == 0
                and c.out_k == 0
                and decode_route(cfg.head_dim, self.heads // self.kv_heads,
                                 c.gap, c.bits, c.v_group,
                                 c.rank) == "fused"):
            return "fused"
        return "update"

    def forward(self, x, positions, mask, cache=None, layer_idx: int = 0):
        cfg = self.cfg
        H, KVH, hd = self.heads, self.kv_heads, cfg.head_dim
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
        if cfg.pos_emb == "rope":
            q, k = rope(q, k, positions, hd, cfg.rope_theta)

        scale = hd ** -0.5
        if cache is not None:
            if self.tp is not None and hasattr(cache, "observe"):
                raise ValueError("an H2O cache scores every head: it does "
                                 "not run tensor-parallel")
            if S == 1 and self.decode_route(cache) == "fused":
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
        L = k.shape[1]
        alibi = None
        if cfg.pos_emb == "alibi":
            # a key-slot-only bias, slope_h * (j - (L-1)): linear in the
            # key slot, so softmax's shift invariance makes it the
            # -slope * distance bias for every query row under any
            # left-padding or append-order cache; float32, as in JAX
            slopes = alibi_slopes(cfg.num_attention_heads, cfg.alibi_bias_max,
                                  q.device)
            if self.tp is not None:
                slopes = slopes[self.tp.rank * H:(self.tp.rank + 1) * H]
            alibi = slopes[:, None] * (
                torch.arange(L, dtype=torch.float32, device=q.device)
                - (L - 1))[None, :]                              # (H, L)
        if rep > 1:
            # GQA by grouped einsum: repeated K/V are never materialized
            qg = q.reshape(B, S, G, rep, hd)
            logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k
                                  ).to(torch.float32) * scale
            if alibi is not None:
                logits = logits + alibi.reshape(G, rep, 1, L)[None]
            logits = torch.where(mask[:, :, None], logits, neg)
            probs = torch.softmax(logits, dim=-1)
            if hasattr(cache, "observe"):
                # H2O score feedback (kv/h2o.py): the float32 attention
                # mass of each key slot, summed over heads and query rows
                cache.observe(layer_idx, probs.sum(dim=(1, 2, 3)))
            out = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype), v)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k
                                  ).to(torch.float32) * scale
            if alibi is not None:
                logits = logits + alibi[None, :, None, :]
            logits = torch.where(mask, logits, neg)
            probs = torch.softmax(logits, dim=-1)
            if hasattr(cache, "observe"):
                cache.observe(layer_idx, probs.sum(dim=(1, 2)))
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        return self.o_proj(out.reshape(B, S, H * hd))


class MLP(nn.Module):
    """SwiGLU, down(silu(gate(x)) * up(x)), or MPT's down(gelu(up(x)))
    with the exact-erf GELU and no gate."""

    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True,
                 mx_specs=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.inter = I if tp is None else tp.split(I, "intermediate size")
        mk = lambda kind, kn, secs=None: QLinear(
            cfg.dtype, use_kernels, mx_specs, tp, kind, kn, secs)
        if cfg.mlp_type == "gelu":
            self.up_proj = mk("column", (D, I))
        elif cfg.fused_projections:
            self.gate_up_proj = mk("column", (D, 2 * I), [I, I])
        else:
            self.gate_proj = mk("column", (D, I))
            self.up_proj = mk("column", (D, I))
        self.down_proj = mk("row", (I, D))

    def forward(self, x):
        I = self.inter
        if self.cfg.mlp_type == "gelu":
            return self.down_proj(F.gelu(self.up_proj(x), approximate="none"))
        if self.cfg.fused_projections:
            gu = self.gate_up_proj(x)
            gate, up = gu[..., :I], gu[..., I:]
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class MoEBlock(nn.Module):
    """Mixtral's sparse MoE MLP: a router ``gate`` (a :class:`QLinear`,
    packed like every linear), the top ``num_experts_per_tok`` router
    logits through a float32 softmax cast to x's dtype, and every expert
    computed on every token, combined by one-hot einsums (the JAX module's
    formulation)."""

    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True,
                 mx_specs=None):
        super().__init__()
        self.cfg = cfg
        self.gate = QLinear(cfg.dtype, use_kernels, mx_specs)
        for i in range(cfg.num_local_experts):
            setattr(self, f"experts_{i}", MLP(cfg, use_kernels, mx_specs))

    def route(self, x):
        """(weights (B, S, K) in x's dtype, chosen experts (B, S, K))."""
        router = self.gate(x)
        weights, sel = torch.topk(router, self.cfg.num_experts_per_tok,
                                  dim=-1)
        return torch.softmax(weights.to(torch.float32), dim=-1
                             ).to(x.dtype), sel

    def forward(self, x):
        E = self.cfg.num_local_experts
        weights, sel = self.route(x)
        outs = torch.stack([getattr(self, f"experts_{i}")(x)
                            for i in range(E)], dim=2)           # (B,S,E,D)
        # one-hot by comparison: F.one_hot checks its input on the host,
        # which a CUDA graph's capture forbids
        onehot = (sel[..., None] == torch.arange(E, device=sel.device)
                  ).to(x.dtype)                                  # (B,S,K,E)
        combine = torch.einsum("bske,bsk->bse", onehot, weights)
        dt = torch.promote_types(outs.dtype, combine.dtype)
        return torch.einsum("bsed,bse->bsd", outs.to(dt), combine.to(dt))


def _make_norm(cfg: LlamaConfig, mx_specs=None):
    """RMSNorm (Llama) or biasless LayerNorm (MPT)."""
    if cfg.norm_type == "ln":
        return LayerNorm(cfg.hidden_size, cfg.rms_norm_eps, use_bias=False,
                         mx_specs=mx_specs)
    return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, mx_specs=mx_specs)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True,
                 mx_specs=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.input_layernorm = _make_norm(cfg, mx_specs)
        self.self_attn = Attention(cfg, use_kernels, mx_specs, tp)
        self.post_attention_layernorm = _make_norm(cfg, mx_specs)
        if cfg.num_local_experts > 0:
            self.block_sparse_moe = MoEBlock(cfg, use_kernels, mx_specs)
        else:
            self.mlp = MLP(cfg, use_kernels, mx_specs, tp)

    def forward(self, x, positions, mask, cache=None, layer_idx: int = 0):
        x = x + self.self_attn(self.input_layernorm(x), positions, mask,
                               cache, layer_idx)
        h = self.post_attention_layernorm(x)
        if hasattr(self, "block_sparse_moe"):
            return x + self.block_sparse_moe(h)
        return x + self.mlp(h)


def causal_mask(S: int, positions,
                sliding_window: Optional[int] = None) -> torch.Tensor:
    """(B, 1, S, S) boolean mask: key position <= query position, and with
    Mistral's ``sliding_window`` within that many positions of it."""
    qp = positions[:, :, None]
    kp = positions[:, None, :]
    m = kp <= qp
    if sliding_window is not None:
        m = m & (kp > qp - sliding_window)
    return m[:, None, :, :]


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True,
                 mx_specs=None, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = None        # (vocab, D), set by load_params
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, use_kernels, mx_specs, tp)
             for _ in range(cfg.num_hidden_layers)])
        self.norm = _make_norm(cfg, mx_specs)

    def forward(self, input_ids, positions=None, mask=None, cache=None,
                inputs_embeds=None, image_feats=None, image_token_mask=None):
        """Hidden states after the final norm. ``inputs_embeds`` (B, S, D)
        replaces the embedding of ``input_ids``; with ``image_token_mask``
        (B, S) the ids under the mask are embedded as id 0, and with
        ``image_feats`` (B, T, D) the masked slots then take the image
        features in order (``vlm.llava.splice_image_features``), before
        layer 0, as the JAX module does."""
        ref = input_ids if inputs_embeds is None else inputs_embeds
        B, S = ref.shape[:2]
        if positions is None:
            positions = torch.arange(S, device=ref.device
                                     )[None, :].expand(B, S)
        if mask is None and cache is None:
            # the sliding window applies only here, as in JAX: no cached
            # path applies it
            mask = causal_mask(S, positions, self.cfg.sliding_window)
        if inputs_embeds is None:
            safe_ids = (input_ids if image_token_mask is None else
                        torch.where(image_token_mask, 0, input_ids))
            x = self.embed_tokens[safe_ids]
        else:
            x = inputs_embeds
        if image_feats is not None:
            from ..vlm.llava import splice_image_features
            x = splice_image_features(x, image_feats, image_token_mask)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, mask, cache, i)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama-family decoder with its lm_head, or with tied embeddings
    logits = x @ embed.T (no ``lm_head`` in the tree; a plain matmul, as
    JAX computes it outside any kernel); weights go in with
    :meth:`load_params`.

    ``device`` defaults to "cuda" and must exist; pass ``device="cpu"`` to
    run the plain versions on the CPU. Mixtral with ``fused_projections``
    raises ValueError: ``nn.fuse_projections`` fuses no expert, so its
    experts would have no ``gate_up_proj`` (the JAX module fails there at
    ``apply``). ``mx_specs`` (a finalized ``MxSpecs``) turns on the
    fake-quant linears and norms; the lm_head stays plain, as in JAX.
    ``tp_group`` makes this rank's part of a tensor-parallel model (module
    docstring); ``kv_heads`` is then the local KV heads a cache holds.
    """

    def __init__(self, cfg: LlamaConfig, use_kernels: bool = True,
                 mx_specs=None, device="cuda", tp_group=None):
        super().__init__()
        tp = None
        if tp_group is not None:
            tp = TensorParallel(tp_group)
            if tp.size == 1:
                tp = None
        if tp is not None and (cfg.num_local_experts > 0
                               or mx_specs is not None):
            raise ValueError("tensor parallelism covers the dense and "
                             "packed serving models: no MoE experts, no "
                             "fake-quant training")
        if cfg.num_local_experts > 0 and cfg.fused_projections:
            raise ValueError(
                "fused_projections with MoE experts: fuse_projections fuses "
                "no block_sparse_moe/experts_*, whose MLPs would need "
                "gate_up_proj; serve Mixtral with fused_projections=False")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mx_specs = mx_specs
        self.tp = tp
        self.model = LlamaModel(cfg, use_kernels, mx_specs, tp)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else QLinear(cfg.dtype, use_kernels, None, tp,
                                     "vocab",
                                     (cfg.hidden_size, cfg.vocab_size)))

    @property
    def kv_heads(self) -> int:
        """KV heads of this rank's cache (all of them without a group)."""
        return self.model.layers[0].self_attn.kv_heads

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
        if self.lm_head is None:
            embed = self.model.embed_tokens
            dt = torch.promote_types(x.dtype, embed.dtype)
            return torch.matmul(x.to(dt), embed.to(dt).T)
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


def trainable_leaves(tree) -> list:
    """Every tensor leaf of a weight tree set to require gradients (in
    place), in the tree's order: the leaves to install for training and to
    hand to an optimizer. Packed leaves raise: they are not trainable."""
    out = []

    def visit(node, path):
        for key, val in node.items():
            where = f"{path}/{key}"
            if isinstance(val, dict):
                visit(val, where)
            elif isinstance(val, torch.Tensor):
                out.append(val.requires_grad_(True))
            else:
                raise TypeError(f"{where}: a {type(val).__name__} leaf "
                                "cannot take gradients")

    visit(tree.get("params", tree), "")
    return out


def build_params(cfg: LlamaConfig, seed: int = 0, packed_specs=None,
                 device="cuda"):
    """Random weight tree for :class:`LlamaForCausalLM`, layer by layer.

    Counterpart of ``bench.py::build_params``: N(0, 0.02) bf16 weights made
    on ``device`` from ``seed``; with ``packed_specs`` every linear (the
    lm_head included) is packed by :func:`pack_mx` (axis 0, emi8 for fp4/fp6
    formats) into the pre-blocked serving layout. Projections stay unfused;
    pass the tree through ``nn.fuse_projections`` for a fused model.

    The tree follows the family of ``cfg``: a ``block_sparse_moe`` (router
    ``gate``, ``experts_{e}`` MLPs) in place of ``mlp`` for Mixtral, MPT's
    gate-less MLP, no ``lm_head`` under tied embeddings. The draws go in
    the order embedding, lm_head, then each layer's q, k, v, o and MLP
    kernels (the router first, then each expert's), so a Llama tree is
    the same for a seed whatever the other families add.
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

    def mlp():
        if cfg.mlp_type == "gelu":
            return {"up_proj": {"kernel": kernel((D, I))},
                    "down_proj": {"kernel": kernel((I, D))}}
        return {"gate_proj": {"kernel": kernel((D, I))},
                "up_proj": {"kernel": kernel((D, I))},
                "down_proj": {"kernel": kernel((I, D))}}

    model = {"embed_tokens": dense((cfg.vocab_size, D)).to(cfg.dtype)}
    tree = {"model": model}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = {"kernel": kernel((D, cfg.vocab_size))}
    for i in range(cfg.num_hidden_layers):
        layer = {
            "self_attn": {
                "q_proj": {"kernel": kernel((D, H * hd))},
                "k_proj": {"kernel": kernel((D, KVH * hd))},
                "v_proj": {"kernel": kernel((D, KVH * hd))},
                "o_proj": {"kernel": kernel((H * hd, D))},
            }}
        if cfg.num_local_experts > 0:
            moe = {"gate": {"kernel": kernel((D, cfg.num_local_experts))}}
            for e in range(cfg.num_local_experts):
                moe[f"experts_{e}"] = mlp()
            layer["block_sparse_moe"] = moe
        else:
            layer["mlp"] = mlp()
        layer["input_layernorm"] = {"scale": ones()}
        layer["post_attention_layernorm"] = {"scale": ones()}
        model[f"layers_{i}"] = layer
    model["norm"] = {"scale": ones()}
    return {"params": tree}
