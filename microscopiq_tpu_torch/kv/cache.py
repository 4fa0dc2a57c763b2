"""KV caches for prefill and decode: dense bf16, and the quantized chunked
cache (KIVI 2/4/8-bit groups with optional GEAR side-bands).

Counterpart of ``microscopiq_tpu/kv/cache.py``: ``DenseKVState``,
``init_dense_cache``, ``DenseDecodeCache``, ``QuantKVState``,
``QuantKVConfig``, ``init_quant_cache``, the chunk codecs, the GEAR
side-band, ``QuantizedDecodeCache`` and the slot caches of the serving
engine (``init_slot_quant_cache``, ``SlotQuantizedDecodeCache``,
``SlotQuantPrefillCache``).

Unlike the JAX caches, whose update is functional, these write in place into
the preallocated buffers: PyTorch runs eagerly and a copy of the whole cache
per token would double its traffic. ``finalize`` still returns the state to
carry to the next step. Where JAX quantizes every decode step and predicates
the write (``lax.cond``, ``jnp.where``), the port quantizes only on the steps
where a chunk folds; the stored values are the same. The dense and the
shared quantized cache keep their ``length`` on the device (a CUDA graph of
a decode step replays with it), with a host mirror advanced by the same
counts: the overflow check, and the quantized cache's choice of a fold
step (all rows share one length), read the mirror, never the device; the
slot cache reads once per step, on the host, whether any slot folds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import resolve_device
from .gear import _top_k

_OVERFLOW_MSG = "cache holds {cap} chunks; a write at chunk {at} overflows it"


# ---------------------------------------------------------------------------
# Dense cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DenseKVState:
    k: torch.Tensor                 # (L, B, S_max, KVH, hd)
    v: torch.Tensor
    # tokens written so far (all rows): a 0-d int32 tensor on the cache's
    # device, as JAX's traced length, so that a step captured in a CUDA
    # graph writes at the slot its replay finds; it advances in place
    length: torch.Tensor
    # per-row left-pad count (B,): slot s of row b holds the token at real
    # position s - offset[b]; slots < offset[b] are pads and never attended
    offset: Optional[torch.Tensor] = None
    # the host's mirror of ``length``, advanced by the same counts: the
    # overflow check reads it, never the device tensor
    host_length: int = 0


def init_dense_cache(n_layers, batch, max_len, kv_heads, head_dim,
                     dtype=torch.bfloat16, offset=None,
                     device="cuda") -> DenseKVState:
    dev = resolve_device(device)
    shape = (n_layers, batch, max_len, kv_heads, head_dim)
    if offset is None:
        offset = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return DenseKVState(torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros(shape, dtype=dtype, device=dev),
                        torch.zeros((), dtype=torch.int32, device=dev),
                        offset.to(dev), 0)


def _offset_of(st, batch: int, device) -> torch.Tensor:
    off = getattr(st, "offset", None)
    if off is None:
        return torch.zeros((batch,), dtype=torch.int32, device=device)
    return off


def check_dense_room(state: DenseKVState, S: int) -> None:
    """Raise ValueError when S more tokens would overflow the dense store,
    from the host mirror of the length."""
    S_max = state.k.shape[2]
    if state.host_length + S > S_max:
        raise ValueError(f"cache holds {S_max} slots; {state.host_length} "
                         f"used, {S} more requested")


class DenseDecodeCache:
    """Full-precision cache; every row appends at the same slot.

    ``update`` writes at the device length and reads nothing on the host
    but the length's mirror, so a step through it can be captured in a
    CUDA graph; ``finalize`` advances the length (device and mirror) once
    per step, in place, by the tokens the step wrote.
    """

    def __init__(self, state: DenseKVState):
        self.state = state
        self._written = 0

    def update(self, layer_idx: int, k, v, positions, mask):
        st = self.state
        B, S, KVH, hd = k.shape
        S_max = st.k.shape[2]
        check_dense_room(st, S)
        idx = st.length.long() + torch.arange(S, device=k.device)
        st.k[layer_idx].index_copy_(1, idx, k.to(st.k.dtype))
        st.v[layer_idx].index_copy_(1, idx, v.to(st.v.dtype))
        self._written = S
        new_len = st.length + S
        slots = torch.arange(S_max, device=k.device)
        # real position of key slot s in row b is s - offset[b]; pads
        # (negative real position) never attend
        key_real = slots[None, :] - _offset_of(st, B, k.device)[:, None]
        mask = ((key_real[:, None, :] <= positions[..., None])
                & (key_real[:, None, :] >= 0)
                & (slots[None, None, :] < new_len))
        return st.k[layer_idx], st.v[layer_idx], mask[:, None, :, :]

    def finalize(self) -> DenseKVState:
        st = self.state
        if self._written:
            st.length.add_(self._written)
            st.host_length += self._written
            self._written = 0
        return st


# ---------------------------------------------------------------------------
# Quantized chunked cache (KIVI / GEAR grouped storage)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class QuantKVState:
    # chunked stores, head-major: (L, B, KVH, C, gap // per, hd) uint8 codes
    # packed along the token axis (see QuantKVConfig.codes_per_byte)
    kq: torch.Tensor
    vq: torch.Tensor
    # K: per-channel scales within each chunk (L, B, KVH, C, hd), or
    # (L, B, KVH, C, Gk, hd) for sub-chunk channel groups
    k_mn: torch.Tensor
    k_sc: torch.Tensor
    # V: per-token feature-group scales (L, B, KVH, C, gap, hd // v_group)
    v_mn: torch.Tensor
    v_sc: torch.Tensor
    # residual recent-token window (L, B, res_slots, KVH, hd)
    res_k: torch.Tensor
    res_v: torch.Tensor
    # tokens written: a 0-d int32 tensor on the cache's device for the
    # shared cache (advanced in place, as DenseKVState.length), a (B,)
    # int32 tensor of per-slot depths for the slot cache
    length: torch.Tensor
    # per-row left-pad count (B,), as DenseKVState.offset
    offset: Optional[torch.Tensor] = None
    # GEAR-L per-chunk rank-r bases of the quantization error:
    # k_p, v_p (L, B, KVH, C, r, hd); k_q, v_q (L, B, C, r, gap)
    k_p: Optional[torch.Tensor] = None
    k_q: Optional[torch.Tensor] = None
    v_p: Optional[torch.Tensor] = None
    v_q: Optional[torch.Tensor] = None
    # GEAR-S exact outlier side-band per (chunk, head): values f32 and flat
    # int32 indices into the chunk's (gap * hd) window, (L, B, KVH, C, 2k)
    k_ov: Optional[torch.Tensor] = None
    k_oi: Optional[torch.Tensor] = None
    v_ov: Optional[torch.Tensor] = None
    v_oi: Optional[torch.Tensor] = None
    # the shared cache's host mirror of ``length``, advanced by the same
    # counts: the overflow check and the fold choice read it
    host_length: int = 0


@dataclasses.dataclass(frozen=True)
class QuantKVConfig:
    bits: int = 4
    gap: int = 64            # streaming gap (chunk quantization cadence)
    # V feature group size; >= head_dim means per-token V scales
    v_group: int = 128
    # K channel-group size in tokens (KIVI group_size); 0 = one group per
    # chunk. Must divide gap.
    k_group: int = 0
    # recent tokens always kept full precision beyond the in-progress chunk
    # (KIVI residual_length): the window holds residual_len + gap slots
    residual_len: int = 0
    residual_dtype: torch.dtype = torch.bfloat16
    # GEAR-L: rank of the per-chunk error bases; loop = power iterations
    rank: int = 0
    loop: int = 2
    # GEAR-S: out_k smallest + out_k largest values per (chunk, head) kept
    # exactly
    out_k: int = 0
    lr_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.k_group and self.gap % self.k_group:
            raise ValueError("k_group must divide gap")
        if self.residual_len < 0:
            raise ValueError("residual_len must be >= 0")
        if self.rank < 0 or self.out_k < 0 or self.loop < 1:
            raise ValueError("rank and out_k must be >= 0, loop >= 1")

    @property
    def kg(self) -> int:
        """Effective K channel-group size (tokens)."""
        return self.k_group or self.gap

    @property
    def n_k_groups(self) -> int:
        return self.gap // self.kg

    @property
    def res_slots(self) -> int:
        """Residual window size: gap in-progress slots + residual_len
        protected recent tokens."""
        return self.gap + self.residual_len

    def n_full(self, length):
        """Chunks quantized after ``length`` tokens (int or tensor)."""
        if isinstance(length, torch.Tensor):
            return torch.clamp(length - self.residual_len, min=0) // self.gap
        return max(length - self.residual_len, 0) // self.gap

    @property
    def codes_per_byte(self) -> int:
        """Chunk codes are packed along the token axis: byte row r of a
        chunk holds the codes of tokens r, r + gap/per, r + 2*gap/per, ..."""
        return _per(self.bits)


def _per(bits: int) -> int:
    return {2: 4, 4: 2, 8: 1}[bits]


def _pack_codes(codes: torch.Tensor, per: int, bits: int) -> torch.Tensor:
    """(..., gap, hd) uint8 values < 2^bits -> (..., gap // per, hd)."""
    if per == 1:
        return codes
    *lead, gap, hd = codes.shape
    c = codes.reshape(*lead, per, gap // per, hd).to(torch.uint8)
    out = c[..., 0, :, :].clone()
    for i in range(1, per):
        out |= c[..., i, :, :] << (bits * i)
    return out


def _unpack_codes(packed: torch.Tensor, per: int, bits: int) -> torch.Tensor:
    """Inverse of :func:`_pack_codes` -> uint8 code values."""
    if per == 1:
        return packed
    mask = (1 << bits) - 1
    fields = [(packed >> (bits * i)) & mask for i in range(per)]
    return torch.cat(fields, dim=-2)


def init_quant_cache(n_layers, batch, max_len, kv_heads, head_dim,
                     cfg: QuantKVConfig = QuantKVConfig(), offset=None,
                     device="cuda") -> QuantKVState:
    dev = resolve_device(device)
    if max_len % cfg.gap:
        raise ValueError(f"max_len {max_len} is not a multiple of gap "
                         f"{cfg.gap}")
    C = max_len // cfg.gap
    vg = min(cfg.v_group, head_dim)
    if head_dim % vg:
        raise ValueError("v_group must divide head_dim")
    G = head_dim // vg
    Gk = cfg.n_k_groups
    # Gk == 1 keeps the (C, hd) scale layout the fused kernel consumes;
    # Gk > 1 adds a per-chunk group axis (C, Gk, hd)
    kss = ((n_layers, batch, kv_heads, C, head_dim) if Gk == 1
           else (n_layers, batch, kv_heads, C, Gk, head_dim))

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    shp = (n_layers, batch, kv_heads, C, cfg.gap // cfg.codes_per_byte,
           head_dim)
    if offset is None:
        offset = torch.zeros((batch,), dtype=torch.int32)
    gear = {}
    if cfg.rank > 0:
        pshape = (n_layers, batch, kv_heads, C, cfg.rank, head_dim)
        qshape = (n_layers, batch, C, cfg.rank, cfg.gap)
        gear.update(k_p=z(pshape, cfg.lr_dtype), k_q=z(qshape, cfg.lr_dtype),
                    v_p=z(pshape, cfg.lr_dtype), v_q=z(qshape, cfg.lr_dtype))
    if cfg.out_k > 0:
        oshape = (n_layers, batch, kv_heads, C, 2 * cfg.out_k)
        gear.update(k_ov=z(oshape, torch.float32),
                    k_oi=z(oshape, torch.int32),
                    v_ov=z(oshape, torch.float32),
                    v_oi=z(oshape, torch.int32))
    res = (n_layers, batch, cfg.res_slots, kv_heads, head_dim)
    return QuantKVState(
        kq=z(shp, torch.uint8), vq=z(shp, torch.uint8),
        k_mn=z(kss, torch.float32), k_sc=z(kss, torch.float32),
        v_mn=z((n_layers, batch, kv_heads, C, cfg.gap, G), torch.float32),
        v_sc=z((n_layers, batch, kv_heads, C, cfg.gap, G), torch.float32),
        res_k=z(res, cfg.residual_dtype), res_v=z(res, cfg.residual_dtype),
        length=z((), torch.int32), offset=offset.to(dev), host_length=0,
        **gear)


def _inv_levels(bits: int) -> float:
    """1 / (2^bits - 1), applied as a product: XLA compiles the JAX codecs'
    division by this constant into a product with its f32 reciprocal, and
    the caches always run compiled, so the product keeps the scales
    bit-exact with theirs."""
    return 1.0 / (2 ** bits - 1)


def _quant_chunk_k(chunk: torch.Tensor, bits: int, group: int = 0):
    """K chunk (B, KVH, nch, gap, hd): per-channel min/max over token
    sub-groups of ``group`` tokens (group == gap: one group per chunk).
    Codes come back packed along the token axis; scales are (..., nch, hd)
    for one group, else (..., nch, Gk, hd)."""
    x = chunk.to(torch.float32)
    B, KVH, nch, gap, hd = x.shape
    g = group or gap
    Gk = gap // g
    xg = x.reshape(B, KVH, nch, Gk, g, hd)
    mn = xg.amin(dim=4)
    mx = xg.amax(dim=4)
    sc = (mx - mn) * _inv_levels(bits)
    sc = torch.where(sc == 0, 1.0, sc)
    codes = torch.clamp(torch.round((xg - mn[..., None, :])
                                    / sc[..., None, :]),
                        0, 2 ** bits - 1).to(torch.uint8).reshape(x.shape)
    if Gk == 1:
        mn, sc = mn[..., 0, :], sc[..., 0, :]
    return _pack_codes(codes, _per(bits), bits), mn, sc


def _quant_chunk_v(chunk: torch.Tensor, bits: int, v_group: int):
    """V chunk (B, KVH, nch, gap, hd): per-token feature groups (groups never
    straddle heads; v_group clamped to hd). Packed like K."""
    B, KVH, nch, gap, hd = chunk.shape
    vg = min(v_group, hd)
    G = hd // vg
    x = chunk.to(torch.float32).reshape(B, KVH, nch, gap, G, vg)
    mn = x.amin(-1, keepdim=True)
    mx = x.amax(-1, keepdim=True)
    sc = (mx - mn) * _inv_levels(bits)
    sc = torch.where(sc == 0, 1.0, sc)
    codes = torch.clamp(torch.round((x - mn) / sc), 0, 2 ** bits - 1
                        ).to(torch.uint8).reshape(chunk.shape)
    return _pack_codes(codes, _per(bits), bits), mn[..., 0], sc[..., 0]


def _dequant_k(codes, mn, sc, dtype, bits: int = 4):
    """(B, KVH, C, gap // per, hd) packed codes; scales (B, KVH, C, hd) or
    (B, KVH, C, Gk, hd) for sub-chunk K groups."""
    codes = _unpack_codes(codes, _per(bits), bits)
    if mn.dim() == codes.dim():                # grouped: (..., C, Gk, hd)
        B, KVH, C, gap, hd = codes.shape
        Gk = mn.shape[-2]
        x = codes.to(torch.float32).reshape(B, KVH, C, Gk, gap // Gk, hd)
        x = x * sc[..., None, :] + mn[..., None, :]
        return x.reshape(codes.shape).to(dtype)
    return (codes.to(torch.float32) * sc[..., None, :]
            + mn[..., None, :]).to(dtype)


def _dequant_v(codes, mn, sc, v_group, dtype, bits: int = 4):
    codes = _unpack_codes(codes, _per(bits), bits)
    B, KVH, C, gap, hd = codes.shape
    vg = min(v_group, hd)
    G = hd // vg
    x = codes.to(torch.float32).reshape(B, KVH, C, gap, G, vg)
    x = x * sc[..., None] + mn[..., None]
    return x.reshape(codes.shape).to(dtype)


# ---------------------------------------------------------------------------
# GEAR chunk codecs: exact outlier side-band + low-rank error bases
# ---------------------------------------------------------------------------
def _extract_outliers(chunk: torch.Tensor, k_out: int):
    """Zero the k_out smallest + k_out largest values of each (batch, head,
    chunk) window (GEAR-S). chunk: (B, KVH, nch, gap, hd) f32. Returns
    (cleaned, vals (B, KVH, nch, 2k), idx int32 of the same shape); idx is
    flat into the chunk's row-major (gap * hd) window. Ties go to the lower
    index, as in ``lax.top_k``: a chunk folded from the bf16 residual window
    holds ties, and the value zeroed decides what the codes hold."""
    B, KVH, nch, gap, hd = chunk.shape
    flat = chunk.reshape(B, KVH, nch, gap * hd)
    sval, sidx = _top_k(-flat, k_out)
    lval, lidx = _top_k(flat, k_out)
    vals = torch.cat([-sval, lval], dim=-1)
    idx = torch.cat([sidx, lidx], dim=-1).to(torch.int32)
    cleaned = _scatter_chunk_flat(flat, idx, torch.zeros_like(vals))
    return cleaned.reshape(chunk.shape), vals, idx


def _scatter_chunk_flat(flat: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """flat (..., N) with flat[..., idx] = vals for batched (..., 2k)
    indices; out of place."""
    return flat.scatter(-1, idx.long(), vals.to(flat.dtype))


def _orthonormalize(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of x (..., n, r): thin QR."""
    return torch.linalg.qr(x, mode="reduced").Q


def _lowrank_chunk(err: torch.Tensor, rank: int, loop: int):
    """Rank-r bases of per-chunk error (B, nch, gap, F) -> (p, q) with
    err ~= q @ p^T; power iteration from a fixed quasi-random start."""
    B, nch, gap, F = err.shape
    e = err.to(torch.float32)
    i = torch.arange(F, dtype=torch.float32, device=e.device)[:, None]
    j = torch.arange(rank, dtype=torch.float32, device=e.device)[None, :]
    p = torch.cos(i * (j + 1.0) * 0.61803398875) + 1.1
    p = p.expand(B, nch, F, rank)
    q = torch.zeros((B, nch, gap, rank), dtype=torch.float32,
                    device=e.device)
    for it in range(loop):
        if it == loop - 1:
            p = _orthonormalize(p)
        q = torch.einsum("bcgf,bcfr->bcgr", e, p)
        if it == loop - 1:
            q = _orthonormalize(q)
        p = torch.einsum("bcgf,bcgr->bcfr", e, q)
    return p, q


def _gear_compress_chunk(chunk: torch.Tensor, codes, mn, sc, dequant_fn,
                         cfg: QuantKVConfig):
    """Low-rank bases of a just-quantized chunk's error, in the storage
    layouts p (B, KVH, nch, r, hd), q (B, nch, r, gap). ``chunk`` is the
    cleaned chunk (outliers zeroed)."""
    B, KVH, nch, gap, hd = chunk.shape
    deq = dequant_fn(codes, mn, sc)
    err = chunk.to(torch.float32) - deq.to(torch.float32)
    # feature index kvh * hd + d, the reference's (H, D) flatten order
    ef = err.permute(0, 2, 3, 1, 4).reshape(B, nch, gap, KVH * hd)
    p, q = _lowrank_chunk(ef, cfg.rank, cfg.loop)
    ps = p.reshape(B, nch, KVH, hd, cfg.rank).permute(0, 2, 1, 4, 3)
    qs = q.permute(0, 1, 3, 2)
    return ps.to(cfg.lr_dtype), qs.to(cfg.lr_dtype)


def _apply_gear(deq: torch.Tensor, p, q, ov, oi, cfg: QuantKVConfig
                ) -> torch.Tensor:
    """Low-rank error first (additive), outliers last (exact overwrite).
    deq (B, KVH, C, gap, hd); p (B, KVH, C, r, hd); q (B, C, r, gap);
    ov/oi (B, KVH, C, 2k)."""
    B, KVH, C, gap, hd = deq.shape
    x = deq.to(torch.float32)
    if cfg.rank > 0 and p is not None:
        x = x + torch.einsum("bcrg,bkcrd->bkcgd", q.to(torch.float32),
                             p.to(torch.float32))
    if cfg.out_k > 0 and ov is not None:
        flat = _scatter_chunk_flat(x.reshape(B, KVH, C, gap * hd), oi, ov)
        x = flat.reshape(deq.shape)
    return x.to(deq.dtype)


def _compress_chunks(kc: torch.Tensor, vc: torch.Tensor, cfg: QuantKVConfig
                     ) -> Dict[str, torch.Tensor]:
    """Quantize head-major chunks (B, KVH, nch, gap, hd) and build every
    store piece (codes, scales and the configured GEAR side-bands), in
    storage layouts without the leading L axis."""
    out = {}
    kc = kc.to(torch.float32)
    vc = vc.to(torch.float32)
    if cfg.out_k > 0:
        kc, out["k_ov"], out["k_oi"] = _extract_outliers(kc, cfg.out_k)
        vc, out["v_ov"], out["v_oi"] = _extract_outliers(vc, cfg.out_k)
    kq, kmn, ksc = _quant_chunk_k(kc, cfg.bits, cfg.kg)
    vq, vmn, vsc = _quant_chunk_v(vc, cfg.bits, cfg.v_group)
    out.update(kq=kq, k_mn=kmn, k_sc=ksc, vq=vq, v_mn=vmn, v_sc=vsc)
    if cfg.rank > 0:
        out["k_p"], out["k_q"] = _gear_compress_chunk(
            kc, kq, kmn, ksc,
            lambda c, m, s: _dequant_k(c, m, s, torch.float32, cfg.bits),
            cfg)
        out["v_p"], out["v_q"] = _gear_compress_chunk(
            vc, vq, vmn, vsc,
            lambda c, m, s: _dequant_v(c, m, s, cfg.v_group, torch.float32,
                                       cfg.bits), cfg)
    return out


# chunk-axis position of each store piece in its full (L-leading) buffer
_CHUNK_AXIS = {"kq": 3, "k_mn": 3, "k_sc": 3, "vq": 3, "v_mn": 3,
               "v_sc": 3, "k_p": 3, "v_p": 3, "k_ov": 3, "k_oi": 3,
               "v_ov": 3, "v_oi": 3, "k_q": 2, "v_q": 2}

# buffers the fused decode attention reads, in its argument order
_FUSED_FIELDS = ("kq", "k_mn", "k_sc", "vq", "v_mn", "v_sc", "res_k",
                 "res_v")
_LOWRANK_FIELDS = ("k_p", "k_q", "v_p", "v_q")


def _store_fields(cfg: QuantKVConfig):
    base = ["kq", "vq", "k_mn", "k_sc", "v_mn", "v_sc", "res_k", "res_v"]
    if cfg.rank > 0:
        base += ["k_p", "k_q", "v_p", "v_q"]
    if cfg.out_k > 0:
        base += ["k_ov", "k_oi", "v_ov", "v_oi"]
    return base


def _check_fusable(cfg: QuantKVConfig) -> None:
    """The fused decode kernel's layout: one K group per chunk, no
    protected residual, no exact outlier side-band."""
    if cfg.n_k_groups != 1 or cfg.residual_len != 0:
        raise ValueError("the fused decode kernel serves the k_group == gap, "
                         "residual_len == 0 layout; use cache.update")
    if cfg.out_k != 0:
        raise ValueError("the fused decode kernel does not scatter the exact "
                         "outlier side-band; use cache.update for GEAR-S")


def _shift_residual(res: torch.Tensor, gap: int, where=None) -> None:
    """On a fold, the protected residual rows shift down by gap, in place
    (res: one layer's (B, R, KVH, hd)); ``where`` (B,) picks the rows."""
    shifted = torch.cat([res[:, gap:], torch.zeros_like(res[:, :gap])], 1)
    if where is not None:
        shifted = torch.where(where.reshape(-1, 1, 1, 1), shifted, res)
    res.copy_(shifted)


def _assemble(st: QuantKVState, cfg: QuantKVConfig, li: int, dtype):
    """Dequantized chunks ++ residual of one layer, as (B, C*gap + R, KVH,
    hd) keys and values in ``dtype``."""
    kq = st.kq[li]
    B, KVH, C = kq.shape[:3]
    hd = kq.shape[-1]
    k_chunks = _dequant_k(kq, st.k_mn[li], st.k_sc[li], dtype, cfg.bits)
    v_chunks = _dequant_v(st.vq[li], st.v_mn[li], st.v_sc[li], cfg.v_group,
                          dtype, cfg.bits)
    if cfg.rank > 0 or cfg.out_k > 0:
        g = lambda n: (getattr(st, n)[li] if getattr(st, n) is not None
                       else None)
        k_chunks = _apply_gear(k_chunks, g("k_p"), g("k_q"), g("k_ov"),
                               g("k_oi"), cfg)
        v_chunks = _apply_gear(v_chunks, g("v_p"), g("v_q"), g("v_ov"),
                               g("v_oi"), cfg)
    # (B, KVH, C, gap, hd) -> (B, C*gap, KVH, hd)
    k_chunks = k_chunks.reshape(B, KVH, C * cfg.gap, hd).transpose(1, 2)
    v_chunks = v_chunks.reshape(B, KVH, C * cfg.gap, hd).transpose(1, 2)
    k_all = torch.cat([k_chunks, st.res_k[li].to(dtype)], 1)
    v_all = torch.cat([v_chunks, st.res_v[li].to(dtype)], 1)
    return k_all, v_all, C


def quant_fold_step(cfg: QuantKVConfig, length: int) -> bool:
    """Whether the decode step at ``length`` tokens folds a chunk (from the
    host mirror: every row shares the length)."""
    return cfg.n_full(length + 1) > cfg.n_full(length)


def next_fold_length(cfg: QuantKVConfig, length: int) -> int:
    """The least length >= ``length`` at which a decode step folds."""
    at = max(length, cfg.residual_len + cfg.gap - 1)
    return at + (-(at - cfg.residual_len + 1)) % cfg.gap


def check_quant_room(state: QuantKVState, cfg: QuantKVConfig,
                     S: int = 1) -> None:
    """Raise ValueError when S more decode tokens would fold a chunk past
    the store, from the host mirror of the length."""
    C = state.kq.shape[3]
    at = cfg.n_full(state.host_length + S) - 1
    if at >= C:
        raise ValueError(_OVERFLOW_MSG.format(cap=C, at=at))


class QuantizedDecodeCache:
    """4/2/8-bit grouped KV cache with a full-precision residual window; all
    rows share one length.

    A decode step writes at the device length and reads nothing on the host
    but the length's mirror (whether the step folds, the overflow check),
    so a step through it can be captured in a CUDA graph: one graph for a
    plain step, one for a fold step. ``finalize`` advances the length
    (device and mirror) once per step, in place.
    """

    def __init__(self, state: QuantKVState, cfg: QuantKVConfig):
        self.state = state
        self.cfg = cfg
        self._written = 0

    # -- internals ---------------------------------------------------------
    def _write(self, li: int, pieces, chunk) -> None:
        """Land compressed chunks at chunk index ``chunk`` onward: a host
        int (the prefill), or a (1,) device index (a decode fold, whose
        room the caller checked from the host mirror)."""
        for name, val in pieces.items():
            lay = getattr(self.state, name)[li]
            ax = _CHUNK_AXIS[name] - 1
            if isinstance(chunk, torch.Tensor):
                lay.index_copy_(ax, chunk, val.to(lay.dtype))
                continue
            n = val.shape[ax]
            if chunk + n > lay.shape[ax]:
                raise ValueError(_OVERFLOW_MSG.format(cap=lay.shape[ax],
                                                       at=chunk + n - 1))
            lay.narrow(ax, chunk, n).copy_(val)

    def _ingest_prefill(self, li: int, k, v) -> None:
        st, cfg = self.state, self.cfg
        B, S, KVH, hd = k.shape
        gap = cfg.gap
        # only tokens at least residual_len old may quantize
        nch = max(S - cfg.residual_len, 0) // gap
        if nch > 0:
            # (B, S', KVH, hd) -> head-major chunks (B, KVH, nch, gap, hd)
            kc = k[:, :nch * gap].reshape(B, nch, gap, KVH, hd
                                          ).permute(0, 3, 1, 2, 4)
            vc = v[:, :nch * gap].reshape(B, nch, gap, KVH, hd
                                          ).permute(0, 3, 1, 2, 4)
            self._write(li, _compress_chunks(kc, vc, cfg), 0)
        tail = S - nch * gap
        st.res_k[li].zero_()
        st.res_v[li].zero_()
        if tail > 0:
            st.res_k[li, :, :tail] = k[:, nch * gap:].to(st.res_k.dtype)
            st.res_v[li, :, :tail] = v[:, nch * gap:].to(st.res_v.dtype)

    def _ingest_decode(self, li: int, k, v) -> None:
        """Write the token into the residual at ``length - n_full * gap``
        (on the device); when the host mirror says that a chunk fills,
        fold the oldest ``gap`` residual rows into chunk ``n_full(length +
        1) - 1`` (a device index). Old residual rows stay, masked by
        res_len."""
        st, cfg = self.state, self.cfg
        gap = cfg.gap
        length = st.length
        fold = quant_fold_step(cfg, st.host_length)
        if fold:
            check_quant_room(st, cfg)       # before anything is written
        slot = (length - cfg.n_full(length) * gap).long().reshape(1)
        st.res_k[li].index_copy_(1, slot, k.to(st.res_k.dtype))
        st.res_v[li].index_copy_(1, slot, v.to(st.res_v.dtype))
        if fold:
            chunk = (cfg.n_full(length + 1) - 1).long().reshape(1)
            rk = st.res_k[li, :, :gap].transpose(1, 2)[:, :, None]
            rv = st.res_v[li, :, :gap].transpose(1, 2)[:, :, None]
            self._write(li, _compress_chunks(rk, rv, cfg), chunk)
            if cfg.residual_len > 0:
                _shift_residual(st.res_k[li], gap)
                _shift_residual(st.res_v[li], gap)

    # -- protocol ----------------------------------------------------------
    def update(self, layer_idx: int, k, v, positions, mask):
        st, cfg = self.state, self.cfg
        B, S = k.shape[:2]
        gap = cfg.gap
        if S > 1:
            self._ingest_prefill(layer_idx, k, v)
        else:
            self._ingest_decode(layer_idx, k, v)
        self._written = S
        new_len = st.length + S
        # assemble keys/values: dequantized chunks ++ residual
        k_all, v_all, C = _assemble(st, cfg, layer_idx, k.dtype)

        dev = k.device
        nfull = cfg.n_full(new_len)
        res_len = new_len - nfull * gap
        # slot s of row b holds the token with real position s - offset[b]
        chunk_pos = torch.arange(C * gap, device=dev)
        res_pos = nfull * gap + torch.arange(cfg.res_slots, device=dev)
        key_slot = torch.cat([chunk_pos, res_pos])
        key_valid = torch.cat([chunk_pos < nfull * gap,
                               torch.arange(cfg.res_slots, device=dev)
                               < res_len])
        key_real = key_slot[None, :] - _offset_of(st, B, dev)[:, None]
        m = ((key_real[:, None, :] <= positions[..., None])
             & (key_real[:, None, :] >= 0) & key_valid[None, None, :])
        return k_all, v_all, m[:, None, :, :]

    def ingest_for_fused(self, layer_idx: int, k, v):
        """Decode-step ingest for the fused attention kernel: returns the
        full (L-leading) buffers it reads and the new length (a 0-d device
        tensor)."""
        _check_fusable(self.cfg)
        self._ingest_decode(layer_idx, k, v)
        self._written = 1
        names = _FUSED_FIELDS
        if self.cfg.rank > 0:
            names += _LOWRANK_FIELDS
        return (tuple(getattr(self.state, n) for n in names),
                self.state.length + 1)

    def finalize(self) -> QuantKVState:
        st = self.state
        if self._written:
            st.length.add_(self._written)
            st.host_length += self._written
            self._written = 0
        return st

    @property
    def compression_ratio(self) -> float:
        cfg = self.cfg
        KVH, hd = self.state.res_k.shape[-2:]
        feat = KVH * hd
        bytes_q = (cfg.bits / 8) * feat + \
            8 * feat * cfg.n_k_groups / cfg.gap + 8 * feat / cfg.v_group
        if cfg.rank > 0:
            # per token, K and V each: p (KVH*hd*r / gap) + q (r) elements
            lr_b = cfg.lr_dtype.itemsize
            bytes_q += 2 * lr_b * (feat * cfg.rank / cfg.gap + cfg.rank)
        if cfg.out_k > 0:
            # 2k (f32 value + i32 index) per chunk per head, K and V
            bytes_q += 2 * KVH * 2 * cfg.out_k * 8 / cfg.gap
        return (2.0 * feat) / bytes_q


# ---------------------------------------------------------------------------
# Slot-pooled quantized cache (continuous batching x KIVI storage)
# ---------------------------------------------------------------------------
def init_slot_quant_cache(n_layers, n_slots, max_len, kv_heads, head_dim,
                          cfg: QuantKVConfig = QuantKVConfig(),
                          device="cuda") -> QuantKVState:
    """QuantKVState with a per-slot (n_slots,) int32 length vector: each
    slot is an independent sequence at its own depth."""
    st = init_quant_cache(n_layers, n_slots, max_len, kv_heads, head_dim,
                          cfg, device=device)
    return dataclasses.replace(st, length=torch.zeros(
        (n_slots,), dtype=torch.int32, device=st.kq.device))


class SlotQuantizedDecodeCache:
    """Per-slot quantized decode cache (single-token steps).

    Every slot writes its residual row, inactive ones too; only active slots
    advance and fold. Whether any slot folds this step is read on the host
    once, when the cache is made, so steps without a fold quantize nothing.
    """

    def __init__(self, state: QuantKVState, cfg: QuantKVConfig,
                 active: torch.Tensor):
        self.state = state
        self.cfg = cfg
        self.active = active                 # (B,) bool
        lengths = state.length
        self._new_len = lengths
        self._ready = active & (cfg.n_full(lengths + 1)
                                > cfg.n_full(lengths))
        self._any_ready = bool(self._ready.any())

    def _ingest(self, li: int, k, v) -> None:
        st, cfg = self.state, self.cfg
        B, S = k.shape[:2]
        if S != 1:
            raise ValueError("slot cache is decode-only; prefill through "
                             "SlotQuantPrefillCache")
        gap = cfg.gap
        lengths = st.length
        b_idx = torch.arange(B, device=k.device)
        nfull_old = cfg.n_full(lengths)
        row = (lengths - nfull_old * gap).long()
        st.res_k[li, b_idx, row] = k[:, 0].to(st.res_k.dtype)
        st.res_v[li, b_idx, row] = v[:, 0].to(st.res_v.dtype)
        self._new_len = torch.where(self.active, lengths + 1, lengths)
        if not self._any_ready:
            return
        ready = self._ready
        C = st.kq.shape[3]
        # an index past the store only occurs on slots that do not fold
        cidx = torch.clamp(cfg.n_full(lengths + 1) - 1, 0, C - 1).long()
        rk = st.res_k[li, :, :gap].transpose(1, 2)[:, :, None]
        rv = st.res_v[li, :, :gap].transpose(1, 2)[:, :, None]
        for name, val in _compress_chunks(rk, rv, cfg).items():
            lay = getattr(st, name)[li]
            if _CHUNK_AXIS[name] == 3:           # (B, KVH, C, ...)
                val = val[:, :, 0]
                cur = lay[b_idx, :, cidx]        # (B, KVH, ...)
            else:                                # (B, C, ...): k_q / v_q
                val = val[:, 0]
                cur = lay[b_idx, cidx]
            sel = torch.where(ready.reshape((B,) + (1,) * (val.dim() - 1)),
                              val.to(lay.dtype), cur)
            if _CHUNK_AXIS[name] == 3:
                lay[b_idx, :, cidx] = sel
            else:
                lay[b_idx, cidx] = sel
        if cfg.residual_len > 0:
            _shift_residual(st.res_k[li], gap, ready)
            _shift_residual(st.res_v[li], gap, ready)

    def ingest_for_fused(self, layer_idx: int, k, v):
        """Decode-step ingest for the fused attention kernel: the full
        buffers and the per-slot new lengths."""
        _check_fusable(self.cfg)
        self._ingest(layer_idx, k, v)
        names = _FUSED_FIELDS
        if self.cfg.rank > 0:
            names += _LOWRANK_FIELDS
        return tuple(getattr(self.state, n) for n in names), self._new_len

    def update(self, layer_idx: int, k, v, positions, mask):
        st, cfg = self.state, self.cfg
        B = k.shape[0]
        gap = cfg.gap
        lengths = st.length
        self._ingest(layer_idx, k, v)
        k_all, v_all, C = _assemble(st, cfg, layer_idx, k.dtype)

        dev = k.device
        R = cfg.res_slots
        nfull = cfg.n_full(lengths)                  # (B,) before this token
        res_len = lengths - nfull * gap + 1          # incl. the one written
        chunk_pos = torch.arange(C * gap, device=dev)[None, :]
        chunk_valid = chunk_pos < (nfull * gap)[:, None]
        res_pos = (nfull * gap)[:, None] + torch.arange(R, device=dev)[None]
        res_valid = torch.arange(R, device=dev)[None, :] < res_len[:, None]
        key_pos = torch.cat([chunk_pos.expand(B, -1), res_pos], 1)
        key_valid = torch.cat([chunk_valid, res_valid], 1)
        m = (key_pos[:, None, :] <= positions[..., None]) & \
            key_valid[:, None, :]
        return k_all, v_all, m[:, None, :, :]

    def finalize(self) -> QuantKVState:
        return dataclasses.replace(self.state, length=self._new_len)


class SlotQuantPrefillCache:
    """Writes one sequence's prompt into slot ``slot``: the chunks that
    ``true_len`` fills are quantized, the tail goes to the residual window.
    The prompt attends over its raw (unquantized) K/V."""

    def __init__(self, state: QuantKVState, cfg: QuantKVConfig, slot: int,
                 true_len: int):
        self.state = state
        self.cfg = cfg
        self.slot = int(slot)
        self.true_len = int(true_len)

    def update(self, layer_idx: int, k, v, positions, mask):
        st, cfg = self.state, self.cfg
        _, S, KVH, hd = k.shape                  # batch of one
        gap = cfg.gap
        li = layer_idx
        nch = max(S - cfg.residual_len, 0) // gap
        nfull = cfg.n_full(self.true_len)        # chunks really full
        n = min(nch, nfull)
        if n > 0:
            # chunks are compressed independently, so quantizing only the
            # n that land gives the values of quantizing all nch
            kc = k[0, :n * gap].reshape(n, gap, KVH, hd
                                        ).permute(2, 0, 1, 3)[None]
            vc = v[0, :n * gap].reshape(n, gap, KVH, hd
                                        ).permute(2, 0, 1, 3)[None]
            for name, val in _compress_chunks(kc, vc, cfg).items():
                lay = getattr(st, name)[li, self.slot]
                ax = _CHUNK_AXIS[name] - 2
                lay.narrow(ax, 0, n).copy_(val[0])
        # tail -> residual rows: an R-row window from nfull * gap, zero past
        # the prompt
        R = cfg.res_slots
        start = nfull * gap
        for buf, x in ((st.res_k, k), (st.res_v, v)):
            tail = x[0, start:start + R]
            dst = buf[li, self.slot]
            dst.zero_()
            dst[:tail.shape[0]] = tail.to(buf.dtype)
        key_pos = torch.arange(S, device=k.device)[None, :]
        m = key_pos[:, None, :] <= positions[..., None]
        return k, v, m[:, None, :, :]

    def finalize(self, true_len: Optional[int] = None) -> QuantKVState:
        tl = self.true_len if true_len is None else int(true_len)
        length = self.state.length.clone()
        length[self.slot] = tl
        return dataclasses.replace(self.state, length=length)
