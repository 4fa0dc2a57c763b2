"""H2O heavy-hitter KV-cache eviction in PyTorch.

Counterpart of ``microscopiq_tpu/kv/h2o.py``: a fixed budget of slots
holds the tokens that received the most attention mass (the "heavy
hitters") plus a protected window of the most recent ones. The attention
feeds the mass back after its softmax (``cache.observe(layer, probs)``,
summed over heads and query rows, float32), and a decode step writes the
incoming token over the lowest-score unprotected slot (the first such
slot where scores tie, as ``jnp.argmin`` and ``torch.argmin`` both
choose). Slot positions ride along, so causal masks and RoPE stay exact
for the kept set. Three families:

* :class:`H2OCache`, one batch at one depth;
* :class:`QuantH2OCache`, the same policy over sub-byte per-token codes
  (min/max over feature groups) with a dense ring of the most recent
  tokens;
* the slot caches of the serving engine (:class:`SlotH2OPrefillCache`,
  :class:`SlotH2ODecodeCache`), where every batch row is a request at its
  own depth, with per-slot lengths on the device.

Like the port's other caches these write in place; ``finalize`` returns
the state for the next step. The batched caches keep their length on the
device with a host mirror, whose value decides between filling the next
slot and evicting (the same for every row), so no step reads the device.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from .cache import _inv_levels, _per


def _check_recent(recent_window: int, budget: int) -> int:
    if recent_window >= budget:
        # with every slot protected the masked argmin would return slot 0
        # and silently evict a heavy hitter each step
        raise ValueError(
            f"recent_window={recent_window} must be < the H2O budget "
            f"({budget}) or eviction degenerates")
    return int(recent_window)


def _check_prompt(S: int, budget: int) -> None:
    if S > budget:
        raise ValueError(f"a prompt of {S} tokens does not fit the H2O "
                         f"budget of {budget} slots")


def _victims(pos: torch.Tensor, score: torch.Tensor,
             seen, recent_window: int) -> torch.Tensor:
    """(B,) lowest-score slot outside the recent window; ``seen`` is an int
    or a (B,) tensor of tokens seen."""
    if isinstance(seen, torch.Tensor):
        seen = seen[:, None]
    protected = pos >= seen - recent_window
    neg = torch.where(protected, torch.inf, score)
    return torch.argmin(neg, dim=1)


def _slot_mask(pos: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """(B, 1, S, budget): a slot is seen by a query at or after its
    position; empty slots (-1) never."""
    m = ((pos[:, None, :] <= positions[..., None]) & (pos[:, None, :] >= 0))
    return m[:, None]


def _prompt_pos(positions: torch.Tensor, budget: int) -> torch.Tensor:
    B, S = positions.shape
    return torch.cat([positions.to(torch.int32),
                      positions.new_full((B, budget - S), -1,
                                         dtype=torch.int32)], dim=1)


# ---------------------------------------------------------------------------
# H2OCache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class H2OKVState:
    k: torch.Tensor             # (L, B, budget, KVH, hd)
    v: torch.Tensor
    pos: torch.Tensor           # (L, B, budget) int32 real position; -1 empty
    score: torch.Tensor         # (L, B, budget) f32 accumulated mass
    length: torch.Tensor        # 0-d int32: tokens SEEN (not kept)
    host_length: int = 0        # the host's mirror of ``length``


def init_h2o_cache(n_layers, batch, budget, kv_heads, head_dim,
                   dtype=torch.bfloat16, device="cuda") -> H2OKVState:
    dev = resolve_device(device)
    shape = (n_layers, batch, budget, kv_heads, head_dim)
    return H2OKVState(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        pos=torch.full((n_layers, batch, budget), -1, dtype=torch.int32,
                       device=dev),
        score=torch.zeros((n_layers, batch, budget), dtype=torch.float32,
                          device=dev),
        length=torch.zeros((), dtype=torch.int32, device=dev))


class _Advance:
    """Device length and host mirror advanced once per step, in
    ``finalize``, by the tokens the step wrote."""

    _written = 0

    def finalize(self):
        st = self.state
        if self._written:
            st.length.add_(self._written)
            st.host_length += self._written
            self._written = 0
        return st


class H2OCache(_Advance):
    """Heavy-hitter eviction with the decode-cache protocol (``update``
    -> (k, v, mask); ``finalize`` -> state) and ``observe``, which the
    attention calls with the softmax probabilities summed over heads and
    query rows, (B, budget)."""

    def __init__(self, state: H2OKVState, recent_window: int = 8):
        self.state = state
        self.recent_window = _check_recent(recent_window, state.k.shape[2])

    def update(self, layer_idx: int, k, v, positions, mask):
        st = self.state
        B, S, _, _ = k.shape
        budget = st.k.shape[2]
        seen = st.host_length
        if S > 1:
            # prefill: the prompt must fit (decode alone evicts)
            _check_prompt(S, budget)
            st.k[layer_idx, :, :S] = k.to(st.k.dtype)
            st.v[layer_idx, :, :S] = v.to(st.v.dtype)
            st.pos[layer_idx] = _prompt_pos(positions, budget)
            st.score[layer_idx] = 0.0
        else:
            # the next free slot while under budget, else the victim
            if seen < budget:
                tgt = torch.full((B,), seen, dtype=torch.long,
                                 device=k.device)
            else:
                tgt = _victims(st.pos[layer_idx], st.score[layer_idx], seen,
                               self.recent_window)
            bidx = torch.arange(B, device=k.device)
            st.k[layer_idx, bidx, tgt] = k[:, 0].to(st.k.dtype)
            st.v[layer_idx, bidx, tgt] = v[:, 0].to(st.v.dtype)
            st.pos[layer_idx, bidx, tgt] = positions[:, 0].to(torch.int32)
            st.score[layer_idx, bidx, tgt] = 0.0
        self._written = S
        return (st.k[layer_idx], st.v[layer_idx],
                _slot_mask(st.pos[layer_idx], positions))

    def observe(self, layer_idx: int, probs):
        """Add (B, budget) attention mass to the layer's slot scores."""
        self.state.score[layer_idx] += probs.to(torch.float32)


# ---------------------------------------------------------------------------
# QuantH2OCache: H2O over quantized slots plus a dense residual ring
# ---------------------------------------------------------------------------
def _pack_last(codes: torch.Tensor, per: int, bits: int) -> torch.Tensor:
    """(..., hd) uint8 codes < 2^bits -> (..., hd // per), field-major."""
    if per == 1:
        return codes
    *lead, hd = codes.shape
    c = codes.reshape(*lead, per, hd // per).to(torch.uint8)
    out = c[..., 0, :].clone()
    for i in range(1, per):
        out |= c[..., i, :] << (bits * i)
    return out


def _unpack_last(packed: torch.Tensor, per: int, bits: int) -> torch.Tensor:
    if per == 1:
        return packed
    mask = (1 << bits) - 1
    return torch.cat([(packed >> (bits * i)) & mask for i in range(per)],
                     dim=-1)


def _qtok(x: torch.Tensor, bits: int, g: int):
    """Per-token min/max quant over feature groups of g along the last axis:
    x (..., hd) -> (packed codes (..., hd // per), mn, sc (..., G))."""
    hd = x.shape[-1]
    g = min(g, hd)
    G = hd // g
    xg = x.to(torch.float32).reshape(x.shape[:-1] + (G, g))
    mn = xg.amin(-1)
    sc = (xg.amax(-1) - mn) * _inv_levels(bits)
    sc = torch.where(sc == 0, 1.0, sc)
    codes = torch.clamp(torch.round((xg - mn[..., None]) / sc[..., None]),
                        0, 2 ** bits - 1).to(torch.uint8)
    return _pack_last(codes.reshape(x.shape), _per(bits), bits), mn, sc


def _dqtok(packed, mn, sc, bits: int, dtype) -> torch.Tensor:
    codes = _unpack_last(packed, _per(bits), bits)
    G = mn.shape[-1]
    hd = codes.shape[-1]
    xg = codes.to(torch.float32).reshape(codes.shape[:-1] + (G, hd // G))
    return (xg * sc[..., None] + mn[..., None]).reshape(codes.shape).to(dtype)


_QFIELDS = ("ck", "mnk", "sck", "cv", "mnv", "scv")


@dataclasses.dataclass
class QuantH2OKVState:
    ck: torch.Tensor            # (L, B, budget, KVH, hd // per) uint8 codes
    mnk: torch.Tensor           # (L, B, budget, KVH, G) f32
    sck: torch.Tensor           # (L, B, budget, KVH, G) f32
    cv: torch.Tensor
    mnv: torch.Tensor
    scv: torch.Tensor
    rk: torch.Tensor            # (L, B, R, KVH, hd) dense residual ring
    rv: torch.Tensor
    rpos: torch.Tensor          # (L, B, R) int32 position held; -1 empty
    pos: torch.Tensor           # (L, B, budget) int32; -1 empty
    score: torch.Tensor         # (L, B, budget) f32
    length: torch.Tensor        # 0-d int32: tokens SEEN
    bits: int = 4
    group: int = 32
    host_length: int = 0


def init_quant_h2o_cache(n_layers, batch, budget, kv_heads, head_dim,
                         bits=4, group=32, residual_len=8,
                         dtype=torch.bfloat16,
                         device="cuda") -> QuantH2OKVState:
    dev = resolve_device(device)
    g = min(group, head_dim)
    while head_dim % g:            # round down to a divisor of head_dim
        g -= 1
    G = head_dim // g
    per = _per(bits)
    if head_dim % per:
        raise ValueError(
            f"head_dim={head_dim} must be divisible by the packing factor "
            f"{per} (= 8 // bits for bits={bits}); pad head_dim or use a "
            "wider bit width")
    L, B, R = n_layers, batch, residual_len

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=dev)

    codes = (L, B, budget, kv_heads, head_dim // per)
    scales = (L, B, budget, kv_heads, G)
    return QuantH2OKVState(
        ck=full(codes, 0, torch.uint8), mnk=full(scales, 0, torch.float32),
        sck=full(scales, 1, torch.float32),
        cv=full(codes, 0, torch.uint8), mnv=full(scales, 0, torch.float32),
        scv=full(scales, 1, torch.float32),
        rk=full((L, B, R, kv_heads, head_dim), 0, dtype),
        rv=full((L, B, R, kv_heads, head_dim), 0, dtype),
        rpos=full((L, B, R), -1, torch.int32),
        pos=full((L, B, budget), -1, torch.int32),
        score=full((L, B, budget), 0, torch.float32),
        length=full((), 0, torch.int32), bits=bits, group=g)


class QuantH2OCache(_Advance):
    """H2O eviction over quantized slots (decode-cache protocol plus
    ``observe``); a drop-in for :class:`H2OCache`. The attention sees the
    dequantized slots, with the tokens still in the residual ring exact."""

    def __init__(self, state: QuantH2OKVState, recent_window: int = 8):
        self.state = state
        self.recent_window = _check_recent(recent_window,
                                           state.pos.shape[2])

    def _write_slots(self, layer_idx, b, slot, k, v) -> None:
        """Quantize tokens into the (batch, slot) indices ``b``, ``slot``."""
        st = self.state
        ck, mnk, sck = _qtok(k, st.bits, st.group)
        cv, mnv, scv = _qtok(v, st.bits, st.group)
        for name, val in zip(_QFIELDS, (ck, mnk, sck, cv, mnv, scv)):
            getattr(st, name)[layer_idx, b, slot] = val

    def _view(self, layer_idx: int):
        """Dequantized (B, budget, KVH, hd) K and V, ring tokens exact."""
        st = self.state
        dt = st.rk.dtype
        k = _dqtok(st.ck[layer_idx], st.mnk[layer_idx], st.sck[layer_idx],
                   st.bits, dt)
        v = _dqtok(st.cv[layer_idx], st.mnv[layer_idx], st.scv[layer_idx],
                   st.bits, dt)
        R = st.rk.shape[2]
        if R:
            slot_pos = st.pos[layer_idx]                     # (B, budget)
            ridx = torch.clamp(slot_pos, min=0).long() % R
            rp = torch.gather(st.rpos[layer_idx], 1, ridx)
            fresh = ((rp == slot_pos) & (slot_pos >= 0))[..., None, None]
            idx4 = ridx[..., None, None].expand(ridx.shape + st.rk.shape[3:])
            k = torch.where(fresh, torch.gather(st.rk[layer_idx], 1, idx4),
                            k)
            v = torch.where(fresh, torch.gather(st.rv[layer_idx], 1, idx4),
                            v)
        return k, v

    def update(self, layer_idx: int, k, v, positions, mask):
        st = self.state
        B, S, _, _ = k.shape
        budget = st.pos.shape[2]
        R = st.rk.shape[2]
        bidx = torch.arange(B, device=k.device)
        seen = st.host_length
        if S > 1:
            _check_prompt(S, budget)
            self._write_slots(layer_idx, bidx[:, None],
                              torch.arange(S, device=k.device)[None, :],
                              k, v)
            st.pos[layer_idx] = _prompt_pos(positions, budget)
            st.score[layer_idx] = 0.0
            if R:
                # the last min(R, S) prompt tokens go to the ring; p % R is
                # unique among consecutive positions, so no write collides
                Rs = min(R, S)
                ridx = positions[:, S - Rs:].long() % R
                st.rk[layer_idx, bidx[:, None], ridx] = k[:, S - Rs:].to(
                    st.rk.dtype)
                st.rv[layer_idx, bidx[:, None], ridx] = v[:, S - Rs:].to(
                    st.rv.dtype)
                st.rpos[layer_idx, bidx[:, None], ridx] = positions[
                    :, S - Rs:].to(torch.int32)
        else:
            if seen < budget:
                tgt = torch.full((B,), seen, dtype=torch.long,
                                 device=k.device)
            else:
                tgt = _victims(st.pos[layer_idx], st.score[layer_idx], seen,
                               self.recent_window)
            self._write_slots(layer_idx, bidx, tgt, k[:, 0], v[:, 0])
            st.pos[layer_idx, bidx, tgt] = positions[:, 0].to(torch.int32)
            st.score[layer_idx, bidx, tgt] = 0.0
            if R:
                ridx = positions[:, 0].long() % R
                st.rk[layer_idx, bidx, ridx] = k[:, 0].to(st.rk.dtype)
                st.rv[layer_idx, bidx, ridx] = v[:, 0].to(st.rv.dtype)
                st.rpos[layer_idx, bidx, ridx] = positions[:, 0].to(
                    torch.int32)
        self._written = S
        kd, vd = self._view(layer_idx)
        return kd, vd, _slot_mask(st.pos[layer_idx], positions)

    def observe(self, layer_idx: int, probs):
        self.state.score[layer_idx] += probs.to(torch.float32)


# ---------------------------------------------------------------------------
# The serving engine's slot pool: every row an independent request
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SlotH2OKVState:
    k: torch.Tensor             # (L, B, budget, KVH, hd)
    v: torch.Tensor
    pos: torch.Tensor           # (L, B, budget) int32; -1 empty
    score: torch.Tensor         # (L, B, budget) f32
    lengths: torch.Tensor       # (B,) int32 on the device: tokens SEEN


def init_slot_h2o_cache(n_layers, n_slots, budget, kv_heads, head_dim,
                        dtype=torch.bfloat16,
                        device="cuda") -> SlotH2OKVState:
    st = init_h2o_cache(n_layers, n_slots, budget, kv_heads, head_dim,
                        dtype, device)
    return SlotH2OKVState(st.k, st.v, st.pos, st.score,
                          torch.zeros((n_slots,), dtype=torch.int32,
                                      device=st.k.device))


class SlotH2OPrefillCache:
    """Prefill of one admitted slot (a batch of one, right-padded to a
    bucket). Pad KEY rows are recorded with position -1: they are never
    attended and are the first slots a decode step fills. Pad QUERY rows
    attend to nothing, so their softmax spreads 1/budget over every slot,
    and ``observe`` adds that mass to the scores as the JAX cache does
    (a bias toward the slots that decode fills later; see ROADMAP queue
    3)."""

    def __init__(self, state: SlotH2OKVState, slot: int, true_len: int):
        self.state = state
        self.slot = int(slot)
        self.true_len = int(true_len)

    def update(self, layer_idx: int, k, v, positions, mask):
        st = self.state
        B, S, _, _ = k.shape
        if B != 1:
            raise ValueError("slot prefill takes one admitted request")
        budget = st.k.shape[2]
        _check_prompt(S, budget)
        slot = self.slot
        real = positions[0] < self.true_len                 # (S,)
        st.k[layer_idx, slot, :S] = k[0].to(st.k.dtype)
        st.v[layer_idx, slot, :S] = v[0].to(st.v.dtype)
        pos_row = _prompt_pos(torch.where(real, positions[0], -1)[None],
                              budget)[0]
        st.pos[layer_idx, slot] = pos_row
        st.score[layer_idx, slot] = 0.0
        amask = ((pos_row[None, None, :] <= positions[..., None])
                 & (pos_row[None, None, :] >= 0) & real[None, :, None])
        return (st.k[layer_idx, slot:slot + 1],
                st.v[layer_idx, slot:slot + 1], amask[:, None])

    def observe(self, layer_idx: int, probs):
        self.state.score[layer_idx, self.slot] += probs[0].to(torch.float32)

    def finalize(self, true_len: int) -> SlotH2OKVState:
        lengths = self.state.lengths.clone()
        lengths[self.slot] = true_len
        return dataclasses.replace(self.state, lengths=lengths)


class SlotH2ODecodeCache:
    """One batched H2O decode step over independent slots, at each slot's
    own depth (``lengths`` on the device). Inactive slots still write and
    evict (their stores are garbage between requests and reset at the next
    admission) but neither advance nor gather score."""

    def __init__(self, state: SlotH2OKVState, active: torch.Tensor,
                 recent_window: int = 8):
        self.state = state
        self.active = active                                # (B,) bool
        self.recent_window = _check_recent(recent_window,
                                           state.pos.shape[2])

    def update(self, layer_idx: int, k, v, positions, mask):
        st = self.state
        B, S, _, _ = k.shape
        if S != 1:
            raise ValueError("slot decode takes one token a slot")
        budget = st.k.shape[2]
        seen = st.lengths
        victim = _victims(st.pos[layer_idx], st.score[layer_idx], seen,
                          self.recent_window)
        tgt = torch.where(seen < budget,
                          torch.clamp(seen, 0, budget - 1).long(), victim)
        bidx = torch.arange(B, device=k.device)
        st.k[layer_idx, bidx, tgt] = k[:, 0].to(st.k.dtype)
        st.v[layer_idx, bidx, tgt] = v[:, 0].to(st.v.dtype)
        st.pos[layer_idx, bidx, tgt] = positions[:, 0].to(torch.int32)
        st.score[layer_idx, bidx, tgt] = 0.0
        return (st.k[layer_idx], st.v[layer_idx],
                _slot_mask(st.pos[layer_idx], positions))

    def observe(self, layer_idx: int, probs):
        self.state.score[layer_idx] += torch.where(
            self.active[:, None], probs.to(torch.float32), 0.0)

    def finalize(self) -> SlotH2OKVState:
        return dataclasses.replace(
            self.state,
            lengths=self.state.lengths + self.active.to(torch.int32))

