"""Sink (attention-sink / StreamingLLM) rolling-window KV cache.

Counterpart of ``microscopiq_tpu/kv/sink.py``: a fixed (sink + window)
buffer keeps the first ``sink_tokens`` tokens and a rolling window of the
most recent ones. Keys are stored rotated to their slot; on overflow the
non-sink region shifts left by one slot and its keys are rotated one slot
back (``_rope_delta``), so that every key's phase matches its slot; queries
use the clamped slot position (:meth:`SinkDecodeCache.slot_positions`).

Like the port's other caches it writes in place, and it keeps its length
on the device with a host mirror: the choice between append and evict
(``lax.cond`` in JAX) and the live-slot mask read the mirror, never the
device.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device


@dataclasses.dataclass
class SinkKVState:
    k: torch.Tensor             # (L, B, C, KVH, hd), keys at their SLOT phase
    v: torch.Tensor
    length: torch.Tensor        # 0-d int32 on the device: tokens seen
    host_length: int = 0        # the host's mirror of ``length``


def init_sink_cache(n_layers, batch, sink_tokens, window, kv_heads,
                    head_dim, dtype=torch.bfloat16,
                    device="cuda") -> SinkKVState:
    dev = resolve_device(device)
    shape = (n_layers, batch, sink_tokens + window, kv_heads, head_dim)
    return SinkKVState(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev), 0)


def _rope_delta(k: torch.Tensor, delta: float, theta: float) -> torch.Tensor:
    """Rotate keys (..., hd) by ``delta`` positions, in float32."""
    hd = k.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=k.device) / hd))
    ang = delta * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(k.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(k.dtype)


class SinkDecodeCache:
    """Sink cache with the decode-cache protocol. Keys must arrive rotated
    to their slot position: call the model with ``positions`` from
    :meth:`slot_positions`."""

    def __init__(self, state: SinkKVState, sink_tokens: int,
                 rope_theta: float = 10000.0):
        self.state = state
        self.sink = sink_tokens
        self.theta = rope_theta
        self._written = 0

    @property
    def capacity(self) -> int:
        return self.state.k.shape[2]

    def slot_positions(self, n_new: int = 1) -> torch.Tensor:
        """(n_new,) positions the incoming tokens are rotated at: their
        slot, clamped to the last one."""
        st = self.state
        return torch.clamp(st.length + torch.arange(
            n_new, device=st.length.device), max=self.capacity - 1)

    def update(self, layer_idx: int, k, v, positions, mask):
        st = self.state
        B, S, KVH, hd = k.shape
        C, sink, at = self.capacity, self.sink, st.host_length
        kl, vl = st.k[layer_idx], st.v[layer_idx]
        if S > 1 or at < C:
            if at + S > C:
                raise ValueError(f"sink cache holds {C} slots; {at} used, "
                                 f"{S} more requested")
            kl[:, at:at + S] = k.to(kl.dtype)
            vl[:, at:at + S] = v.to(vl.dtype)
        else:
            # shift the non-sink region left by one slot, its keys rotated
            # one slot back; the new token takes the last slot
            kl[:, sink:C - 1] = _rope_delta(kl[:, sink + 1:], -1.0,
                                            self.theta)
            vl[:, sink:C - 1] = vl[:, sink + 1:].clone()
            kl[:, C - 1] = k[:, 0].to(kl.dtype)
            vl[:, C - 1] = v[:, 0].to(vl.dtype)
        self._written = S
        key_slot = torch.arange(C, device=k.device)
        valid = key_slot[None, None, :] < min(at + S, C)
        if S > 1:
            m = (key_slot[None, None, :] <= positions[..., None]) & valid
        else:
            m = valid                   # decode: every live slot
        return kl, vl, m[:, None, :, :]

    def finalize(self) -> SinkKVState:
        st = self.state
        if self._written:
            st.length.add_(self._written)
            st.host_length += self._written
            self._written = 0
        return st
