"""Continuous-batching serving engine over a fixed pool of KV-cache slots.

Counterpart of ``microscopiq_tpu/serve/engine.py`` (``SlotKVState``,
``SlotDecodeCache``, ``SlotPrefillCache``, ``Request``, ``_bucket``,
``BatchEngine``, ``engine_generate_stream_fn``) with
``cache_kind="dense"``, ``"quant"`` (the quantized slot caches of
``kv/cache.py``) or ``"h2o"`` (heavy-hitter eviction per slot, the slot
caches of ``kv/h2o.py``):

- a slot KV cache with a per-slot length vector; the attention mask derives
  from per-token positions, so slots at different depths share one batched
  decode step;
- a prefill per admitted request, right-padded to a prompt-length bucket,
  writes K/V into that slot's rows;
- a host scheduler admits queued requests into free slots between decode
  steps and retires slots on EOS or max tokens, so requests join and leave
  without stopping decode for the others.

The model holds its weights (the JAX engine takes them as ``params``). K/V
are written into the slot buffers in place.
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..eval.generate import DEVICE_LOCK, sample_logits
from ..kv.cache import (QuantKVConfig, SlotQuantizedDecodeCache,
                        SlotQuantPrefillCache, init_slot_quant_cache)
from ..kv.h2o import (SlotH2ODecodeCache, SlotH2OPrefillCache,
                      init_slot_h2o_cache)
from ..utils.observability import metrics


# ---------------------------------------------------------------------------
# Slot KV cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SlotKVState:
    k: torch.Tensor             # (L, B, S_max, KVH, hd)
    v: torch.Tensor
    lengths: torch.Tensor       # (B,) int64 per-slot token count


def init_slot_cache(n_layers, n_slots, max_len, kv_heads, head_dim,
                    dtype=torch.bfloat16, device="cuda") -> SlotKVState:
    dev = resolve_device(device)
    shape = (n_layers, n_slots, max_len, kv_heads, head_dim)
    return SlotKVState(torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros((n_slots,), dtype=torch.int64,
                                   device=dev))


class SlotDecodeCache:
    """Batched decode over independent slots: slot b writes at its own
    ``lengths[b]``. The mask ``key_pos <= q_pos`` enforces causality and
    hides stale rows past a slot's length, because a slot's position always
    equals its own depth."""

    def __init__(self, state: SlotKVState, active: torch.Tensor):
        self.state = state
        self.active = active                    # (B,) bool
        self._new_len = state.lengths

    def update(self, layer_idx: int, k, v, positions, mask):
        st = self.state
        B, S, KVH, hd = k.shape
        S_max = st.k.shape[2]
        # a write that would run past the end starts earlier, as
        # lax.dynamic_update_slice clamps its start
        start = torch.clamp(st.lengths, max=S_max - S)
        rows = start[:, None] + torch.arange(S, device=k.device)   # (B, S)
        slot = torch.arange(B, device=k.device)[:, None].expand(B, S)
        st.k[layer_idx, slot, rows] = k.to(st.k.dtype)
        st.v[layer_idx, slot, rows] = v.to(st.v.dtype)
        # inactive slots re-write their row and do not advance
        self._new_len = torch.where(self.active, st.lengths + S, st.lengths)
        key_pos = torch.arange(S_max, device=k.device)
        m = key_pos[None, None, :] <= positions[..., None]     # (B, S, S_max)
        return st.k[layer_idx], st.v[layer_idx], m[:, None, :, :]

    def finalize(self) -> SlotKVState:
        return SlotKVState(self.state.k, self.state.v, self._new_len)


class SlotPrefillCache:
    """Writes one sequence's K/V into rows [0, S) of one slot."""

    def __init__(self, state: SlotKVState, slot: int):
        self.state = state
        self.slot = slot

    def update(self, layer_idx: int, k, v, positions, mask):
        st = self.state
        _, S, _, _ = k.shape                    # batch of one
        st.k[layer_idx, self.slot, :S] = k[0].to(st.k.dtype)
        st.v[layer_idx, self.slot, :S] = v[0].to(st.v.dtype)
        key_pos = torch.arange(S, device=k.device)
        m = key_pos[None, None, :] <= positions[..., None]
        return k, v, m[:, None, :, :]

    def finalize(self, true_len: int) -> SlotKVState:
        lengths = self.state.lengths.clone()
        lengths[self.slot] = true_len
        return SlotKVState(self.state.k, self.state.v, lengths)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    prompt_ids: np.ndarray                  # (S,) int32
    max_new_tokens: int = 64
    eos_id: int = -1                        # -1: never stops on a token
    temperature: float = 0.0                # 0 = greedy
    # called with (new_token:int, done:bool) from the scheduler thread
    on_token: Optional[Callable[[int, bool], None]] = None
    # filled by the engine
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None


def _lengths(state) -> torch.Tensor:
    """Per-slot depths of a dense or H2O (``lengths``) or quantized
    (``length``) slot state."""
    return state.lengths if hasattr(state, "lengths") else state.length


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket "
                     f"{buckets[-1]}")


class BatchEngine:
    """Continuous-batching decode engine over a fixed slot pool.

    Per-request temperature: 0 = greedy, > 0 = categorical sampling from a
    ``torch.Generator`` seeded with ``seed``. ``cache_kind`` "dense" keeps
    bf16 K/V slots; "quant" keeps the quantized slot cache of ``quant_cfg``
    (default ``QuantKVConfig()``), whose gap must divide ``max_len``; "h2o"
    keeps ``h2o_budget`` slots a request (default: the largest prompt
    bucket, and never fewer, so that a prefill fits) and evicts the
    lowest-score slot outside the ``h2o_recent`` newest tokens, while
    ``max_len`` still bounds positions and new tokens. A budget under the
    largest bucket raises ValueError (the JAX engine asserts).
    ``device`` defaults to "cuda" and must be the model's device.
    """

    def __init__(self, model, n_slots: int = 8, max_len: int = 512,
                 prompt_buckets=(32, 64, 128, 256),
                 cache_dtype=torch.bfloat16, seed: int = 0,
                 cache_kind: str = "dense", quant_cfg=None,
                 h2o_budget: int = 0, h2o_recent: int = 8, device="cuda"):
        if cache_kind not in ("dense", "quant", "h2o"):
            raise ValueError(f"unknown cache_kind {cache_kind!r}")
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"model is on {model.device}, engine on {dev}")
        self.buckets = tuple(sorted(prompt_buckets))
        if self.buckets[-1] > max_len:
            raise ValueError("largest prompt bucket exceeds max_len")
        cfg = model.cfg
        self.model = model
        self.device = dev
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache_kind = cache_kind
        dims = (cfg.num_hidden_layers, n_slots, max_len,
                cfg.num_key_value_heads, cfg.head_dim)
        if cache_kind == "h2o":
            budget = h2o_budget or self.buckets[-1]
            if budget < self.buckets[-1]:
                raise ValueError(f"h2o_budget {budget} is under the largest "
                                 f"prompt bucket {self.buckets[-1]}")
            self.state = init_slot_h2o_cache(*dims[:2], budget, *dims[3:],
                                             cache_dtype, device=dev)
            self._mk_prefill = SlotH2OPrefillCache
            self._mk_decode = lambda st, act: SlotH2ODecodeCache(
                st, act, h2o_recent)
        elif cache_kind == "quant":
            qcfg = quant_cfg or QuantKVConfig()
            if max_len % qcfg.gap:
                raise ValueError(f"max_len {max_len} is not a multiple of "
                                 f"the quantization gap {qcfg.gap}")
            self.state = init_slot_quant_cache(*dims, qcfg, device=dev)
            self._mk_prefill = lambda st, slot, tl: SlotQuantPrefillCache(
                st, qcfg, slot, tl)
            self._mk_decode = lambda st, act: SlotQuantizedDecodeCache(
                st, qcfg, act)
        else:
            self.state = init_slot_cache(*dims, cache_dtype, device=dev)
            self._mk_prefill = lambda st, slot, tl: SlotPrefillCache(st, slot)
            self._mk_decode = SlotDecodeCache
        # host-side per-slot bookkeeping
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.tokens = np.zeros((n_slots,), np.int64)
        self.remaining = np.zeros((n_slots,), np.int32)
        self.temps = np.zeros((n_slots,), np.float32)
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        self._lock = DEVICE_LOCK        # shared with eval.generate
        self._queue: "queue.Queue[Request]" = queue.Queue()

    # ---- device steps ----------------------------------------------------
    def _sample(self, logits: torch.Tensor, temps: np.ndarray
                ) -> torch.Tensor:
        """Per-row temperature: 0 = greedy, else categorical."""
        return sample_logits(logits, temps, self._gen)

    @torch.inference_mode()
    def _prefill(self, ids: np.ndarray, slot: int, true_len: int,
                 temp: float) -> int:
        cache = self._mk_prefill(self.state, slot, true_len)
        S = ids.shape[1]
        ids_t = torch.as_tensor(ids, device=self.device)
        pos = torch.arange(S, device=self.device)[None, :]
        # the last REAL token's hidden state goes to the lm_head (ids are
        # right-padded to a bucket), so the vocab matmul runs on one token
        logits = self.model(ids_t, positions=pos, cache=cache,
                            logit_index=[true_len - 1])
        tok = self._sample(logits[:, 0], np.asarray([temp], np.float32))
        self.state = cache.finalize(true_len)
        return int(tok[0])

    @torch.inference_mode()
    def _decode(self, active: np.ndarray) -> np.ndarray:
        act = torch.as_tensor(active, device=self.device)
        toks = torch.as_tensor(self.tokens, device=self.device)
        cache = self._mk_decode(self.state, act)
        pos = _lengths(self.state)[:, None]              # (B, 1)
        logits = self.model(toks[:, None], positions=pos, cache=cache)
        nxt = self._sample(logits[:, -1], self.temps)
        self.state = cache.finalize()
        return torch.where(act, nxt, toks).cpu().numpy()

    # ---- scheduling ------------------------------------------------------
    def submit(self, req: Request):
        self._queue.put(req)

    def _admit(self, req: Request, slot: int):
        ids = np.asarray(req.prompt_ids, np.int64).reshape(-1)
        S = _bucket(len(ids), self.buckets)
        if len(ids) + req.max_new_tokens > self.max_len:
            req.max_new_tokens = self.max_len - len(ids)
        padded = np.zeros((1, S), np.int64)
        padded[0, :len(ids)] = ids
        t = self._prefill(padded, slot, len(ids), req.temperature)
        self.slot_req[slot] = req
        self.tokens[slot] = t
        self.remaining[slot] = req.max_new_tokens
        self.temps[slot] = req.temperature
        self._emit(req, slot, t)

    def _emit(self, req: Request, slot: int, tok: int):
        req.out_tokens.append(tok)
        self.remaining[slot] -= 1
        if tok == req.eos_id or self.remaining[slot] <= 0:
            req.done = True
            self.slot_req[slot] = None
        if req.on_token is not None:
            req.on_token(tok, req.done)

    def _active_mask(self) -> np.ndarray:
        return np.asarray([r is not None for r in self.slot_req])

    def step(self) -> int:
        """Admit pending requests into free slots, run one decode step.
        Returns the number of live slots after the step."""
        with self._lock:
            for slot in range(self.n_slots):
                if self.slot_req[slot] is None:
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    try:
                        with metrics.timer("engine.prefill"):
                            self._admit(req, slot)
                        metrics.count("engine.admitted")
                    except ValueError as e:
                        # reject (e.g. prompt exceeds the largest bucket)
                        # without killing the other requests
                        req.error = str(e)
                        req.done = True
                        metrics.count("engine.rejected")
                        if req.on_token is not None:
                            req.on_token(-1, True)
            active = self._active_mask()
            metrics.gauge("engine.active_slots", int(active.sum()))
            metrics.gauge("engine.queued", self._queue.qsize())
            if not active.any():
                return 0
            with metrics.timer("engine.decode_step"):
                toks = self._decode(active)
            metrics.count("engine.tokens", int(active.sum()))
            for slot in range(self.n_slots):
                req = self.slot_req[slot]
                if req is not None:
                    self.tokens[slot] = toks[slot]
                    self._emit(req, slot, int(toks[slot]))
            return sum(r is not None for r in self.slot_req)

    def run_until_drained(self, max_steps: int = 100000):
        """Drive steps until queue and slots are empty (offline batch)."""
        steps = 0
        while (not self._queue.empty() or self._active_mask().any()) \
                and steps < max_steps:
            self.step()
            steps += 1

    def generate(self, prompts: List[np.ndarray], max_new_tokens: int = 64,
                 eos_id: int = -1,
                 temperature: float = 0.0) -> List[List[int]]:
        """Batch-generate: submit all, drain, return token lists."""
        reqs = [Request(np.asarray(p), max_new_tokens, eos_id,
                        temperature=temperature)
                for p in prompts]
        for r in reqs:
            self.submit(r)
        self.run_until_drained()
        return [r.out_tokens for r in reqs]


def engine_generate_stream_fn(engine: BatchEngine, tokenizer,
                              poll_s: float = 0.0):
    """Adapt a BatchEngine to the worker's generate_stream_fn protocol:
    tokens stream out as the scheduler produces them, interleaved with
    other in-flight requests. Concurrent HTTP threads each drive
    ``engine.step()``; the engine's lock serializes the steps, which stay
    eager."""

    def fn(prompt: str, max_new_tokens: int, temperature: float):
        out: "queue.Queue" = queue.Queue()
        req = Request(np.asarray(tokenizer.encode(prompt), np.int32),
                      max_new_tokens,
                      eos_id=getattr(tokenizer, "eos_id", -1),
                      temperature=temperature,
                      on_token=lambda t, d: out.put((t, d)))
        engine.submit(req)
        toks: List[int] = []
        while True:
            engine.step()
            try:
                while True:
                    t, d = out.get_nowait()
                    if t >= 0:                # -1 = rejection sentinel
                        toks.append(t)
                        yield tokenizer.decode(toks)
                    if d:
                        return
            except queue.Empty:
                pass

    return fn
