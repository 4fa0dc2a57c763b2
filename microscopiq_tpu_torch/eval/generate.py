"""Greedy or temperature decode of a (left-padded) batch over the dense or
quantized KV cache.

Counterpart of ``microscopiq_tpu/eval/generate.py::generate``: one prefill
on the last position only, then one decode step per token. Rows are
right-aligned (left-padded, as HF ``padding_side="left"``); pad slots never
attend, real positions are ``slot - offset[b]``, and rows that hit EOS emit
``pad_token_id`` after it. Above temperature 0 every token, the prefill's
too, is one categorical draw from softmax(logits / temperature) by
``torch.multinomial`` with a ``torch.Generator`` (JAX splits a key for
``jax.random.categorical``; the two draw different samples from the same
distribution), the serving engine's arithmetic (:func:`sample_logits`).

A decode step is :class:`DecodeStep`: on a CUDA model the first call of
each of its variants runs eagerly (it builds the kernels and its token is
kept), the next captures the step in a CUDA graph and every call from then
on replays it, so that the host launches one graph a token instead of
every kernel of the step; on the CPU each call runs the step eagerly. The
dense cache has one variant; the quantized cache two, the plain step and
the step that folds a chunk, which the host mirror of the cache length
names before each step. The prefill stays eager (one call, with M = B x S
rows on the GEMMs). Sampled steps (temperature > 0) run eagerly too: a
replayed draw would need the generator's state registered with each graph,
and an eager step draws from the generator in the same order on the card
as on the CPU.

This is the single-sequence reference the serving engine is checked
against, and the prefill + decode loop ``chip_smoke.py`` times.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..kv.cache import (DenseDecodeCache, QuantizedDecodeCache,
                        QuantKVConfig, check_dense_room, check_quant_room,
                        init_dense_cache, init_quant_cache, next_fold_length,
                        quant_fold_step)


# Serializes the threads of one process that launch on the card: a CUDA-graph
# capture (the second call of a ``DecodeStep`` variant) fails if another
# thread launches work while it runs. ``generate`` holds it for its whole
# call and ``serve.engine.BatchEngine`` for each step, so that a server may
# run both from its request threads.
DEVICE_LOCK = threading.RLock()


def _holding_device_lock(fn):
    @functools.wraps(fn)
    def locked(*args, **kwargs):
        with DEVICE_LOCK:
            return fn(*args, **kwargs)
    return locked


def _make_cache(kind, cfg_model, batch, max_len, quant_cfg, offset, device):
    """(initial state, cache wrapper) for ``kind`` "dense" or "quant"."""
    args = (cfg_model.num_hidden_layers, batch, max_len,
            cfg_model.num_key_value_heads, cfg_model.head_dim)
    if kind == "dense":
        return (init_dense_cache(*args, offset=offset, device=device),
                DenseDecodeCache)
    if kind == "quant":
        quant_cfg = quant_cfg or QuantKVConfig()
        state = init_quant_cache(*args, quant_cfg, offset=offset,
                                 device=device)
        return state, lambda st: QuantizedDecodeCache(st, quant_cfg)
    raise ValueError(f"unknown cache_kind {kind!r}")


def sample_logits(logits: torch.Tensor, temps: np.ndarray,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B,) tokens of (B, vocab) logits at per-row temperatures ``temps``
    (a host array): 0 = greedy, else a categorical draw."""
    greedy = torch.argmax(logits, dim=-1)
    if not (temps > 0).any():
        return greedy
    t = torch.as_tensor(temps, device=logits.device)
    scaled = logits.to(torch.float32) / torch.clamp(t, min=1e-6)[:, None]
    drawn = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                              generator=generator)[:, 0]
    return torch.where(t > 0, drawn, greedy)


class DecodeStep:
    """One decode step over a dense or (with ``quant_cfg``) a quantized
    cache, on static buffers; greedy, or at ``temperature`` > 0 a draw from
    ``generator`` (every such step eager).

    ``tok`` (B,) holds the token fed to the step and, after it, the token
    out; ``logits`` the step's (B, 1, vocab) logits; the positions
    (``length - offset``), the forward pass, the argmax and the cache
    length's advance all belong to the step. A step has a variant
    (:meth:`variant`): ``"plain"``, or ``"fold"`` for a quantized-cache
    step that folds a chunk, which the cache's host mirror of its length
    names before the step. :meth:`eager` runs a step; :meth:`capture`
    records one variant in a CUDA graph (running nothing) and
    :meth:`replay` replays it. Calling the object does what ``generate``
    needs: on the CPU every call is eager; on a CUDA device the first call
    of each variant is eager (the warm-up that builds its kernels, a real
    step whose token is kept), the next one captures and replays, and
    every later one replays. Every cache configuration is captured, GEAR's
    low-rank bases too (their ``torch.linalg.qr`` captures on the card). A
    failed capture or replay raises: there is no eager fallback. The
    overflow check reads the cache's host mirror before each step, eager
    or replayed.
    """

    def __init__(self, model, state, tok: torch.Tensor,
                 quant_cfg: Optional[QuantKVConfig] = None,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.state = state
        self.quant_cfg = quant_cfg
        self.temps = np.full(tok.shape[0], temperature, np.float32)
        self.generator = generator
        self.tok = tok.detach().clone()
        self.logits = None
        self.graphs = {}               # variant -> (CUDAGraph, its logits)
        self._eager_variants = set()

    def variant(self) -> str:
        """The variant of the next step, from the host mirror."""
        if self.quant_cfg is not None and quant_fold_step(
                self.quant_cfg, self.state.host_length):
            return "fold"
        return "plain"

    def _check_room(self) -> None:
        if self.quant_cfg is None:
            check_dense_room(self.state, 1)
        else:
            check_quant_room(self.state, self.quant_cfg)

    def _step(self) -> torch.Tensor:
        st = self.state
        cache = (DenseDecodeCache(st) if self.quant_cfg is None
                 else QuantizedDecodeCache(st, self.quant_cfg))
        pos = (st.length - st.offset)[:, None]
        logits = self.model(self.tok[:, None], positions=pos, cache=cache)
        cache.finalize()
        self.tok.copy_(sample_logits(logits[:, -1], self.temps,
                                     self.generator))
        return logits

    def eager(self) -> torch.Tensor:
        """Run one step now; returns ``tok``."""
        self._eager_variants.add(self.variant())
        self.logits = self._step()
        return self.tok

    def capture(self, variant: str = "plain") -> None:
        """Record one step of ``variant`` in a CUDA graph on a side stream.
        Nothing runs: the device length stays, and the host mirror is put
        back. A fold step is recorded with the mirror at the next length
        that folds (the graph reads the device length when it replays)."""
        dev = self.tok.device
        host = self.state.host_length
        if variant == "fold":
            self.state.host_length = next_fold_length(self.quant_cfg, host)
        elif variant != self.variant():
            raise ValueError(f"the next step is no {variant!r} step")
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                logits = self._step()
        finally:
            self.state.host_length = host
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs[variant] = (graph, logits)

    def replay(self) -> torch.Tensor:
        """Replay the captured step of the next step's variant; returns
        ``tok``."""
        self._check_room()
        graph, self.logits = self.graphs[self.variant()]
        graph.replay()
        self.state.host_length += 1
        return self.tok

    def __call__(self) -> torch.Tensor:
        v = self.variant()
        if (self.tok.device.type != "cuda" or v not in self._eager_variants
                or (self.temps > 0).any()):
            return self.eager()
        if v not in self.graphs:
            self.capture(v)
        return self.replay()


def pad_prompts(prompts: Sequence[Sequence[int]], pad_token_id: int = 0):
    """Left-pad ragged prompts to a (B, S_max) batch; returns (ids, lens)."""
    lens = np.asarray([len(p) for p in prompts], np.int32)
    S = int(lens.max())
    ids = np.full((len(prompts), S), pad_token_id, np.int64)
    for i, p in enumerate(prompts):
        if len(p):
            ids[i, S - len(p):] = np.asarray(p, np.int64)
    return ids, lens


@torch.inference_mode()
@_holding_device_lock
def generate(model, prompt_ids, max_new_tokens: int,
             cache_kind: str = "dense",
             quant_cfg: Optional[QuantKVConfig] = None,
             eos_token_id: Union[int, Sequence[int], None] = None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             prompt_lens: Optional[np.ndarray] = None,
             pad_token_id: int = 0) -> np.ndarray:
    """Greedy (``temperature`` 0) or sampled decode; returns (B, T <=
    max_new_tokens) token ids. Sampling draws from ``generator`` (default:
    a generator on the model's device seeded 0). Holds
    :data:`DEVICE_LOCK`."""
    if isinstance(prompt_ids, (list, tuple)):
        prompt_ids, prompt_lens = pad_prompts(prompt_ids, pad_token_id)
    prompt_ids = np.asarray(prompt_ids)
    B, S = prompt_ids.shape
    dev = model.device
    offset_np = (np.zeros(B, np.int32) if prompt_lens is None else
                 (S - np.asarray(prompt_lens, np.int32)).astype(np.int32))
    offset = torch.as_tensor(offset_np, device=dev)
    if eos_token_id is None:
        eos_ids = ()
    elif isinstance(eos_token_id, (int, np.integer)):
        eos_ids = (int(eos_token_id),)
    else:
        eos_ids = tuple(int(e) for e in eos_token_id)
    if max_len is None:
        # cache slots round up to the quantization gap, as the JAX default
        gap = (quant_cfg or QuantKVConfig()).gap
        max_len = -(-(S + max_new_tokens) // gap) * gap + gap
    state, wrap = _make_cache(cache_kind, model.cfg, B, max_len, quant_cfg,
                              offset, dev)

    ids = torch.as_tensor(prompt_ids, device=dev)
    # real position of prompt column j in row b is j - offset[b]; pads
    # clip to 0 (their K/V are masked out of every attention row)
    positions = torch.clamp(torch.arange(S, device=dev)[None, :]
                            - offset[:, None], min=0)
    cache = wrap(state)
    logits = model(ids, positions=positions, cache=cache, last_only=True)
    state = cache.finalize()
    temps = np.full(B, temperature, np.float32)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tok = sample_logits(logits[:, -1], temps, generator)

    finished = np.zeros(B, bool)

    def host_tok(t):
        """Freeze finished rows to pad; a row finishing THIS step still
        emits its EOS."""
        t = t.cpu().numpy()
        out_t = np.where(finished, pad_token_id, t)
        for e in eos_ids:
            finished[:] |= (t == e)
        return out_t

    out = [host_tok(tok)]
    step = DecodeStep(model, state, tok,
                      (quant_cfg or QuantKVConfig()) if cache_kind == "quant"
                      else None, temperature, generator)
    for _ in range(max_new_tokens - 1):
        if finished.all():
            break
        out.append(host_tok(step()))
    return np.stack(out, axis=1)
