"""Synthetic key-value retrieval and copy accuracy probes for KV caches.

Counterpart of ``microscopiq_tpu/eval/retrieval.py``. A small Llama learns
a task whose answers sit deep in the prompt; its accuracy with a quantized
or evicting cache in the decode path, against the dense cache, then shows
what the cache loses (KIVI against GEAR at 2 and 4 bits, H2O budgets).

- Retrieval: ``[BOS] k1 v1 ... kP vP [SEP] kq`` -> ``vq``.
- Copy (induction): ``[BOS] x1 ... xn [SEP] x1 ... xn``, teacher-forced.

The tasks and their samplers are numpy, bit-equal to the JAX package's for
the same ``rng``. Training is a torch loop on the port's
:class:`~microscopiq_tpu_torch.models.llama.LlamaForCausalLM` (a
full-attention forward, cross-entropy at the same positions) with the
optimizers and schedules of the JAX loops: ``train_retrieval`` AdamW
(weight decay 1e-4) under optax's ``cosine_decay_schedule(lr, steps,
alpha=0.05)``, ``train_copy`` Adam under a linear warm-up from 0 over 150
updates (the first update's rate is 0), then ``lr``; both with eps 1e-8
outside the square root, the rate of update t (from 0) set by a
``LambdaLR`` that computes optax's value at count t. The weights start
float32, N(0, 0.02) for kernels and the embedding and ones for the norms
(JAX's initializers; its random draws cannot be reproduced, so a caller
that needs JAX's start passes ``init_params``).

The accuracy probes run the prompt through the cache under test (token by
token for "h2o", so that eviction engages) and every answer as one decode
step in a host loop (JAX's ``lax.scan``): the caches of
``eval/generate.py::_make_cache`` for "dense" and "quant", fed to
``DecodeStep`` (on the card its steps replay CUDA graphs, as ``generate``'s
do), ``kv/h2o.py``'s ``H2OCache`` for "h2o" (eager steps). A decode step
over the quantized cache takes the fused attention kernel or
``cache.update`` as the model's gate decides.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class RetrievalTask:
    """Vocabulary layout and size of the retrieval problem."""

    n_keys: int = 64
    n_vals: int = 64
    n_pairs: int = 32

    BOS: int = 0
    SEP: int = 1

    @property
    def key0(self) -> int:
        return 2

    @property
    def val0(self) -> int:
        return 2 + self.n_keys

    @property
    def vocab_size(self) -> int:
        return 2 + self.n_keys + self.n_vals

    @property
    def prompt_len(self) -> int:
        """BOS + 2*pairs + SEP + query key."""
        return 2 * self.n_pairs + 3


def sample_batch(rng: np.random.Generator, task: RetrievalTask, B: int,
                 n_queries: int = 1):
    """Sample a batch of retrieval sequences.

    Returns (ids (B, 2P+2+2Q) int32, ans_pos (Q,) int32, answers
    (B, Q) int32): ids holds ``BOS k1 v1 ... kP vP SEP kq1 a1 ... kqQ aQ``
    with the Q queried pairs distinct; ans_pos are the positions of the
    query keys (the model predicts the answer from the logits there)."""
    P, Q = task.n_pairs, n_queries
    keys = np.argsort(rng.random((B, task.n_keys)), axis=1)[:, :P]
    vals = rng.integers(0, task.n_vals, (B, P))
    q = np.argsort(rng.random((B, P)), axis=1)[:, :Q]     # distinct pairs
    ids = np.empty((B, 2 * P + 2 + 2 * Q), np.int32)
    ids[:, 0] = task.BOS
    ids[:, 1:2 * P + 1:2] = task.key0 + keys
    ids[:, 2:2 * P + 1:2] = task.val0 + vals
    ids[:, 2 * P + 1] = task.SEP
    rows = np.arange(B)[:, None]
    answers = (task.val0 + vals[rows, q]).astype(np.int32)   # (B, Q)
    ids[:, 2 * P + 2::2] = task.key0 + keys[rows, q]
    ids[:, 2 * P + 3::2] = answers
    ans_pos = np.arange(2 * P + 2, 2 * P + 2 + 2 * Q, 2, dtype=np.int32)
    return ids, ans_pos, answers


@dataclasses.dataclass(frozen=True)
class CopyTask:
    """``[BOS] x1 ... xn [SEP] x1 ... xn``: teacher-forced copy."""

    vocab_extra: int = 62     # usable tokens beyond BOS/SEP
    n: int = 96

    BOS: int = 0
    SEP: int = 1

    @property
    def vocab_size(self) -> int:
        return 2 + self.vocab_extra

    @property
    def prompt_len(self) -> int:
        return self.n + 2


def sample_copy(rng: np.random.Generator, task: CopyTask, B: int):
    x = rng.integers(2, task.vocab_size, (B, task.n))
    return np.concatenate(
        [np.full((B, 1), task.BOS), x, np.full((B, 1), task.SEP), x],
        axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def init_train_params(cfg, seed: int = 0, device="cuda"):
    """Float32 weight tree for training (unfused projections): kernels and
    the embedding N(0, 0.02), norms ones; drawn on the CPU from ``seed``,
    so every device starts from the same numbers."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def normal(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    def lin(k, n):
        return {"kernel": normal(k, n)}

    model = {"embed_tokens": normal(cfg.vocab_size, D)}
    for i in range(cfg.num_hidden_layers):
        model[f"layers_{i}"] = {
            "self_attn": {"q_proj": lin(D, H * hd), "k_proj": lin(D, KVH * hd),
                          "v_proj": lin(D, KVH * hd),
                          "o_proj": lin(H * hd, D)},
            "mlp": {"gate_proj": lin(D, I), "up_proj": lin(D, I),
                    "down_proj": lin(I, D)},
            "input_layernorm": {"scale": torch.ones(D)},
            "post_attention_layernorm": {"scale": torch.ones(D)}}
    model["norm"] = {"scale": torch.ones(D)}
    tree = {"model": model, "lm_head": lin(D, cfg.vocab_size)}
    return {"params": _map_tree(tree, lambda t: t.to(dev))}


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def cosine_decay(lr: float, steps: int, alpha: float):
    """optax.cosine_decay_schedule(lr, steps, alpha) at count t."""
    def f(t):
        c = min(t, steps) / steps
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c)) + alpha)
    return f


def warmup_constant(lr: float, warmup: int):
    """optax.join_schedules([linear_schedule(0, lr, warmup),
    constant_schedule(lr)], [warmup]) at count t: 0 at t = 0."""
    return lambda t: lr * min(t, warmup) / warmup if t < warmup else lr


def optimizer(weights, sched, weight_decay: float = 0.0):
    """(optimizer, LambdaLR) of the JAX loops: optax's ``adam`` (or
    ``adamw`` with ``weight_decay``) under the schedule ``sched``: b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, update t (from 0) at the
    rate ``sched(t)``; step the optimizer, then the LambdaLR."""
    opt_cls = torch.optim.AdamW if weight_decay else torch.optim.Adam
    opt = opt_cls(weights, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                  weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)


def _train(model, steps, seed, init_params, sched, weight_decay, batch_fn,
           loss_fn, log_every):
    """The shared loop: weights from ``init_params`` (in their dtype) or
    :func:`init_train_params` (float32), with ``requires_grad``, installed
    into ``model``; one Adam(W) update a batch at the rate ``sched(t)``.
    Returns the trained tree (detached), also left installed."""
    dev = model.device
    tree = init_params if init_params is not None else init_train_params(
        model.cfg, seed, dev)
    tree = _map_tree(tree.get("params", tree), lambda t: t.detach().to(
        dev).clone().requires_grad_(True))
    model.load_params(tree)
    opt, rate = optimizer(list(_leaves(tree)), sched, weight_decay)
    rng = np.random.default_rng(seed)
    for step in range(steps):
        batch = batch_fn(rng)
        opt.zero_grad(set_to_none=True)
        loss, acc = loss_fn(batch)
        loss.backward()
        opt.step()
        rate.step()
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step}: loss {float(loss.detach()):.4f} "
                  f"acc {float(acc):.3f}", flush=True)
    out = _map_tree(tree, lambda t: t.detach())
    model.load_params(out)
    return {"params": out}


def train_retrieval(model, task: RetrievalTask, steps: int = 1500,
                    B: int = 128, lr: float = 2e-3, seed: int = 0,
                    n_queries: int = 8, log_every: int = 0,
                    init_params=None):
    """Train ``model`` on the retrieval task: a full-attention forward,
    cross-entropy at every query-key position (``n_queries`` a sequence),
    AdamW under a cosine decay. Returns the trained tree; deterministic
    given the seed on one device."""
    dev = model.device

    def batch_fn(rng):
        ids, ans_pos, answers = sample_batch(rng, task, B, n_queries)
        return (torch.as_tensor(ids, device=dev).long(),
                torch.as_tensor(ans_pos, device=dev).long(),
                torch.as_tensor(answers, device=dev).long())

    def loss_fn(batch):
        ids, ans_pos, answers = batch
        sel = model(ids).to(torch.float32)[:, ans_pos]       # (B, Q, V)
        lp = F.log_softmax(sel, dim=-1)
        loss = -torch.gather(lp, -1, answers[..., None]).mean()
        return loss, (sel.argmax(-1) == answers).float().mean()

    return _train(model, steps, seed, init_params,
                  cosine_decay(lr, steps, 0.05), 1e-4, batch_fn, loss_fn,
                  log_every)


def train_copy(model, task: CopyTask, steps: int = 400, B: int = 64,
               lr: float = 3e-3, seed: int = 0, log_every: int = 0,
               init_params=None):
    """Cross-entropy over every copy position; Adam at a constant rate
    after a warm-up of 150 updates (a cosine decay decays before the
    induction circuit forms). Returns the trained tree."""
    n = task.n
    dev = model.device

    def batch_fn(rng):
        return torch.as_tensor(sample_copy(rng, task, B), device=dev).long()

    def loss_fn(ids):
        sel = model(ids).to(torch.float32)[:, n + 1:2 * n + 1]
        tgt = ids[:, n + 2:2 * n + 2]
        lp = F.log_softmax(sel, dim=-1)
        loss = -torch.gather(lp, -1, tgt[..., None]).mean()
        return loss, (sel.argmax(-1) == tgt).float().mean()

    return _train(model, steps, seed, init_params, warmup_constant(lr, 150),
                  0.0, batch_fn, loss_fn, log_every)


# ---------------------------------------------------------------------------
# Accuracy through a cache
# ---------------------------------------------------------------------------
def _cache(model, kind, B, max_len, quant_cfg, h2o_budget, recent_window):
    """(state, wrap) of a fresh cache of ``kind`` for ``B`` rows."""
    from ..kv.h2o import H2OCache, init_h2o_cache
    from .generate import _make_cache

    cfg = model.cfg
    if kind == "h2o":
        state = init_h2o_cache(cfg.num_hidden_layers, B, int(h2o_budget),
                               cfg.num_key_value_heads, cfg.head_dim,
                               device=model.device)
        return state, functools.partial(H2OCache,
                                        recent_window=recent_window)
    return _make_cache(kind, cfg, B, max_len, quant_cfg, None, model.device)


def _feed(model, ids, state, wrap, t0: int, t1: int, token_by_token: bool,
          quant_cfg=None):
    """Run ids[:, t0:t1] through the cache (one call, or one decode step a
    token); returns (state, argmax of each step's logits or None). Decode
    steps over the dense or quantized cache (``wrap`` None) go through
    ``eval/generate.py::DecodeStep`` fed the true tokens, so that on the
    card they replay CUDA graphs as ``generate`` does; H2O steps (a
    ``wrap``) run eagerly."""
    B = ids.shape[0]
    dev = model.device
    if not token_by_token:
        cache = wrap(state)
        pos = torch.arange(t0, t1, device=dev)[None].expand(B, t1 - t0)
        model(ids[:, t0:t1], positions=pos, cache=cache)
        return cache.finalize(), None
    preds = []
    if wrap is None:
        from .generate import DecodeStep

        step = DecodeStep(model, state, ids[:, t0], quant_cfg)
        for t in range(t0, t1):
            step.tok.copy_(ids[:, t])
            preds.append(step().clone())
        return step.state, torch.stack(preds, dim=1)
    for t in range(t0, t1):
        cache = wrap(state)
        logits = model(ids[:, t:t + 1], positions=torch.full(
            (B, 1), t, device=dev), cache=cache)
        state = cache.finalize()
        preds.append(torch.argmax(logits[:, -1], dim=-1))
    return state, torch.stack(preds, dim=1)


@torch.inference_mode()
def retrieval_predictions(model, task: RetrievalTask, ids: np.ndarray, *,
                          kind: str = "dense", quant_cfg=None,
                          h2o_budget=None, recent_window: int = 8):
    """(B,) predicted values of retrieval prompts ``ids`` (B, prompt_len):
    the context through the cache under test, the query key as one decode
    step."""
    B = ids.shape[0]
    S_ctx = task.prompt_len - 1
    gap = quant_cfg.gap if quant_cfg is not None else 16
    max_len = ((task.prompt_len + gap) // gap + 1) * gap
    state, wrap = _cache(model, kind, B, max_len, quant_cfg, h2o_budget,
                         recent_window)
    t = torch.as_tensor(ids, device=model.device).long()
    state, _ = _feed(model, t, state, wrap, 0, S_ctx, kind == "h2o")
    _, pred = _feed(model, t, state, wrap if kind == "h2o" else None,
                    S_ctx, S_ctx + 1, True, quant_cfg)
    return pred[:, 0].cpu().numpy()


def retrieval_accuracy(model, task: RetrievalTask, *,
                       kind: str = "dense", quant_cfg=None,
                       h2o_budget: int | None = None,
                       recent_window: int = 8,
                       B: int = 64, n_batches: int = 4,
                       seed: int = 1234) -> float:
    """Retrieval accuracy with the given cache in the decode path.

    kind: "dense" | "quant" (with quant_cfg) | "h2o" (with h2o_budget)."""
    rng = np.random.default_rng(seed)
    hits, total = 0, 0
    for _ in range(n_batches):
        ids, _, answers = sample_batch(rng, task, B, n_queries=1)
        pred = retrieval_predictions(
            model, task, ids[:, :task.prompt_len], kind=kind,
            quant_cfg=quant_cfg, h2o_budget=h2o_budget,
            recent_window=recent_window)
        hits += int((pred == answers[:, 0]).sum())
        total += B
    return hits / total


@torch.inference_mode()
def copy_predictions(model, task: CopyTask, ids: np.ndarray, *,
                     kind: str = "dense", quant_cfg=None, h2o_budget=None,
                     recent_window: int = 8) -> np.ndarray:
    """(B, n) teacher-forced predictions of copy sequences ``ids``: the
    prompt ``BOS x1..xn`` through the cache under test, then SEP, x1, ...,
    x(n-1) as decode steps, each predicting the next copy token."""
    n = task.n
    B = ids.shape[0]
    S_ctx = n + 1          # SEP is the first decode step
    gap = quant_cfg.gap if quant_cfg is not None else 16
    max_len = ((2 * n + 2 + gap) // gap + 1) * gap
    state, wrap = _cache(model, kind, B, max_len, quant_cfg, h2o_budget,
                         recent_window)
    t = torch.as_tensor(ids, device=model.device).long()
    state, _ = _feed(model, t, state, wrap, 0, S_ctx, kind == "h2o")
    _, preds = _feed(model, t, state, wrap if kind == "h2o" else None,
                     n + 1, 2 * n + 1, True, quant_cfg)
    return preds.cpu().numpy()


def copy_accuracy(model, task: CopyTask, *,
                  kind: str = "dense", quant_cfg=None,
                  h2o_budget: int | None = None,
                  recent_window: int = 8,
                  B: int = 64, n_batches: int = 2,
                  seed: int = 1234) -> float:
    """Teacher-forced copy accuracy with the given cache in the decode
    path: per-position argmax accuracy, averaged."""
    n = task.n
    rng = np.random.default_rng(seed)
    hits, total = 0, 0
    for _ in range(n_batches):
        ids = sample_copy(rng, task, B)
        pred = copy_predictions(model, task, ids, kind=kind,
                                quant_cfg=quant_cfg, h2o_budget=h2o_budget,
                                recent_window=recent_window)
        tgt = ids[:, n + 2:2 * n + 2]
        hits += int((pred == tgt).sum())
        total += tgt.size
    return hits / total
