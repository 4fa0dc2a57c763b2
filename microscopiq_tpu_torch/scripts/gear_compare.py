"""KIVI against GEAR KV caches through the decode path: eight methods.

    python -m microscopiq_tpu_torch.scripts.gear_compare [--device cuda] \
        [--seed 0] [--out FILE]

Counterpart of ``scripts/gear_compare.py`` on the port. One toy Llama (4
layers, hidden 128, 4 heads of head_dim 32, 2 KV heads, intermediate 256,
vocabulary 512) and one structured token stream (B = 4 rows of 96 prompt
and 96 decoded tokens) go through eight KV-cache methods: dense, KIVI 4
and 2 bits, GEAR-L 4 bits at rank 2 and 4, GEAR-S 4 bits (8 outliers a
chunk and head), GEAR-SL (rank 2 and 8 outliers) and GEAR-L 2 bits at rank
4, each with gap 32 and per-token V scales. For each method:

  * the teacher-forced decode perplexity (every next-token log-probability
    from logits computed with that cache in the attention path: a prefill,
    then one ``eval.generate.DecodeStep`` a token fed the true token) and
    its difference from the dense run's;
  * the share of argmax tokens equal to the dense run's;
  * the cache's ``compression_ratio`` at this size and at Llama-3-8B's
    cache dimensions (8 KV heads of 128, gap 64, V group 128);
  * the decode route of its steps (``Attention.decode_route``): ``fused``
    (the quantized-attention kernel) or ``update`` (``cache.update``).

Then the synthetic GSM8K set (``eval.gsm8k.evaluate_gsm8k``, 8 questions in
batches of 4, 16 new tokens, a byte tokenizer) runs through ``generate``
with the KIVI and GEAR-L rank-2 caches: the toy's accuracy is noise, the
run checks the pipeline. The weights are drawn from ``--seed`` with numpy
(every kernel and the embedding N(0, 0.02), norm scales 1, as the JAX
model's initializers draw them), or come from the caller (:func:`run`'s
``tree``). Runs on the card unless ``--device cpu``; prints one JSON line
and writes it to ``--out`` only when given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

CFG = dict(num_hidden_layers=4, hidden_size=128, num_attention_heads=4,
           num_key_value_heads=2, intermediate_size=256, vocab_size=512)
B, S_PROMPT, T = 4, 96, 96
GAP = 32
GSM8K_METHODS = ("KIVI", "GEARL-KIVI-r2")
GSM8K_LIMIT, GSM8K_BATCH, GSM8K_NEW = 8, 4, 16


def model_config():
    from ..models import LlamaConfig

    return LlamaConfig.tiny(**CFG)


def methods(head_dim: int) -> Dict[str, object]:
    """The eight methods' quantized-cache configs (None: the dense cache)."""
    from ..kv.cache import QuantKVConfig

    q = lambda **kw: QuantKVConfig(gap=GAP, v_group=head_dim, **kw)
    return {"dense": None,
            "KIVI": q(bits=4),
            "GEARL-KIVI-r2": q(bits=4, rank=2),
            "GEARL-KIVI-r4": q(bits=4, rank=4),
            "GEARS-KIVI": q(bits=4, out_k=8),
            "GEARSL-KIVI": q(bits=4, rank=2, out_k=8),
            "KIVI-2bit": q(bits=2),
            "GEARL-2bit-r4": q(bits=2, rank=4)}


def token_ids(vocab: int) -> np.ndarray:
    """(B, S_PROMPT + T) int32: 8 random tokens repeated, each moved by 0-2
    (the script's structured stream, from ``default_rng(7)``)."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, vocab, (B, 8))
    ids = np.concatenate([base] * ((S_PROMPT + T) // 8 + 1), axis=1)
    ids = (ids + rng.integers(0, 3, ids.shape)) % vocab
    return ids[:, :S_PROMPT + T].astype(np.int32)


def seeded_tree(cfg, seed: int = 0, device="cuda") -> dict:
    """Float32 weight tree for ``LlamaForCausalLM(cfg)`` drawn with numpy
    from ``seed``: the embedding, the lm_head and every kernel N(0, 0.02),
    norm scales 1 (the JAX model's initializers, other draws)."""
    from .. import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, KVH = cfg.num_attention_heads, cfg.num_key_value_heads

    def normal(*shape):
        return torch.from_numpy((0.02 * rng.standard_normal(shape)
                                 ).astype(np.float32)).to(dev)

    ones = lambda: torch.ones(D, device=dev)
    model = {"embed_tokens": normal(cfg.vocab_size, D)}
    for i in range(cfg.num_hidden_layers):
        model[f"layers_{i}"] = {
            "self_attn": {n: {"kernel": normal(D, w)} for n, w in (
                ("q_proj", H * hd), ("k_proj", KVH * hd),
                ("v_proj", KVH * hd), ("o_proj", D))},
            "mlp": {"gate_proj": {"kernel": normal(D, I)},
                    "up_proj": {"kernel": normal(D, I)},
                    "down_proj": {"kernel": normal(I, D)}},
            "input_layernorm": {"scale": ones()},
            "post_attention_layernorm": {"scale": ones()}}
    model["norm"] = {"scale": ones()}
    return {"params": {"model": model,
                       "lm_head": {"kernel": normal(D, cfg.vocab_size)}}}


def _cache(model, quant_cfg, batch: int, max_len: int):
    from ..eval.generate import _make_cache

    return _make_cache("dense" if quant_cfg is None else "quant", model.cfg,
                       batch, max_len, quant_cfg, None, model.device)


def route(model, quant_cfg) -> str:
    """``dense``, or the route ``Attention.decode_route`` gives this
    method's decode steps: ``fused`` or ``update``."""
    if quant_cfg is None:
        return "dense"
    state, wrap = _cache(model, quant_cfg, 1, 2 * quant_cfg.gap)
    return model.model.layers[0].self_attn.decode_route(wrap(state))


@torch.inference_mode()
def teacher_forced(model, ids: np.ndarray, prompt_len: int, quant_cfg):
    """(mean NLL of ``ids[:, prompt_len:]``, the argmax tokens (B, T)): a
    prefill of the prompt into a fresh cache, then one ``DecodeStep`` a
    token, each fed the true token; every log-probability comes from
    logits computed with the cache in the attention path."""
    from ..eval.generate import DecodeStep

    Bn, L = ids.shape
    dev = model.device
    state, wrap = _cache(model, quant_cfg, Bn, (L // GAP + 2) * GAP)
    cache = wrap(state)
    tok_ids = torch.as_tensor(ids.astype(np.int64), device=dev)
    positions = torch.arange(prompt_len, device=dev)[None, :].expand(Bn, -1)
    logits = model(tok_ids[:, :prompt_len], positions=positions, cache=cache,
                   last_only=True)[:, -1]
    step = DecodeStep(model, cache.finalize(), tok_ids[:, prompt_len],
                      quant_cfg)
    nll, top = [], []
    for t in range(prompt_len, L):
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll.append(-lp.gather(-1, tok_ids[:, t, None])[:, 0])
        top.append(torch.argmax(logits, dim=-1))
        if t < L - 1:
            step.tok.copy_(tok_ids[:, t])
            step()
            logits = step.logits[:, -1].clone()
    return (float(torch.stack(nll).mean(dtype=torch.float32)),
            torch.stack(top, 1).cpu().numpy())


def compression(quant_cfg, cfg, device) -> tuple:
    """(the cache's compression ratio at ``cfg``'s dimensions, at
    Llama-3-8B's: 8 KV heads of 128, gap 64, V group 128); 1.0 for the
    dense cache."""
    from ..kv.cache import QuantizedDecodeCache, init_quant_cache

    if quant_cfg is None:
        return 1.0, 1.0
    st = init_quant_cache(cfg.num_hidden_layers, B, 2 * quant_cfg.gap,
                          cfg.num_key_value_heads, cfg.head_dim, quant_cfg,
                          device=device)
    q8 = dataclasses.replace(quant_cfg, gap=64, v_group=128)
    st8 = init_quant_cache(1, 1, 128, 8, 128, q8, device=device)
    return (float(QuantizedDecodeCache(st, quant_cfg).compression_ratio),
            float(QuantizedDecodeCache(st8, q8).compression_ratio))


def evaluate(model, ids: np.ndarray,
             after: Optional[Callable[[str], None]] = None) -> dict:
    """Each method's row (``decode_ppl``, ``delta_ppl_vs_dense``,
    ``top1_agreement_vs_dense``, ``kv_compression_ratio``,
    ``ratio_at_llama8b_dims``, ``route``), the dense run first; ``after``
    is called with the method's name once its decode is done."""
    out, dense_nll, dense_top = {}, None, None
    for name, qc in methods(model.cfg.head_dim).items():
        nll, top = teacher_forced(model, ids, S_PROMPT, qc)
        if after is not None:
            after(name)
        if name == "dense":
            dense_nll, dense_top = nll, top
        ratio, ratio8b = compression(qc, model.cfg, model.device)
        out[name] = {
            "decode_ppl": float(np.exp(nll)),
            "delta_ppl_vs_dense": float(np.exp(nll) - np.exp(dense_nll)),
            "top1_agreement_vs_dense": float((top == dense_top).mean()),
            "kv_compression_ratio": ratio,
            "ratio_at_llama8b_dims": ratio8b,
            "route": route(model, qc)}
    return out


class ByteTok:
    """Bytes as tokens (clipped to the vocabulary), the last 64 kept."""

    def __init__(self, vocab: int):
        self.top = vocab - 1

    def encode(self, s: str):
        return [min(b, self.top) for b in s.encode()][-64:]

    def decode(self, toks) -> str:
        return bytes(int(t) % 128 for t in toks).decode("ascii", "replace")


def gsm8k(model) -> dict:
    """Synthetic-GSM8K accuracy (and seconds) of ``generate`` over the
    quantized caches of GSM8K_METHODS."""
    from ..eval.generate import generate
    from ..eval.gsm8k import evaluate_gsm8k

    tok = ByteTok(model.cfg.vocab_size)
    all_methods = methods(model.cfg.head_dim)
    out = {}
    for name in GSM8K_METHODS:
        qc = all_methods[name]

        def gen_fn(prompts):
            outs = generate(model, [tok.encode(p) for p in prompts],
                            max_new_tokens=GSM8K_NEW, cache_kind="quant",
                            quant_cfg=qc)
            return [tok.decode(o) for o in outs]

        res = evaluate_gsm8k(gen_fn, limit=GSM8K_LIMIT,
                             batch_size=GSM8K_BATCH)
        out[name] = {"accuracy": res["accuracy"], "n": res["n"],
                     "seconds": res["seconds"]}
    return out


def run(device="cuda", seed: int = 0, tree: Optional[dict] = None,
        after: Optional[Callable[[str], None]] = None) -> dict:
    """The comparison at the script's size on ``device``: weights ``tree``
    (a weight tree of :func:`model_config`'s model) or drawn from
    ``seed``."""
    from ..models import LlamaForCausalLM

    cfg = model_config()
    model = LlamaForCausalLM(cfg, device=device)
    model.load_params(tree if tree is not None
                      else seeded_tree(cfg, seed, model.device))
    t0 = time.perf_counter()
    decode = evaluate(model, token_ids(cfg.vocab_size), after=after)
    t1 = time.perf_counter()
    return {"model": "toy Llama, 4 layers, hidden 128, head_dim 32, "
                     "vocabulary 512",
            "weights": "given" if tree is not None else f"seeded {seed}",
            "device": str(model.device),
            "teacher_forced_decode": decode,
            "gsm8k_synthetic": gsm8k(model),
            "decode_s": t1 - t0, "gsm8k_s": time.perf_counter() - t1}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="file for the JSON result (default: print only)")
    a = p.parse_args(argv)
    res = run(a.device, a.seed)
    line = json.dumps(res)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
