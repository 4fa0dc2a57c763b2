"""Trained VLM accuracy probe for packed weights and quantized KV caches.

Counterpart of ``scripts/vlm_probe.py``: a toy LLaVA is trained end to end
until it has learned a visual retrieval task, then its accuracy is measured
through each cache and weight format under test.

Task: the image is an 8x8 grid of cells, each a solid colour from an
8-colour palette; the prompt is ``[BOS] [IMG x 64] q_i`` and the model must
answer the colour token of cell i. Every answer needs attention to the
right image patch through the cache under test, and the image tokens are
continuous CLIP/projector embeddings (no token-identity shortcut).

Model: CLIP tiny (64 px images, 8 px patches: 64 image tokens) + a linear
projector + a 2-layer, 128-wide Llama (8 heads, 2 KV heads, head_dim 16).
At head_dim 16 every quantized arm decodes through ``cache.update`` (the
fused attention kernel takes head_dim >= 32, ``quant_attention.
decode_route``), and the weights are dense (the fp6 arm fake-quantizes
them), so the probe launches no kernel of the port's own.

Training: Adam (b1 0.9, b2 0.999, eps 1e-8) under a linear warm-up from 0
to 2e-3 over 150 updates, then constant (``eval.retrieval.optimizer`` and
``warmup_constant``, optax's arithmetic), batch 64 of 8 queries, cross-
entropy at the query positions; the batches come from
``numpy.random.default_rng(0)`` as in the JAX script, the weights from a
CPU ``torch.Generator`` seeded 0 with flax's initializers (lecun-normal
vision and projector kernels, N(0, 0.02) text kernels and embeddings),
so a run on the card and one on the CPU start from the same numbers.

Arms: dense; MX-FP6 fake-quantized text-tower linears (``nn.
quantize_params``, the embedding skipped); KIVI-4bit, KIVI-2bit and GEAR-L
2bit rank 4 KV (gap 8: 56 of the 64 image tokens lie in quantized chunks
at decode); fp6 weights with KIVI-4bit. Five ordering checks, as in JAX.

    python -m microscopiq_tpu_torch.scripts.vlm_probe [--steps N]
        [--device cuda|cpu] [--out FILE]

prints one JSON line (and writes it to ``--out``); exits 1 when the dense
model has not learned the task.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

GRID = 8                      # cells per side
NCELL = GRID * GRID           # 64 image tokens, one per cell
NCOLOR = 8

PALETTE = np.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
     [1, 0, 1], [0, 1, 1], [1, 1, 1], [-1, -1, -1]], np.float32)

VOCAB = 2 + NCELL + NCOLOR           # BOS, PAD, queries, colors
BOS, Q0, C0 = 0, 2, 2 + NCELL
TASK_VOCAB = (BOS, Q0, C0)
NQ = 8                               # queries a training sequence
STEPS = 1200
LR, WARMUP, BATCH = 2e-3, 150, 64
KV_GAP = 8


def sample_images(rng, B):
    """(B, 64, 64, 3) channel-last images + (B, NCELL) cell color ids."""
    cells = rng.integers(0, NCOLOR, (B, GRID, GRID))
    img = PALETTE[cells]                       # (B, G, G, 3)
    img = np.repeat(np.repeat(img, 8, axis=1), 8, axis=2)
    return img.astype(np.float32), cells.reshape(B, -1)


def build_batch(rng, task_vocab, B, n_queries):
    """ids (B, 1+NCELL+2Q), img mask, pixel values, query cells, answers."""
    BOS_, Q0_, C0_ = task_vocab
    pix, cells = sample_images(rng, B)
    q = np.argsort(rng.random((B, NCELL)), axis=1)[:, :n_queries]
    ans = np.take_along_axis(cells, q, axis=1)          # color ids
    S = 1 + NCELL + 2 * n_queries
    ids = np.zeros((B, S), np.int32)
    ids[:, 0] = BOS_
    mask = np.zeros((B, S), bool)
    mask[:, 1:1 + NCELL] = True
    ids[:, 1 + NCELL::2] = Q0_ + q
    ids[:, 2 + NCELL::2] = C0_ + ans
    return ids, mask, pix, q, ans


def probe_config():
    """The probe's LLaVA configuration (float32)."""
    from ..models.llama import LlamaConfig
    from ..vlm.clip import CLIPVisionConfig
    from ..vlm.llava import LlavaConfig

    text = LlamaConfig.tiny(num_hidden_layers=2, hidden_size=128,
                            num_attention_heads=8, num_key_value_heads=2,
                            intermediate_size=256, vocab_size=VOCAB,
                            max_position_embeddings=256)
    vis = CLIPVisionConfig.tiny(image_size=64, patch_size=8,
                                hidden_size=64, intermediate_size=128)
    cfg = LlavaConfig(text=text, vision=vis, projector_type="linear",
                      vision_select_feature="patch")
    assert cfg.num_image_tokens == NCELL
    return cfg


def probe_model(device="cuda"):
    """(config, LlavaForCausalLM without weights); the plain versions, as
    the JAX script runs ``use_pallas=False``."""
    from ..vlm.llava import LlavaForCausalLM

    cfg = probe_config()
    return cfg, LlavaForCausalLM(cfg, use_kernels=False, device=device)


def init_probe_params(cfg, seed: int = 0, device="cuda"):
    """Float32 weights with flax's initializers, drawn on the CPU from
    ``seed`` and moved to ``device``."""
    from ..nn.linear import lecun_normal

    gen = torch.Generator().manual_seed(seed)
    tc, vis = cfg.text, cfg.vision
    D, I, H, KVH, hd = (tc.hidden_size, tc.intermediate_size,
                        tc.num_attention_heads, tc.num_key_value_heads,
                        tc.head_dim)
    Dv, Iv, p = vis.hidden_size, vis.intermediate_size, vis.patch_size

    def normal(*shape):
        return torch.randn(shape, generator=gen) * 0.02

    def dense(k, n):
        return {"kernel": lecun_normal((k, n), k, "cpu", gen),
                "bias": torch.zeros(n)}

    def ln(n):
        return {"scale": torch.ones(n), "bias": torch.zeros(n)}

    vm = {"patch_embedding": {"kernel": lecun_normal((p, p, 3, Dv),
                                                     p * p * 3, "cpu", gen)},
          "class_embedding": normal(Dv),
          "position_embedding": normal(vis.num_positions, Dv),
          "pre_layrnorm": ln(Dv)}
    for i in range(vis.num_hidden_layers):
        vm[f"layers_{i}"] = {
            "layer_norm1": ln(Dv),
            "self_attn": {n: dense(Dv, Dv) for n in ("q_proj", "k_proj",
                                                     "v_proj", "out_proj")},
            "layer_norm2": ln(Dv),
            "mlp": {"fc1": dense(Dv, Iv), "fc2": dense(Iv, Dv)}}
    lin = lambda k, n: {"kernel": normal(k, n)}  # noqa: E731
    model = {"embed_tokens": normal(tc.vocab_size, D)}
    for i in range(tc.num_hidden_layers):
        model[f"layers_{i}"] = {
            "input_layernorm": {"scale": torch.ones(D)},
            "self_attn": {"q_proj": lin(D, H * hd), "k_proj": lin(D, KVH * hd),
                          "v_proj": lin(D, KVH * hd),
                          "o_proj": lin(H * hd, D)},
            "post_attention_layernorm": {"scale": torch.ones(D)},
            "mlp": {"gate_proj": lin(D, I), "up_proj": lin(D, I),
                    "down_proj": lin(I, D)}}
    model["norm"] = {"scale": torch.ones(D)}
    tree = {"vision_tower": {"vision_model": vm},
            "mm_projector": {"layers_0": dense(Dv, D)},
            "model": model, "lm_head": lin(D, tc.vocab_size)}
    return {"params": _map(tree, lambda t: t.to(device))}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def train(model, steps: int = STEPS, seed: int = 0, log=print):
    """Train the probe; returns the trained tree (left installed) and the
    last step's loss and accuracy."""
    from ..eval.retrieval import optimizer, warmup_constant

    dev = model.device
    tree = _map(init_probe_params(model.cfg, seed, dev)["params"],
                lambda t: t.requires_grad_(True))
    model.load_params(tree)
    opt, rate = optimizer(list(_leaves(tree)), warmup_constant(LR, WARMUP))
    rng = np.random.default_rng(0)
    build_batch(rng, TASK_VOCAB, 1, NQ)      # the JAX script's init batch
    qpos = torch.arange(1 + NCELL, 1 + NCELL + 2 * NQ, 2, device=dev)
    loss = acc = float("nan")
    for s in range(steps):
        ids, mask, pix, _, ans = build_batch(rng, TASK_VOCAB, BATCH, NQ)
        opt.zero_grad(set_to_none=True)
        logits = model(torch.as_tensor(ids, device=dev).long(),
                       pixel_values=torch.as_tensor(pix, device=dev),
                       image_token_mask=torch.as_tensor(mask, device=dev))
        sel = logits[:, qpos].to(torch.float32)              # (B, Q, V)
        tgt = C0 + torch.as_tensor(ans, device=dev).long()
        lp = F.log_softmax(sel, dim=-1)
        loss_t = -torch.gather(lp, -1, tgt[..., None]).mean()
        loss_t.backward()
        opt.step()
        rate.step()
        if s % 100 == 0 or s == steps - 1:
            loss = float(loss_t.detach())
            acc = float((sel.argmax(-1) == tgt).float().mean())
            log(f"step {s}: loss {loss:.4f} acc {acc:.3f}")
    out = _map(tree, lambda t: t.detach())
    model.load_params(out)
    return {"params": out}, loss, acc


@torch.no_grad()
def probe_accuracy(model, *, kind: str = "dense", quant_cfg=None,
                   B: int = 64, n_batches: int = 4, seed: int = 99) -> float:
    """Prefill ``[BOS][IMG x 64]`` through a fresh cache of ``kind``, then
    one decode step on the query; the share of colour tokens right."""
    from ..eval.generate import _make_cache

    dev = model.device
    S_ctx = 1 + NCELL
    gap = quant_cfg.gap if quant_cfg is not None else 16
    max_len = ((S_ctx + 2 + gap) // gap + 1) * gap
    r = np.random.default_rng(seed)
    hits = total = 0
    for _ in range(n_batches):
        ids, mask, pix, _, ans = build_batch(r, TASK_VOCAB, B, 1)
        ids = torch.as_tensor(ids, device=dev).long()
        state, wrap = _make_cache(kind, model.cfg.text, B, max_len,
                                  quant_cfg, None, dev)
        cache = wrap(state)
        pos = torch.arange(S_ctx, device=dev)[None].expand(B, S_ctx)
        model(ids[:, :S_ctx], positions=pos, cache=cache,
              pixel_values=torch.as_tensor(pix, device=dev),
              image_token_mask=torch.as_tensor(mask[:, :S_ctx], device=dev))
        cache = wrap(cache.finalize())
        pos = torch.full((B, 1), S_ctx, dtype=torch.int32, device=dev)
        logits = model(ids[:, S_ctx:S_ctx + 1], positions=pos, cache=cache)
        pred = torch.argmax(logits[:, -1], -1).cpu().numpy()
        hits += int((pred == C0 + ans[:, 0]).sum())
        total += B
    return hits / total


def run(device="cuda", steps: int = STEPS, log=print) -> dict:
    """Train, measure the six arms, and return the JSON record."""
    from .. import resolve_device
    from ..kv.cache import QuantKVConfig
    from ..nn import quantize_params
    from ..specs import finalize_mx_specs
    from ..vlm.llava import LlavaForCausalLM

    dev = resolve_device(device)
    cfg, model = probe_model(dev)
    t0 = time.perf_counter()
    tree, loss, acc = train(model, steps, log=log)
    train_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    dense_acc = probe_accuracy(model, kind="dense")

    specs6 = finalize_mx_specs({"w_elem_format": "fp6_e3m2",
                                "scale_bits": 8, "block_size": 32,
                                "bfloat": 16})
    p6 = dict(tree["params"])
    p6["model"] = quantize_params(tree["params"]["model"], specs6,
                                  skip=("embed_tokens",))
    model6 = LlavaForCausalLM(cfg, use_kernels=False,
                              device=dev).load_params(p6)
    fp6_acc = probe_accuracy(model6, kind="dense")

    hd = cfg.text.head_dim
    arms = {
        "KIVI-4bit": QuantKVConfig(bits=4, gap=KV_GAP, v_group=hd),
        "KIVI-2bit": QuantKVConfig(bits=2, gap=KV_GAP, v_group=hd),
        "GEARL-2bit-r4": QuantKVConfig(bits=2, gap=KV_GAP, v_group=hd,
                                       rank=4),
    }
    results = {"dense": {"accuracy": round(dense_acc, 4)},
               "packed_fp6_weights": {
                   "accuracy": round(fp6_acc, 4),
                   "delta_vs_dense": round(fp6_acc - dense_acc, 4)}}
    for name, qc in arms.items():
        a = probe_accuracy(model, kind="quant", quant_cfg=qc)
        results[name] = {"accuracy": round(a, 4),
                         "delta_vs_dense": round(a - dense_acc, 4)}
    a = probe_accuracy(model6, kind="quant", quant_cfg=arms["KIVI-4bit"])
    results["packed_fp6+KIVI-4bit"] = {
        "accuracy": round(a, 4), "delta_vs_dense": round(a - dense_acc, 4)}
    checks = {
        "dense_learned": dense_acc >= 0.9,
        "fp6_weights_lossless": abs(fp6_acc - dense_acc) <= 0.02,
        "4bit_beats_2bit": (results["KIVI-4bit"]["accuracy"]
                            > results["KIVI-2bit"]["accuracy"]),
        "gear_corrects_2bit": (results["GEARL-2bit-r4"]["accuracy"]
                               > results["KIVI-2bit"]["accuracy"]),
        "separation": dense_acc - results["KIVI-2bit"]["accuracy"] > 0.05,
    }
    return {
        "task": ("8x8 color-grid visual retrieval: answer the color of "
                 "cell i; every answer requires attending to the right "
                 "image patch through the cache under test "
                 f"(56/64 image tokens sit in quantized chunks at "
                 f"gap={KV_GAP})"),
        "model": ("toy LLaVA: CLIP tiny (64px/8px patches, 64 image "
                  "tokens) + linear projector + 2L-128d text tower, "
                  "head_dim=16, trained end-to-end from scratch"),
        "backend": f"torch {torch.__version__} {dev.type}",
        "train_steps": steps, "final_loss": loss, "final_train_acc": acc,
        "train_s": train_s, "eval_s": time.perf_counter() - t1,
        "results": results, "ordering_checks": checks,
        "all_checks_pass": all(checks.values()),
    }


def main(argv=None, device=None, steps=None) -> dict:
    """CLI: train, measure, print the record as one JSON line (to stdout;
    the training log goes to stderr) and return it. ``device`` and
    ``steps`` override the flags."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args([] if argv is None else argv)
    rec = run(device or args.device,
              args.steps if steps is None else steps,
              log=lambda s: print(s, file=sys.stderr, flush=True))
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return rec


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ordering_checks"]["dense_learned"]
             else 1)
