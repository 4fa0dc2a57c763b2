"""KV-cache method accuracy on a trained induction-copy task.

Counterpart of ``scripts/kv_accuracy.py`` on the port: train a toy Llama
(2 layers, hidden 128, 8 heads of head_dim 16, a 2048-token alphabet) to
copy 192 tokens with a dense cache, then measure the teacher-forced copy
accuracy with each KV-cache method in the decode path: every copied
token's decode step must attend to content deep in the quantized or
evicted prompt cache, so accuracy falls with the cache's fidelity. Ten
arms (dense; KIVI 4 and 2 bits; GEAR-L 4 and 2 bits, rank 4; GEAR-S 2
bits, 8 outliers; GEAR-SL 2 bits; H2O at the full prompt, 75% and 50%)
and the five ordering checks of the JAX script.

    python -m microscopiq_tpu_torch.scripts.kv_accuracy --out FILE
        [--steps 400] [--n 192] [--device cuda] [--retrain] [--train-only]

The JSON result goes only to ``--out``. The trained weights are cached in
the temporary directory (``tempfile.gettempdir()``), keyed by the
geometry, the steps and the device type.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import torch


def model_and_task(n: int = 192, device="cuda"):
    """(model without weights, CopyTask) at the script's size."""
    from ..eval.retrieval import CopyTask
    from ..models import LlamaConfig, LlamaForCausalLM

    task = CopyTask(vocab_extra=2046, n=n)
    cfg = LlamaConfig.tiny(num_hidden_layers=2, hidden_size=128,
                           num_attention_heads=8, num_key_value_heads=2,
                           intermediate_size=256,
                           vocab_size=task.vocab_size,
                           max_position_embeddings=2 * n + 4)
    return LlamaForCausalLM(cfg, device=device), task


def trained(steps: int = 400, n: int = 192, device="cuda",
            retrain: bool = False, log_every: int = 50):
    """(model with trained weights, task, training seconds or None when the
    weights came from the cache, the weight tree)."""
    from ..eval.retrieval import train_copy

    model, task = model_and_task(n, device)
    dev = model.device
    ckpt = (pathlib.Path(tempfile.gettempdir())
            / f"copy_params_torch_h{model.cfg.num_attention_heads}_{n}_"
              f"{steps}_{dev.type}.pt")
    if ckpt.exists() and not retrain:
        tree = torch.load(ckpt, map_location=dev, weights_only=True)
        model.load_params(tree)
        print(f"loaded trained params from {ckpt}", flush=True)
        return model, task, None, tree
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = train_copy(model, task, steps=steps, log_every=log_every)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"trained {steps} steps in {seconds:.1f}s", flush=True)
    torch.save(tree, ckpt)
    return model, task, seconds, tree


def quant_arms(head_dim: int, gap: int = 16) -> dict:
    from ..kv.cache import QuantKVConfig

    hd = head_dim
    return {
        "KIVI-4bit": QuantKVConfig(bits=4, gap=gap, v_group=hd),
        "GEARL-4bit-r4": QuantKVConfig(bits=4, gap=gap, v_group=hd, rank=4),
        "KIVI-2bit": QuantKVConfig(bits=2, gap=gap, v_group=hd),
        "GEARL-2bit-r4": QuantKVConfig(bits=2, gap=gap, v_group=hd, rank=4),
        "GEARS-2bit-k8": QuantKVConfig(bits=2, gap=gap, v_group=hd,
                                       out_k=8),
        "GEARSL-2bit": QuantKVConfig(bits=2, gap=gap, v_group=hd, rank=4,
                                     out_k=8),
    }


def h2o_arms(task) -> dict:
    """Budgets as fractions of the prompt."""
    S_ctx = task.n + 1
    return {"H2O-full": S_ctx + 8, "H2O-75pct": int(S_ctx * 0.75),
            "H2O-50pct": int(S_ctx * 0.50)}


def arm_kwargs(name: str, model, task) -> dict:
    """copy_accuracy / copy_predictions keywords of one arm."""
    if name == "dense":
        return {"kind": "dense"}
    q = quant_arms(model.cfg.head_dim)
    if name in q:
        return {"kind": "quant", "quant_cfg": q[name]}
    return {"kind": "h2o", "h2o_budget": h2o_arms(task)[name]}


def evaluate(model, task) -> dict:
    """Accuracy of every arm, as the JAX script records it."""
    from ..eval.retrieval import copy_accuracy

    dense_acc = copy_accuracy(model, task, kind="dense")
    results = {"dense": {"accuracy": round(dense_acc, 4)}}
    S_ctx = task.n + 1
    names = list(quant_arms(model.cfg.head_dim)) + list(h2o_arms(task))
    for name in names:
        kw = arm_kwargs(name, model, task)
        acc = copy_accuracy(model, task, **kw)
        results[name] = {"accuracy": round(acc, 4),
                         "delta_vs_dense": round(acc - dense_acc, 4)}
        if kw["kind"] == "h2o":
            results[name].update(budget_tokens=kw["h2o_budget"],
                                 prompt_tokens=S_ctx)
        print(json.dumps({"arm": name, **results[name]}), flush=True)
    return results


def ordering_checks(results: dict) -> dict:
    """The orderings the reference's GSM8K grid shows."""
    acc = {k: v["accuracy"] for k, v in results.items()}
    return {
        "dense_learned": acc["dense"] >= 0.95,
        "4bit_beats_2bit": acc["KIVI-4bit"] > acc["KIVI-2bit"],
        "gear_corrects_2bit": (acc["GEARL-2bit-r4"] > acc["KIVI-2bit"]
                               or acc["GEARSL-2bit"] > acc["KIVI-2bit"]),
        "h2o_budget_monotone": acc["H2O-full"] >= acc["H2O-50pct"],
        "separation": (acc["dense"] - acc["KIVI-2bit"]) > 0.05,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the JSON result here")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--retrain", action="store_true")
    ap.add_argument("--train-only", action="store_true")
    args = ap.parse_args(argv)
    if not (args.out or args.train_only):
        ap.error("--out is required unless --train-only")

    from ..eval.retrieval import copy_accuracy

    model, task, seconds, _ = trained(args.steps, args.n, args.device,
                                      args.retrain)
    if args.train_only:
        acc = copy_accuracy(model, task, kind="dense")
        print(f"dense cache accuracy: {acc:.4f}", flush=True)
        return 0
    results = evaluate(model, task)
    if results["dense"]["accuracy"] < 0.95:
        print("model did not learn the task; not writing the result")
        return 1
    checks = ordering_checks(results)
    art = {
        "task": (f"teacher-forced copy of {task.n} tokens over a "
                 f"{task.vocab_size}-token alphabet; every copied token "
                 "is a decode step whose attention reads the "
                 "quantized/evicted prompt cache"),
        "model": ("toy-llama-2L-128d, 8 heads (head_dim=16), trained from "
                  "scratch (seed 0)"),
        "device": (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu"),
        "train_steps": args.steps, "train_seconds": seconds,
        "results": results, "ordering_checks": checks,
        "all_checks_pass": all(checks.values()),
    }
    pathlib.Path(args.out).write_text(json.dumps(art, indent=1))
    print("wrote", args.out, "all_checks_pass:", all(checks.values()))
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
