"""LLM quantization CLI: GPTQ-calibrate a model with the MX-outlier
quantizer (or round to nearest with --nearest), evaluate perplexity,
time per-token decode, save and load packed checkpoints.

Counterpart of ``microscopiq_tpu/cli/llm_cli.py``, with the same flags and
``--device`` (default ``cuda``; ``cpu`` runs the plain versions). Models:
``tiny-llama`` and ``tiny-opt``, whose weights are the port's seeded
``build_params`` (N(0, 0.02), seed 0; flax's initialisation cannot be
reproduced without JAX, so they are not the JAX CLI's weights), or a local
HF checkpoint directory (``config.json`` and ``.safetensors`` or ``.bin``
files, read by ``models/loading.py``; an OPT architecture or else the
Llama family: Llama, Mistral, Mixtral).

Usage:
  python -m microscopiq_tpu_torch.cli.llm_cli tiny-opt synthetic \\
      --inlier-format int2 --outlier-format fp4_e2m1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_model(name: str, device="cuda"):
    """(kind, cfg, model class, weight tree, tokenizer) of a model name or
    a local HF checkpoint directory (the tokenizer: ``transformers``'
    ``AutoTokenizer`` from the directory's files where it loads, else
    None)."""
    from ..models import llama, opt

    if name == "tiny-opt":
        cfg = opt.OPTConfig.tiny()
        return ("opt", cfg, opt.OPTForCausalLM,
                opt.build_params(cfg, seed=0, device=device), None)
    if name == "tiny-llama":
        cfg = llama.LlamaConfig.tiny()
        return ("llama", cfg, llama.LlamaForCausalLM,
                llama.build_params(cfg, seed=0, device=device), None)

    # local HF checkpoint directory
    from ..models import loading

    with open(os.path.join(name, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or [""])[0].lower()
    state = loading.load_hf_state_dict(name, device=device)
    tokenizer = None
    try:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(name,
                                                  local_files_only=True)
    except Exception:
        pass
    if "opt" in arch:
        cfg = opt.OPTConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            ffn_dim=hf["ffn_dim"], num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            max_position_embeddings=hf["max_position_embeddings"],
            do_layer_norm_before=hf.get("do_layer_norm_before", True))
        return ("opt", cfg, opt.OPTForCausalLM,
                loading.convert_opt(state, cfg), tokenizer)
    cfg = llama.LlamaConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf.get("num_key_value_heads",
                                   hf["num_attention_heads"]),
        max_position_embeddings=hf["max_position_embeddings"],
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        sliding_window=hf.get("sliding_window"),
        num_local_experts=hf.get("num_local_experts", 0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False))
    return ("llama", cfg, llama.LlamaForCausalLM,
            loading.convert_llama(state, cfg), tokenizer)


def benchmark_decode(model, n_tokens: int = 64, batch: int = 1) -> float:
    """Median seconds a token of greedy decode over ``n_tokens`` tokens
    (three runs after a warm-up), from an 8-token prompt."""
    from ..eval.generate import generate

    prompt = np.zeros((batch, 8), np.int64)
    generate(model, prompt, max_new_tokens=4)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        generate(model, prompt, max_new_tokens=n_tokens)
        times.append((time.perf_counter() - t0) / n_tokens)
    return float(np.median(times))


def main(argv=None):
    from ..specs import add_mx_args

    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("model", help="tiny-opt | tiny-llama (seeded "
                        "build_params weights) | a local HF checkpoint dir")
    parser.add_argument("dataset", nargs="?", default="synthetic",
                        choices=["wikitext2", "ptb", "c4", "synthetic"])
    parser.add_argument("--nsamples", type=int, default=128)
    parser.add_argument("--seqlen", type=int, default=2048)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--nearest", action="store_true",
                        help="RTN instead of GPTQ")
    parser.add_argument("--inlier-format", default="int2")
    parser.add_argument("--outlier-format", default="fp4_e2m1")
    parser.add_argument("--inlier-scale-bits", type=int, default=8)
    parser.add_argument("--outlier-scale-bits", type=int, default=8)
    parser.add_argument("--quant-block-size", type=int, default=16)
    parser.add_argument("--std-dev", type=float, default=2.0)
    parser.add_argument("--percdamp", type=float, default=0.01)
    parser.add_argument("--blocksize", type=int, default=128)
    parser.add_argument("--act-order", action="store_true")
    parser.add_argument("--no-quant", action="store_true")
    parser.add_argument("--allow-synthetic", action="store_true",
                        help="permit the fallback to the synthetic corpus "
                             "when the dataset is missing")
    parser.add_argument("--benchmark", type=int, default=0,
                        help="decode-latency benchmark over N tokens")
    parser.add_argument("--save", default="",
                        help="save the (quantized) checkpoint to this dir")
    parser.add_argument("--load", default="",
                        help="load a checkpoint from this dir")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    add_mx_args(parser)
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..eval import get_loaders, perplexity
    from ..nn import quantize_params
    from ..quant import MXQuantizer
    from ..quant.calibrate import gptq_quantize_model
    from ..specs import finalize_mx_specs
    from ..utils.checkpoint import load_checkpoint, save_checkpoint

    dev = resolve_device(args.device)
    kind, cfg, model_cls, params, tokenizer = build_model(args.model, dev)
    seqlen = min(args.seqlen, cfg.max_position_embeddings)
    crops, test_ids = get_loaders(args.dataset, args.nsamples, args.seed,
                                  seqlen, tokenizer,
                                  allow_synthetic=args.allow_synthetic)
    calib = torch.as_tensor(np.concatenate(crops, 0) % cfg.vocab_size,
                            device=dev).long()
    test_ids = np.asarray(test_ids) % cfg.vocab_size

    if args.load:
        params = load_checkpoint(args.load, device=dev)
        print(f"loaded checkpoint from {args.load}")
    elif not args.no_quant:
        t0 = time.time()
        if args.nearest:
            specs = finalize_mx_specs({
                "w_elem_format": args.inlier_format,
                "w_outlier_elem_format": args.outlier_format,
                "scale_bits": args.inlier_scale_bits,
                "block_size": args.quant_block_size,
                "outlier_std_dev": args.std_dev, "bfloat": 16})
            params = {"params": quantize_params(params["params"], specs)}
            print(f"RTN quantization done in {time.time() - t0:.1f}s")
        else:
            qz = MXQuantizer()
            qz.configure(args.inlier_scale_bits, args.outlier_scale_bits,
                         args.inlier_format, args.outlier_format,
                         std_dev=args.std_dev, axes=[0],
                         block_size=args.quant_block_size)
            params = gptq_quantize_model(
                kind, cfg, params, calib, quantizer=qz,
                blocksize=args.blocksize, percdamp=args.percdamp,
                actorder=args.act_order)
            print(f"GPTQ calibration done in {time.time() - t0:.1f}s")

    if args.save:
        save_checkpoint(args.save, params)
        print(f"saved checkpoint to {args.save}")

    model = model_cls(cfg, device=dev).load_params(params)
    ppl = perplexity(model, test_ids, seqlen=seqlen, batch=1, verbose=True)
    print(f"{args.dataset} perplexity: {ppl:.4f}")

    if args.benchmark:
        lat = benchmark_decode(model, args.benchmark)
        print(f"median decode latency: {lat * 1e3:.2f} ms/token "
              f"({1 / lat:.1f} tokens/s)")
    return ppl


if __name__ == "__main__":
    main()
