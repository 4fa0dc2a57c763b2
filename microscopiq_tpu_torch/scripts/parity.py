"""The accuracy-parity grid at model scale: eight configs' perplexities.

    python -m microscopiq_tpu_torch.scripts.parity [--device cuda] \
        [--weights DIR] [--seed 0] [--only dense,llama_dense] [--out DIR]

Counterpart of ``scripts/parity_ref.py``'s ``ours`` stage on the port: OPT
(vocabulary 4096, hidden 512, FFN 2048, 12 layers, 8 heads) and Llama
(hidden 512, intermediate 1536, 12 layers, 8 heads, 4 KV heads) models,
the calibration crops (16 of 256 tokens) and the eval stream (32 windows of
256) cut from the same seeded order-1 Markov stream, and the eight
configs:

  dense                           OPT float32
  gptq_int2_fp4_block16           GPTQ, int2 inliers + fp4 outliers, block
                                  16 (plus its packed emi8m and compact NB
                                  serving trees)
  gptq_int2_fp4_block16_actorder  + act-order
  gptq_int2_fp4_g128_static       + group size 128, static groups
  rtn_mxfp6_block32               weights-only MX-FP6 (fake and packed)
  actquant_fp4w_int4a_block128    fp4 weights, int4 activations (the MX
                                  linears only, ``a_axes=1``)
  llama_dense, llama_gptq_int2_fp4_block16

Weights are HF-named float32 state dicts: ``weights_opt.npz`` and
``weights_llama.npz`` in ``--weights`` (the layout ``parity_ref.py
prepare`` exports), or seeded at these shapes by :func:`seeded_state_dicts`
(no training). The models run on the card unless ``--device cpu``: the
packed trees through the GEMM kernels there. Writes
``<out>/results_<device>.json`` (``--out`` defaults to ``parity_torch/``
at the working directory, git-ignored) and prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

MODEL_OPT = dict(vocab_size=4096, hidden_size=512, ffn_dim=2048,
                 num_hidden_layers=12, num_attention_heads=8,
                 max_position_embeddings=512)
MODEL_LLAMA = dict(vocab_size=4096, hidden_size=512,
                   intermediate_size=1536, num_hidden_layers=12,
                   num_attention_heads=8, num_key_value_heads=4,
                   max_position_embeddings=512, rms_norm_eps=1e-5,
                   rope_theta=10000.0)
SEQLEN = 256
NSAMPLES = 16          # calibration crops
EVAL_WINDOWS = 32
PPL_BATCH = 4

# the canonical GPTQ config (reference llm/opt.py:87-94)
GPTQ_CFG = dict(inlier="int2", outlier="fp4_e2m1", scale_bits=8,
                block_size=16, std_dev=2, percdamp=0.01, blocksize=128)
FP6_CFG = dict(fmt="fp6_e3m2", scale_bits=8, block_size=32)
ACT_CFG = dict(w_elem_format="fp4", a_elem_format="int4", block_size=128,
               quantize_backprop=False)
GPTQ_VARIANTS = {
    "gptq_int2_fp4_block16": dict(groupsize=-1, act_order=False,
                                  static_groups=False),
    "gptq_int2_fp4_block16_actorder": dict(groupsize=-1, act_order=True,
                                           static_groups=False),
    "gptq_int2_fp4_g128_static": dict(groupsize=128, act_order=False,
                                      static_groups=True),
}
ALL_CONFIGS = ("dense", *GPTQ_VARIANTS, "rtn_mxfp6_block32",
               "actquant_fp4w_int4a_block128", "llama_dense",
               "llama_gptq_int2_fp4_block16")
# one group with every linear: the reference scripts' one-pass capture
OPT_GROUP = [["self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj",
              "self_attn/out_proj", "fc1", "fc2"]]
LLAMA_GROUP = [["self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj",
                "self_attn/o_proj", "mlp/gate_proj", "mlp/up_proj",
                "mlp/down_proj"]]
SKIP = ("embed_tokens", "embed_positions", "lm_head")


def markov_stream(n_tokens: int, vocab: int, seed: int = 7,
                  branching: int = 24) -> np.ndarray:
    """Order-1 Markov corpus: every token has ``branching`` successors with
    Zipf weights (a copy of ``scripts/parity_ref.py::markov_stream``)."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branching))
    ranks = np.arange(1, branching + 1)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    cols = rng.choice(branching, size=n_tokens, p=probs)
    out = np.empty(n_tokens, np.int32)
    cur = int(rng.integers(0, vocab))
    for i in range(n_tokens):
        cur = int(succ[cur, cols[i]])
        out[i] = cur
    return out


def make_tokens(vocab: int = 4096, nsamples: int = NSAMPLES,
                windows: int = EVAL_WINDOWS):
    """(calibration crops (nsamples, SEQLEN), eval stream) as
    ``parity_ref.py::make_tokens`` cuts them from its 2.2M-token stream."""
    stream = markov_stream(2_200_000, vocab, seed=7)
    rng = np.random.default_rng(0)
    tail = stream[2_000_000:]
    starts = rng.integers(0, len(tail) - SEQLEN - 1, size=nsamples)
    calib = np.stack([tail[s:s + SEQLEN] for s in starts])
    return calib, tail[-(windows * SEQLEN + 1):-1]


def seeded_state_dicts(seed: int = 0):
    """(OPT, Llama) HF-named float32 numpy state dicts at the parity
    shapes: kernels N(0, 1/fan_in), embeddings N(0, 1/hidden) (OPT's,
    which its logits reuse; positions N(0, 0.01/hidden)) and N(0, 1)
    (Llama's), norm scales 1 + N(0, 0.1), biases N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def w(n_out, n_in):
        return (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)
                ).astype(np.float32)

    def vec(n, mean, std):
        return (mean + std * rng.standard_normal(n)).astype(np.float32)

    o, D = MODEL_OPT, MODEL_OPT["hidden_size"]
    opt = {"model.decoder.embed_tokens.weight": vec(
               o["vocab_size"] * D, 0, D ** -0.5).reshape(o["vocab_size"], D),
           "model.decoder.embed_positions.weight": vec(
               (o["max_position_embeddings"] + 2) * D, 0,
               0.1 * D ** -0.5).reshape(-1, D)}
    for i in range(o["num_hidden_layers"]):
        pre = f"model.decoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            opt[pre + f"self_attn.{n}.weight"] = w(D, D)
            opt[pre + f"self_attn.{n}.bias"] = vec(D, 0, 0.02)
        opt[pre + "fc1.weight"] = w(o["ffn_dim"], D)
        opt[pre + "fc1.bias"] = vec(o["ffn_dim"], 0, 0.02)
        opt[pre + "fc2.weight"] = w(D, o["ffn_dim"])
        opt[pre + "fc2.bias"] = vec(D, 0, 0.02)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            opt[pre + f"{ln}.weight"] = vec(D, 1, 0.1)
            opt[pre + f"{ln}.bias"] = vec(D, 0, 0.02)
    opt["model.decoder.final_layer_norm.weight"] = vec(D, 1, 0.1)
    opt["model.decoder.final_layer_norm.bias"] = vec(D, 0, 0.02)

    m = MODEL_LLAMA
    D, I = m["hidden_size"], m["intermediate_size"]
    hd = D // m["num_attention_heads"]
    kv = m["num_key_value_heads"] * hd
    llama = {"model.embed_tokens.weight": vec(
        m["vocab_size"] * D, 0, 1).reshape(m["vocab_size"], D)}
    for i in range(m["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for n, shape in (("q", (D, D)), ("k", (kv, D)), ("v", (kv, D)),
                         ("o", (D, D))):
            llama[pre + f"self_attn.{n}_proj.weight"] = w(*shape)
        llama[pre + "mlp.gate_proj.weight"] = w(I, D)
        llama[pre + "mlp.up_proj.weight"] = w(I, D)
        llama[pre + "mlp.down_proj.weight"] = w(D, I)
        llama[pre + "input_layernorm.weight"] = vec(D, 1, 0.1)
        llama[pre + "post_attention_layernorm.weight"] = vec(D, 1, 0.1)
    llama["model.norm.weight"] = vec(D, 1, 0.1)
    llama["lm_head.weight"] = w(m["vocab_size"], D)
    return opt, llama


def load_state_dicts(weights_dir: str):
    """(OPT, Llama) numpy state dicts from ``parity_ref.py prepare``'s
    ``weights_opt.npz`` and ``weights_llama.npz``."""
    out = []
    for name in ("weights_opt.npz", "weights_llama.npz"):
        with np.load(os.path.join(weights_dir, name)) as z:
            out.append({k: z[k] for k in z.files})
    return tuple(out)


def _torch_state(sd: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in sd.items()}


def make_quantizer():
    from ..quant import MXQuantizer

    qz = MXQuantizer()
    qz.configure(GPTQ_CFG["scale_bits"], GPTQ_CFG["scale_bits"],
                 GPTQ_CFG["inlier"], GPTQ_CFG["outlier"],
                 std_dev=GPTQ_CFG["std_dev"], axes=[0],
                 block_size=GPTQ_CFG["block_size"])
    return qz


def run(state_dicts, calib: np.ndarray, eval_ids: np.ndarray,
        device="cuda", only: Optional[Iterable[str]] = None,
        log=print) -> Dict[str, float]:
    """The perplexities of the configs in ``only`` (default all) on
    ``device``; keys as ``parity_ref.py``'s results (``<config>``,
    ``<config>_packed``, ``_nb_packed``, ``_nb_bits_per_element``), with
    ``<config>_s`` the seconds of each config."""
    from .. import resolve_device
    from ..eval.ppl import perplexity
    from ..models import LlamaConfig, LlamaForCausalLM, OPTConfig
    from ..models.loading import convert_llama, convert_opt
    from ..models.opt import OPTForCausalLM
    from ..nn import pack_params, quantize_params
    from ..ops.packing import PackedOutlierNB
    from ..quant.calibrate import gptq_quantize_model
    from ..specs import finalize_mx_specs

    dev = resolve_device(device)
    todo = set(only or ALL_CONFIGS)
    unknown = todo - set(ALL_CONFIGS)
    if unknown:
        raise ValueError(f"unknown configs {sorted(unknown)}")
    res: Dict[str, float] = {}

    def record(name, val):
        res[name] = val
        log(f"{name}: {val}")

    ocfg = OPTConfig(**MODEL_OPT)
    oparams = convert_opt(_torch_state(state_dicts[0], dev), ocfg)
    calib_t = torch.as_tensor(calib.astype(np.int64), device=dev)

    def oppl(params, **kw):
        m = OPTForCausalLM(ocfg, device=dev, **kw).load_params(params)
        return perplexity(m, eval_ids, SEQLEN, batch=PPL_BATCH)

    t0 = time.perf_counter()
    if "dense" in todo:
        record("dense", oppl(oparams))
        record("dense_s", time.perf_counter() - t0)
    specs_o = finalize_mx_specs({
        "w_elem_format": GPTQ_CFG["inlier"],
        "w_outlier_elem_format": GPTQ_CFG["outlier"],
        "scale_bits": GPTQ_CFG["scale_bits"],
        "block_size": GPTQ_CFG["block_size"], "bfloat": 16})
    for name, knobs in GPTQ_VARIANTS.items():
        if name not in todo:
            continue
        t0 = time.perf_counter()
        collect = name == "gptq_int2_fp4_block16"
        out = gptq_quantize_model(
            "opt", ocfg, oparams, calib_t, quantizer=make_quantizer(),
            blocksize=GPTQ_CFG["blocksize"], percdamp=GPTQ_CFG["percdamp"],
            actorder=knobs["act_order"], groupsize=knobs["groupsize"],
            static_groups=knobs["static_groups"], groups=OPT_GROUP,
            verbose=False, collect_decisions=collect)
        gptq_params, decisions = out if collect else (out, None)
        record(name, oppl(gptq_params))
        if collect:
            record(name + "_packed", oppl({"params": pack_params(
                gptq_params["params"], specs_o, skip=SKIP,
                outlier_budget=4)}))
            nb = pack_params(gptq_params["params"], specs_o, skip=SKIP,
                             outlier_budget=0, outlier_transport="compact",
                             decisions=decisions)
            record(name + "_nb_packed", oppl({"params": nb}))
            record(name + "_nb_bits_per_element", round(max(
                leaf.bits_per_element for leaf in _leaves(nb)
                if isinstance(leaf, PackedOutlierNB)), 3))
        record(name + "_s", time.perf_counter() - t0)
    if "rtn_mxfp6_block32" in todo:
        t0 = time.perf_counter()
        specs6 = finalize_mx_specs({
            "w_elem_format": FP6_CFG["fmt"],
            "scale_bits": FP6_CFG["scale_bits"],
            "block_size": FP6_CFG["block_size"], "bfloat": 16})
        rtn = quantize_params(oparams["params"], specs6,
                              skip=("embed_tokens", "embed_positions"))
        record("rtn_mxfp6_block32", oppl({"params": rtn}))
        record("rtn_mxfp6_block32_packed", oppl({"params": pack_params(
            rtn, specs6, skip=SKIP)}))
        record("rtn_mxfp6_block32_s", time.perf_counter() - t0)
    if "actquant_fp4w_int4a_block128" in todo:
        t0 = time.perf_counter()
        record("actquant_fp4w_int4a_block128", oppl(
            oparams, mx_specs=finalize_mx_specs(dict(ACT_CFG, a_axes=1)),
            mx_linear_only=True))
        record("actquant_fp4w_int4a_block128_s", time.perf_counter() - t0)
    if todo & {"llama_dense", "llama_gptq_int2_fp4_block16"}:
        lcfg = LlamaConfig(**MODEL_LLAMA)
        lparams = convert_llama(_torch_state(state_dicts[1], dev), lcfg)

        def lppl(params):
            m = LlamaForCausalLM(lcfg, device=dev).load_params(params)
            return perplexity(m, eval_ids, SEQLEN, batch=PPL_BATCH)

        if "llama_dense" in todo:
            t0 = time.perf_counter()
            record("llama_dense", lppl(lparams))
            record("llama_dense_s", time.perf_counter() - t0)
        if "llama_gptq_int2_fp4_block16" in todo:
            t0 = time.perf_counter()
            lq = gptq_quantize_model(
                "llama", lcfg, lparams, calib_t, quantizer=make_quantizer(),
                blocksize=GPTQ_CFG["blocksize"],
                percdamp=GPTQ_CFG["percdamp"], groups=LLAMA_GROUP,
                verbose=False)
            record("llama_gptq_int2_fp4_block16", lppl(lq))
            record("llama_gptq_int2_fp4_block16_s",
                   time.perf_counter() - t0)
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--weights", default=None,
                   help="directory of weights_opt.npz / weights_llama.npz")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights when --weights is not given")
    p.add_argument("--only", default=None,
                   help="comma-separated configs (default: all eight)")
    p.add_argument("--out", default="parity_torch")
    a = p.parse_args(argv)
    only = a.only.split(",") if a.only else None
    sds = (load_state_dicts(a.weights) if a.weights
           else seeded_state_dicts(a.seed))
    calib, eval_ids = make_tokens(MODEL_OPT["vocab_size"])
    t0 = time.perf_counter()
    res = run(sds, calib, eval_ids, a.device, only,
              log=lambda s: print(s, file=sys.stderr, flush=True))
    out = dict(results=res, device=a.device,
               weights=a.weights or f"seeded {a.seed}",
               seconds=time.perf_counter() - t0)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"results_{a.device}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
