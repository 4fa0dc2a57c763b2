"""HF checkpoint -> weight-tree conversion (local files only, no download).

Counterpart of ``microscopiq_tpu/models/loading.py``: reads a local HF
state dict (``.safetensors`` or torch ``.bin`` files, or an in-memory
``transformers`` model) and maps it onto the port's Llama (Llama, Mistral,
Mixtral names; MPT's fused ``Wqkv`` split into thirds) and OPT weight
trees, and exports those trees back to HF names.

``.safetensors`` files are read here, without the ``safetensors`` package:
an 8-byte little-endian header length, a JSON header of each tensor's
dtype, shape and ``data_offsets``, then the raw little-endian bytes, read
through ``torch.frombuffer`` (F32, F16 and BF16, the checkpoints' float
types; another dtype raises ValueError). The JAX package reads them with
``safetensors.numpy``, which raises on BF16 (the dtype Llama, Mistral and
Mixtral checkpoints ship in) unless ml_dtypes has given numpy a bfloat16
type, as importing JAX does. ``.bin`` files go through
``torch.load(weights_only=True)``. Every loaded tensor comes out float32,
as the JAX loader's ``.float()``, on the requested device (default the
card).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

from .. import resolve_device
from .llama import LlamaConfig
from .opt import OPTConfig

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16}


def read_safetensors(path: str, device="cuda"
                     ) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file in its stored dtype, on
    ``device``."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_ST_DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        # a writable copy of the bytes, so the tensor owns its storage
        buf = bytearray(raw[base + begin:base + end])
        t = (torch.frombuffer(buf, dtype=dtype) if buf
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape).to(dev)
    return out


def load_hf_state_dict(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """All weights of a local HF checkpoint directory, float32 on
    ``device``: its ``.safetensors`` files, else its ``.bin`` files."""
    dev = resolve_device(device)
    files = sorted(os.listdir(path))
    st_files = [f for f in files if f.endswith(".safetensors")]
    bin_files = [f for f in files if f.endswith(".bin")]
    state = {}
    if st_files:
        for f in st_files:
            state.update(read_safetensors(os.path.join(path, f), dev))
    elif bin_files:
        for f in bin_files:
            state.update(torch.load(os.path.join(path, f), map_location=dev,
                                    weights_only=True))
    else:
        raise FileNotFoundError(f"no safetensors/bin files in {path}")
    return {k: v.float() for k, v in state.items()}


def state_dict_from_torch_model(model, device="cuda"
                                ) -> Dict[str, torch.Tensor]:
    """In-memory ``transformers`` model -> float32 state dict on
    ``device``."""
    dev = resolve_device(device)
    return {k: v.detach().float().to(dev)
            for k, v in model.state_dict().items()}


def _t(w):  # HF (out, in) -> kernel (in, out)
    return w.T.contiguous()


def convert_llama(state: Dict[str, torch.Tensor], cfg: LlamaConfig):
    """HF Llama/Mistral/Mixtral state dict -> LlamaForCausalLM weights."""
    p = {"model": {}}
    m = p["model"]
    m["embed_tokens"] = state["model.embed_tokens.weight"]
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        layer = {
            "self_attn": {
                f"{n}_proj": {"kernel": _t(
                    state[pre + f"self_attn.{n}_proj.weight"])}
                for n in ("q", "k", "v", "o")},
            "input_layernorm": {
                "scale": state[pre + "input_layernorm.weight"]},
            "post_attention_layernorm": {
                "scale": state[pre + "post_attention_layernorm.weight"]},
        }
        if cfg.num_local_experts > 0:
            moe = {"gate": {"kernel": _t(
                state[pre + "block_sparse_moe.gate.weight"])}}
            for e in range(cfg.num_local_experts):
                ep = pre + f"block_sparse_moe.experts.{e}."
                moe[f"experts_{e}"] = {
                    "gate_proj": {"kernel": _t(state[ep + "w1.weight"])},
                    "down_proj": {"kernel": _t(state[ep + "w2.weight"])},
                    "up_proj": {"kernel": _t(state[ep + "w3.weight"])},
                }
            layer["block_sparse_moe"] = moe
        else:
            layer["mlp"] = {
                f"{n}_proj": {"kernel": _t(
                    state[pre + f"mlp.{n}_proj.weight"])}
                for n in ("gate", "up", "down")}
        m[f"layers_{i}"] = layer
    m["norm"] = {"scale": state["model.norm.weight"]}
    if not cfg.tie_word_embeddings:
        key = "lm_head.weight"
        if key in state:
            p["lm_head"] = {"kernel": _t(state[key])}
        else:  # tied checkpoints
            p["lm_head"] = {"kernel": _t(state["model.embed_tokens.weight"])}
    return {"params": p}


def convert_mpt(state: Dict[str, torch.Tensor], cfg: LlamaConfig):
    """HF MPT state dict -> LlamaForCausalLM weights (MPT family knobs).

    Layout (transformers ``modeling_mpt.py``): transformer.wte, per block
    norm_1 / attn.Wqkv / attn.out_proj / norm_2 / ffn.{up,down}_proj, final
    transformer.norm_f; embeddings tied, every Linear and LayerNorm
    biasless. Wqkv is split into q/k/v thirds; ``nn.fuse_projections``
    merges them again."""
    def g(k):
        return state.get("transformer." + k, state.get(k))

    d = cfg.hidden_size
    p = {"model": {}}
    m = p["model"]
    m["embed_tokens"] = g("wte.weight")
    for i in range(cfg.num_hidden_layers):
        pre = f"blocks.{i}."
        wqkv = g(pre + "attn.Wqkv.weight")          # (3d, d)
        m[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": {"kernel": _t(wqkv[:d])},
                "k_proj": {"kernel": _t(wqkv[d:2 * d])},
                "v_proj": {"kernel": _t(wqkv[2 * d:])},
                "o_proj": {"kernel": _t(g(pre + "attn.out_proj.weight"))},
            },
            "input_layernorm": {"scale": g(pre + "norm_1.weight")},
            "post_attention_layernorm": {"scale": g(pre + "norm_2.weight")},
            "mlp": {
                "up_proj": {"kernel": _t(g(pre + "ffn.up_proj.weight"))},
                "down_proj": {"kernel": _t(g(pre + "ffn.down_proj.weight"))},
            },
        }
    m["norm"] = {"scale": g("norm_f.weight")}
    if not cfg.tie_word_embeddings:
        p["lm_head"] = {"kernel": _t(state.get(
            "lm_head.weight", g("wte.weight")))}
    return {"params": p}


def convert_opt(state: Dict[str, torch.Tensor], cfg: OPTConfig):
    """HF OPT state dict -> OPTForCausalLM weights."""
    def g(k):
        return state.get("model." + k, state.get(k))

    p = {"embed_tokens": g("decoder.embed_tokens.weight"),
         "embed_positions": g("decoder.embed_positions.weight")}
    for i in range(cfg.num_hidden_layers):
        pre = f"decoder.layers.{i}."
        layer = {"self_attn": {
            n: {"kernel": _t(g(pre + f"self_attn.{n}.weight")),
                "bias": g(pre + f"self_attn.{n}.bias")}
            for n in ("q_proj", "k_proj", "v_proj", "out_proj")}}
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            layer[ln] = {"scale": g(pre + f"{ln}.weight"),
                         "bias": g(pre + f"{ln}.bias")}
        for fc in ("fc1", "fc2"):
            layer[fc] = {"kernel": _t(g(pre + f"{fc}.weight")),
                         "bias": g(pre + f"{fc}.bias")}
        p[f"layers_{i}"] = layer
    if cfg.do_layer_norm_before:
        p["final_layer_norm"] = {
            "scale": g("decoder.final_layer_norm.weight"),
            "bias": g("decoder.final_layer_norm.bias")}
    return {"params": p}


def _f32(v) -> torch.Tensor:
    return v.detach().to(torch.float32).contiguous()


def export_llama_state_dict(params, cfg: LlamaConfig
                            ) -> Dict[str, torch.Tensor]:
    """LlamaForCausalLM weights -> HF-named float32 state dict on the
    weights' device; the inverse of :func:`convert_llama` for dense-MLP
    Llama/Mistral trees of dense kernels."""
    p = params["params"] if "params" in params else params
    m = p["model"]
    out: Dict[str, torch.Tensor] = {}
    out["model.embed_tokens.weight"] = _f32(m["embed_tokens"])
    for i in range(cfg.num_hidden_layers):
        layer = m[f"layers_{i}"]
        pre = f"model.layers.{i}."
        for n in ("q", "k", "v", "o"):
            out[pre + f"self_attn.{n}_proj.weight"] = _f32(
                layer["self_attn"][f"{n}_proj"]["kernel"].T)
        for n in ("gate", "up", "down"):
            out[pre + f"mlp.{n}_proj.weight"] = _f32(
                layer["mlp"][f"{n}_proj"]["kernel"].T)
        out[pre + "input_layernorm.weight"] = _f32(
            layer["input_layernorm"]["scale"])
        out[pre + "post_attention_layernorm.weight"] = _f32(
            layer["post_attention_layernorm"]["scale"])
    out["model.norm.weight"] = _f32(m["norm"]["scale"])
    if cfg.tie_word_embeddings:
        out["lm_head.weight"] = _f32(m["embed_tokens"])
    else:
        out["lm_head.weight"] = _f32(p["lm_head"]["kernel"].T)
    return out


def export_opt_state_dict(params, cfg: OPTConfig) -> Dict[str, torch.Tensor]:
    """OPTForCausalLM weights -> HF-named float32 state dict on the
    weights' device; the inverse of :func:`convert_opt`."""
    p = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}

    def put(k, v):
        out["model." + k] = _f32(v)

    put("decoder.embed_tokens.weight", p["embed_tokens"])
    put("decoder.embed_positions.weight", p["embed_positions"])
    for i in range(cfg.num_hidden_layers):
        pre = f"decoder.layers.{i}."
        layer = p[f"layers_{i}"]
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(pre + f"self_attn.{n}.weight",
                layer["self_attn"][n]["kernel"].T)
            put(pre + f"self_attn.{n}.bias", layer["self_attn"][n]["bias"])
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            put(pre + f"{ln}.weight", layer[ln]["scale"])
            put(pre + f"{ln}.bias", layer[ln]["bias"])
        for fc in ("fc1", "fc2"):
            put(pre + f"{fc}.weight", layer[fc]["kernel"].T)
            put(pre + f"{fc}.bias", layer[fc]["bias"])
    if cfg.do_layer_norm_before:
        put("decoder.final_layer_norm.weight", p["final_layer_norm"]["scale"])
        put("decoder.final_layer_norm.bias", p["final_layer_norm"]["bias"])
    if cfg.tie_word_embeddings:
        out["lm_head.weight"] = out["model.decoder.embed_tokens.weight"]
    elif "lm_head" in p:
        out["lm_head.weight"] = _f32(p["lm_head"]["kernel"].T)
    return out
