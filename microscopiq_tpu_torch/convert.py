"""Weights and KV-cache states from the JAX package, so that both packages
compute from the same numbers.

The caller hands over the flax tree with every leaf as numpy (this module
never imports JAX). A packed leaf arrives as a dict with the ``PackedMX``
fields: ``codes``, ``scale_exp``, ``elem_format``, ``block_size``,
``scale_bits``, ``orig_dim``, ``axis``, ``transport``, ``transport_mw`` and
``transport_fold``. Names are kept (``model/layers_{i}/self_attn/qkv_proj/
kernel``, ``input_layernorm/scale``, ...).

A quantized KV-cache state arrives as a mapping of ``QuantKVState`` field
names to numpy arrays (``None`` for a GEAR field that is off).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .kv.cache import QuantKVState
from .ops.packing import PackedMX

_PACKED_FIELDS = ("codes", "scale_exp", "elem_format", "block_size",
                  "scale_bits", "orig_dim", "axis", "transport",
                  "transport_mw", "transport_fold")

# numpy dtypes without a torch counterpart travel as same-width integers
_BIT_VIEWS = {"bfloat16": (np.uint16, torch.int16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn),
              "float8_e5m2": (np.uint8, torch.uint8, torch.float8_e5m2)}


def tensor_from_numpy(a, device) -> torch.Tensor:
    """Bit-exact torch tensor from a numpy array (bf16/float8 included)."""
    a = np.asarray(a)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        np_int, t_int, t_dtype = view
        t = torch.from_numpy(np.ascontiguousarray(a).view(np_int).copy())
        return t.view(t_int).view(t_dtype).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _is_packed(node: dict) -> bool:
    return "codes" in node and "scale_exp" in node


def params_from_jax(tree, device="cuda"):
    """The port's weight tree from a numpy'd JAX parameter tree."""
    dev = resolve_device(device)

    def visit(node, path):
        if isinstance(node, dict):
            if any(k in node for k in ("inlier", "out_codes", "out_byte")):
                raise NotImplementedError(
                    f"{path}: outlier weight formats are not ported yet "
                    "(ROADMAP queue 1 item 5)")
            if _is_packed(node):
                missing = [f for f in _PACKED_FIELDS if f not in node]
                if missing:
                    raise KeyError(f"{path}: packed leaf lacks {missing}")
                return PackedMX(
                    codes=tensor_from_numpy(node["codes"], dev),
                    scale_exp=tensor_from_numpy(node["scale_exp"], dev),
                    elem_format=str(node["elem_format"]),
                    block_size=int(node["block_size"]),
                    scale_bits=int(node["scale_bits"]),
                    orig_dim=int(node["orig_dim"]), axis=int(node["axis"]),
                    transport=str(node["transport"]),
                    transport_mw=int(node["transport_mw"]),
                    transport_fold=int(node["transport_fold"]))
            return {k: visit(v, f"{path}/{k}") for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return visit(tree, "")


def quant_state_from_jax(state_np, device="cuda") -> QuantKVState:
    """The port's QuantKVState from a numpy'd JAX ``QuantKVState``.

    A scalar ``length`` (the shared cache) becomes an int; a per-slot vector
    stays a (B,) int32 tensor.
    """
    dev = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(QuantKVState):
        val = state_np.get(f.name)
        if f.name == "length":
            arr = np.asarray(val)
            fields[f.name] = (int(arr) if arr.ndim == 0 else
                              tensor_from_numpy(arr.astype(np.int32), dev))
        elif val is not None:
            fields[f.name] = tensor_from_numpy(val, dev)
    return QuantKVState(**fields)
