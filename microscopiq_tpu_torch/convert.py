"""Weights and KV-cache states from the JAX package, so that both packages
compute from the same numbers.

The caller hands over the flax tree with every leaf as numpy (this module
never imports JAX). A packed leaf arrives as a dict of its dataclass fields:
- ``PackedMX``: ``codes``, ``scale_exp``, ``elem_format``, ``block_size``,
  ``scale_bits``, ``orig_dim``, ``axis``, ``transport``, ``transport_mw`` and
  ``transport_fold``;
- ``PackedMXOutlier``: an ``inlier`` sub-dict of ``PackedMX`` fields plus
  ``out_codes``, ``out_pos``, ``out_scale_exp``, ``outlier_format`` and
  ``outlier_scale_bits``;
- ``PackedOutlierNB``: ``codes``, ``scale_exp``, ``out_byte``,
  ``out_scale_exp``, ``elem_format``, ``outlier_format``, ``block_size``,
  ``orig_n`` and ``orig_k``.
float8 and bfloat16 codes travel bit-exact. Names are kept
(``model/layers_{i}/self_attn/qkv_proj/kernel``, ``input_layernorm/scale``,
...).

A LLaVA tree (``vision_tower`` with the patch embedding's conv kernel,
``mm_projector``, the packed or dense language model under ``model``, the
``lm_head``) crosses as it is: the conv kernel keeps flax's (kh, kw, in,
out) layout, which the port's CLIP tower multiplies as it stands
(``vlm/clip.py``'s ``PatchEmbedding``), so no leaf is transposed here.

A quantized KV-cache state arrives as a mapping of ``QuantKVState`` field
names to numpy arrays (``None`` for a GEAR field that is off).

The MX layers of ``nn`` (``MXLinear``'s (in, out) ``kernel``, ``Conv2d``'s
OIHW ``kernel``, the norms' ``scale``/``bias``, BatchNorm's ``batch_stats``,
the LSTM's ``w_ih``/``w_hh``/``bias``) take their flax variables, moved by
:func:`params_from_jax`, through :func:`load_flax_variables`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from . import resolve_device
from .kv.cache import QuantKVState
from .ops.packing import PackedMX, PackedMXOutlier, PackedOutlierNB

_PACKED_FIELDS = ("codes", "scale_exp", "elem_format", "block_size",
                  "scale_bits", "orig_dim", "axis", "transport",
                  "transport_mw", "transport_fold")
_OUTLIER_FIELDS = ("inlier", "out_codes", "out_pos", "out_scale_exp",
                   "outlier_format", "outlier_scale_bits")
_NB_FIELDS = ("codes", "scale_exp", "out_byte", "out_scale_exp",
              "elem_format", "outlier_format", "block_size", "orig_n",
              "orig_k")
_STR_FIELDS = ("elem_format", "transport", "outlier_format")

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


def _packed_kind(node: dict):
    """(class, fields) of a packed leaf's dict, or None for a subtree."""
    if "inlier" in node:
        return PackedMXOutlier, _OUTLIER_FIELDS
    if "out_byte" in node:
        return PackedOutlierNB, _NB_FIELDS
    if "codes" in node and "scale_exp" in node:
        return PackedMX, _PACKED_FIELDS
    return None


def params_from_jax(tree, device="cuda"):
    """The port's weight tree from a numpy'd JAX parameter tree."""
    dev = resolve_device(device)

    def packed(node, path):
        cls, fields = _packed_kind(node)
        missing = [f for f in fields if f not in node]
        if missing:
            raise KeyError(f"{path}: packed leaf lacks {missing}")
        kw = {}
        for f in fields:
            v = node[f]
            if f == "inlier":
                kw[f] = packed(v, f"{path}/inlier")
            elif f in _STR_FIELDS:
                kw[f] = str(v)
            elif isinstance(v, (int, np.integer)):
                kw[f] = int(v)
            else:
                kw[f] = tensor_from_numpy(v, dev)
        return cls(**kw)

    def visit(node, path):
        if isinstance(node, dict):
            if _packed_kind(node) is not None:
                return packed(node, path)
            return {k: visit(v, f"{path}/{k}") for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return visit(tree, "")


def load_flax_variables(module: nn.Module, variables) -> nn.Module:
    """Copy a flax variable tree into ``module``: ``{"params": ...,
    "batch_stats": ...}`` (or a bare params tree) of tensors as
    :func:`params_from_jax` gives them. A subtree goes to the child module
    of its name (or of ``module.flax_names[name]``); a leaf to the
    parameter or buffer of its name, which must exist with the leaf's
    shape. Parameters are copied in place; a buffer takes the tensor."""
    cols = (variables if isinstance(variables, dict) and set(variables) <= {
        "params", "batch_stats"} and variables else {"params": variables})

    def visit(mod, tree, path):
        for key, val in tree.items():
            where = f"{path}/{key}"
            if isinstance(val, dict):
                name = getattr(mod, "flax_names", {}).get(key, key)
                child = getattr(mod, name, None)
                if not isinstance(child, nn.Module):
                    raise KeyError(f"{where} has no module")
                visit(child, val, where)
                continue
            held = getattr(mod, key, None)
            if not isinstance(held, torch.Tensor):
                raise KeyError(f"{where} has no parameter or buffer")
            if tuple(held.shape) != tuple(val.shape):
                raise ValueError(f"{where}: shape {tuple(val.shape)}, "
                                 f"module holds {tuple(held.shape)}")
            if isinstance(held, nn.Parameter):
                with torch.no_grad():
                    held.copy_(val)
            else:
                mod.register_buffer(key, val.to(held.device))

    for col, tree in cols.items():
        visit(module, tree, col)
    return module


def quant_state_from_jax(state_np, device="cuda") -> QuantKVState:
    """The port's QuantKVState from a numpy'd JAX ``QuantKVState``.

    A scalar ``length`` (the shared cache) becomes a 0-d int32 tensor with
    its host mirror ``host_length``; a per-slot vector stays a (B,) int32
    tensor.
    """
    dev = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(QuantKVState):
        val = state_np.get(f.name)
        if f.name == "length":
            arr = np.asarray(val).astype(np.int32)
            fields[f.name] = tensor_from_numpy(arr, dev)
            if arr.ndim == 0:
                fields["host_length"] = int(arr)
        elif f.name == "host_length":
            continue
        elif val is not None:
            fields[f.name] = tensor_from_numpy(val, dev)
    return QuantKVState(**fields)
