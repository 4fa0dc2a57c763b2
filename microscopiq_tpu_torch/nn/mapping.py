"""Quantization, packing and serving-layout transforms of a parameter tree.

Counterpart of ``find_linear_params``, ``quantize_params``, ``pack_params``,
``_concat_kernels``, ``fuse_projections`` and ``mx_op_table`` in
``microscopiq_tpu/nn/mapping.py``. The tree is
the flax-named nested dict that :func:`microscopiq_tpu_torch.convert.
params_from_jax` and :func:`microscopiq_tpu_torch.models.llama.build_params`
produce; a leaf's path is the tuple of its keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import torch

from ..ops import packing
from ..ops.outlier import quantize_mx_outlier_op
from ..ops.packing import (PackedMX, PackedMXOutlier, PackedOutlierNB,
                           pack_mx, pack_mx_outlier)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _map_leaves(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def find_linear_params(params, skip: Sequence[str] = ("lm_head",)
                       ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """All 2-D ``kernel``/``weight`` leaves (the quantization targets),
    keyed by path; paths through a ``skip`` key are left out."""
    out = {}
    for keys, leaf in _leaves(params):
        if not (isinstance(leaf, torch.Tensor) and leaf.ndim == 2):
            continue
        if keys and keys[-1] not in ("kernel", "weight"):
            continue
        if any(s in keys for s in skip):
            continue
        out[keys] = leaf
    return out


def quantize_params(params, mx_specs, skip: Sequence[str] = ("lm_head",)):
    """Fake-quantize (round to nearest) every linear kernel of a tree with
    the outlier-aware MX quantizer on its last axis, bit-exact to the JAX
    ``quantize_params``; returns a new tree."""
    targets = set(find_linear_params(params, skip).keys())

    def visit(keys, leaf):
        if keys not in targets:
            return leaf
        return quantize_mx_outlier_op(
            leaf, mx_specs, inlier_elem_format=mx_specs["w_elem_format"],
            outlier_elem_format=(mx_specs["w_outlier_elem_format"]
                                 or mx_specs["w_elem_format"]),
            axes=[-1])

    return _map_leaves(params, visit)


def pack_params(params, mx_specs, skip: Sequence[str] = ("lm_head",),
                outlier_budget: int = 0, outlier_transport: str = "emi8m",
                decisions: dict = None, gemm_transport: str = None):
    """Pack every linear kernel, (in, out) = (K, N) blocked on axis 0, into
    the form its kernel serves; returns a new tree.

    - ``outlier_transport="compact"`` with ``decisions`` for a kernel's path
      (``quantize_mx_outlier_hessian_decisions`` of its (N, K) transpose plus
      ``"block_size"``): a :class:`PackedOutlierNB` with ``outlier_budget``
      slots;
    - else with ``outlier_budget > 0``: the absolute emi8m stream where the
      values fit it; else the side-band :class:`PackedMXOutlier`, merged into
      one emi8m stream where that is exact (transports "emi8m", "compact"),
      kept as it is otherwise or for ``outlier_transport="sideband"``;
    - else ``pack_mx`` in ``gemm_transport`` where given (e.g. "sb2" for
      int2, "pf4"/"pf6" for fp4/fp6), else the default GEMM transport
      (emi8 for fp4/fp6, sb4 for int4, the native container otherwise),
      pre-blocked.
    """
    targets = set(find_linear_params(params, skip).keys())
    decisions = decisions or {}
    fmt = mx_specs["w_elem_format"]
    ofmt = mx_specs["w_outlier_elem_format"]
    sb = mx_specs["scale_bits"] or 8
    bs = mx_specs["block_size"]

    def visit(keys, leaf):
        if keys not in targets:
            return leaf
        if outlier_transport == "compact" and keys in decisions:
            return packing.pack_outlier_nb(
                decisions[keys], budget=outlier_budget, elem_format=fmt,
                outlier_format=ofmt or "fp4_e2m1")
        if outlier_budget > 0:
            if outlier_transport in ("emi8m", "compact"):
                # the absolute per-element byte stream is exact for any
                # quantization geometry; raw weights do not fit it
                try:
                    return packing.to_serving_layout(
                        packing.pack_emi8m_absolute(leaf, block_size=bs,
                                                    axis=0, elem_format=fmt))
                except ValueError:
                    pass
            p = pack_mx_outlier(leaf, sb, sb, fmt, ofmt or fmt,
                                std_dev=mx_specs["outlier_std_dev"],
                                block_size=bs, outlier_budget=outlier_budget,
                                axis=0)
            if outlier_transport in ("emi8m", "compact"):
                try:
                    return packing.to_serving_layout(
                        packing.merge_outlier_emi8(p))
                except ValueError:
                    return p
            return p
        transport = gemm_transport or (
            "emi8" if fmt in ("fp4", "fp4_e2m1", "fp6_e3m2", "fp6_e2m3")
            else "sb4" if fmt == "int4" else "native")
        return packing.to_serving_layout(pack_mx(leaf, sb, fmt, bs, axis=0,
                                                 transport=transport))

    return _map_leaves(params, visit)


def _concat_kernels(kernels):
    """Concatenate linear kernels along the output axis N: dense (in, out)
    tensors; PackedMX(axis=0) leaves, whose codes and scale_exp concat along
    their last axis (emi8m ones after a rebase to a common field split);
    PackedOutlierNB leaves, along axis 0 of their (N, K) storage, with the
    slot bytes padded to the largest budget."""
    first = kernels[0]
    if isinstance(first, PackedOutlierNB):
        # exact only when every segment is a whole number of blocks
        if not all(isinstance(k, PackedOutlierNB)
                   and k.orig_n % k.block_size == 0
                   and k.block_size == first.block_size
                   and k.orig_k == first.orig_k for k in kernels):
            raise ValueError("NB kernels to fuse must share block size and "
                             "K, and hold whole blocks")
        budget = max(k.budget for k in kernels)

        def padb(k):
            if k.budget == budget:
                return k.out_byte
            pad = k.out_byte.new_zeros((budget - k.budget,)
                                       + tuple(k.out_byte.shape[1:]))
            return torch.cat([k.out_byte, pad], dim=0)

        return dataclasses.replace(
            first, codes=torch.cat([k.codes for k in kernels], dim=0),
            scale_exp=torch.cat([k.scale_exp for k in kernels], dim=0),
            out_byte=torch.cat([padb(k) for k in kernels], dim=1),
            out_scale_exp=torch.cat([k.out_scale_exp for k in kernels],
                                    dim=0),
            orig_n=sum(k.orig_n for k in kernels))
    if isinstance(first, PackedMX):
        for k in kernels[1:]:
            if not (isinstance(k, PackedMX)
                    and k.elem_format == first.elem_format
                    and k.block_size == first.block_size
                    and k.transport == first.transport
                    and k.axis == first.axis == 0):
                raise ValueError("packed kernels to fuse must share format, "
                                 "block size, transport and axis 0")
        if first.transport == "emi8m":
            # per-tensor field splits may differ; rebase to a common one
            mw = max(k.transport_mw for k in kernels)
            fold = max(k.transport_fold for k in kernels)
            kernels = [packing.emi8m_rebase(k, mw, fold) for k in kernels]
            first = kernels[0]
        return dataclasses.replace(
            first, codes=torch.cat([k.codes for k in kernels], dim=-1),
            scale_exp=torch.cat([k.scale_exp for k in kernels], dim=-1))
    if isinstance(first, PackedMXOutlier):
        raise TypeError("side-band PackedMXOutlier kernels do not fuse (the "
                        "JAX package has no such branch); serve them with "
                        "fused_projections=False")
    return torch.cat(kernels, dim=1)


def fuse_projections(params):
    """Merge q/k/v -> qkv_proj and gate/up -> gate_up_proj in every decoder
    layer (one wide kernel launch per group). Use with
    ``LlamaConfig(fused_projections=True)``. Returns a new tree; the input
    tree is not changed."""
    out = dict(params)
    if "model" in out:
        tree = dict(out["model"])
        out["model"] = tree
    else:
        tree = out
    for name in list(tree.keys()):
        if not name.startswith("layers_"):
            continue
        layer = dict(tree[name])
        attn = dict(layer.get("self_attn", {}))
        if {"q_proj", "k_proj", "v_proj"} <= set(attn):
            attn["qkv_proj"] = {"kernel": _concat_kernels(
                [attn.pop(p)["kernel"] for p in ("q_proj", "k_proj",
                                                 "v_proj")])}
            layer["self_attn"] = attn
        mlp = dict(layer.get("mlp", {}))
        if {"gate_proj", "up_proj"} <= set(mlp):
            mlp["gate_up_proj"] = {"kernel": _concat_kernels(
                [mlp.pop(p)["kernel"] for p in ("gate_proj", "up_proj")])}
            layer["mlp"] = mlp
        tree[name] = layer
    return out


def mx_op_table(mx_specs) -> Dict[str, Callable]:
    """Op name -> its MX-quantized op with ``mx_specs`` bound."""
    from . import activations as act
    from . import simd_ops as simd
    from .linear import bmm, linear, matmul
    from .softmax import softmax

    def bind(fn):
        return lambda *a, **k: fn(*a, mx_specs=mx_specs, **k)

    return {
        "linear": bind(linear), "matmul": bind(matmul), "bmm": bind(bmm),
        "softmax": bind(softmax),
        "relu": bind(act.relu), "relu6": bind(act.relu6),
        "gelu": bind(act.gelu), "silu": bind(act.silu),
        "sigmoid": bind(act.sigmoid), "tanh": bind(act.tanh),
        "leaky_relu": bind(act.leaky_relu),
        "add": bind(simd.simd_add), "sub": bind(simd.simd_sub),
        "mul": bind(simd.simd_mul), "div": bind(simd.simd_div),
        "sqrt": bind(simd.simd_sqrt), "square": bind(simd.simd_square),
        "exp": bind(simd.simd_exp), "log": bind(simd.simd_log),
        "sum": bind(simd.simd_reduce_sum),
        "mean": bind(simd.simd_reduce_mean),
        "norm": bind(simd.simd_norm),
    }
