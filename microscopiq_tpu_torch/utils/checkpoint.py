"""Checkpoints of (packed) weight trees, in the JAX package's format.

Counterpart of ``microscopiq_tpu/utils/checkpoint.py``: a directory with
``arrays.npz`` (leaf ``i``'s arrays as ``"{i}.codes"``, ``"{i}.a"``, ...)
and ``structure.json`` (each leaf's path, kind and static packing fields,
and each array's dtype name). Leaves are numbered in sorted-key order, as
``jax.tree_util`` flattens a dict. float8 arrays are stored as uint8 views
and bfloat16 ones as uint16 views, each with its true dtype name beside it
(the JAX package stores float8 so too; its own bfloat16 arrays go into the
npz as 2-byte voids, which this loader reads by their name). Either
package reads what the other wrote, the packed leaves (``PackedMX``,
``PackedMXOutlier``, ``PackedOutlierNB``) included.

Also the dense-tree algebra of delta checkpoints (``make_delta``,
``apply_delta``) and ``consolidate``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..ops.packing import PackedMX, PackedMXOutlier, PackedOutlierNB

_PACKED_TYPES = (PackedMX, PackedMXOutlier, PackedOutlierNB)

# dtypes numpy lacks: (stored view, torch view of the same width, dtype)
_VIEWS = {"bfloat16": (np.uint16, torch.int16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn),
          "float8_e5m2": (np.uint8, torch.uint8, torch.float8_e5m2)}
_NAMES = {v[2]: k for k, v in _VIEWS.items()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def _to_numpy(t: torch.Tensor):
    """(stored array, true dtype name) of a tensor."""
    t = t.detach().cpu().contiguous()
    name = _NAMES.get(t.dtype)
    if name is not None:
        return t.view(_VIEWS[name][1]).numpy().view(_VIEWS[name][0]), name
    a = t.numpy()
    return a, a.dtype.name


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a (possibly packed) weight tree: arrays to ``arrays.npz``,
    structure and static packing fields to ``structure.json``."""
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, {}
    meta = {"leaves": []}

    def put(key, t):
        arrays[key], dtypes[key] = _to_numpy(t)

    for i, (keys, leaf) in enumerate(_leaves(tree)):
        entry = {"path": list(keys)}
        if isinstance(leaf, PackedMX):
            entry["kind"] = "PackedMX"
            entry["static"] = {
                "elem_format": leaf.elem_format,
                "block_size": leaf.block_size,
                "scale_bits": leaf.scale_bits,
                "orig_dim": leaf.orig_dim, "axis": leaf.axis,
                "transport": leaf.transport,
                "transport_mw": leaf.transport_mw,
                "transport_fold": leaf.transport_fold}
            put(f"{i}.codes", leaf.codes)
            put(f"{i}.scale_exp", leaf.scale_exp)
        elif isinstance(leaf, PackedMXOutlier):
            entry["kind"] = "PackedMXOutlier"
            entry["static"] = {
                "elem_format": leaf.inlier.elem_format,
                "block_size": leaf.inlier.block_size,
                "scale_bits": leaf.inlier.scale_bits,
                "orig_dim": leaf.inlier.orig_dim,
                "axis": leaf.inlier.axis,
                "outlier_format": leaf.outlier_format,
                "outlier_scale_bits": leaf.outlier_scale_bits}
            put(f"{i}.codes", leaf.inlier.codes)
            put(f"{i}.scale_exp", leaf.inlier.scale_exp)
            put(f"{i}.out_codes", leaf.out_codes)
            put(f"{i}.out_pos", leaf.out_pos)
            put(f"{i}.out_scale_exp", leaf.out_scale_exp)
        elif isinstance(leaf, PackedOutlierNB):
            entry["kind"] = "PackedOutlierNB"
            entry["static"] = {
                "elem_format": leaf.elem_format,
                "outlier_format": leaf.outlier_format,
                "block_size": leaf.block_size,
                "orig_n": leaf.orig_n, "orig_k": leaf.orig_k}
            put(f"{i}.codes", leaf.codes)
            put(f"{i}.scale_exp", leaf.scale_exp)
            put(f"{i}.out_byte", leaf.out_byte)
            put(f"{i}.out_scale_exp", leaf.out_scale_exp)
        else:
            entry["kind"] = "array"
            put(f"{i}.a", leaf)
        meta["leaves"].append(entry)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    meta["dtypes"] = dtypes
    with open(os.path.join(path, "structure.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, device="cuda") -> Any:
    """Load a checkpoint of :func:`save_checkpoint` (or of the JAX
    package's) into a nested dict of tensors on ``device``, the packed
    leaves rebuilt."""
    dev = resolve_device(device)
    with open(os.path.join(path, "structure.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    def arr(key):
        a = data[key]
        view = _VIEWS.get(meta["dtypes"][key])
        if view is not None:
            t = torch.from_numpy(np.ascontiguousarray(a).view(view[0]))
            return t.view(view[1]).view(view[2]).to(dev)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    root: dict = {}
    for i, entry in enumerate(meta["leaves"]):
        node = root
        for k in entry["path"][:-1]:
            node = node.setdefault(k, {})
        last = entry["path"][-1]
        st = entry.get("static", {})
        if entry["kind"] == "PackedMX":
            node[last] = PackedMX(
                codes=arr(f"{i}.codes"), scale_exp=arr(f"{i}.scale_exp"),
                elem_format=st["elem_format"], block_size=st["block_size"],
                scale_bits=st["scale_bits"], orig_dim=st["orig_dim"],
                axis=st["axis"], transport=st.get("transport", "native"),
                transport_mw=st.get("transport_mw", 0),
                transport_fold=st.get("transport_fold", 0))
        elif entry["kind"] == "PackedMXOutlier":
            node[last] = PackedMXOutlier(
                inlier=PackedMX(
                    codes=arr(f"{i}.codes"), scale_exp=arr(f"{i}.scale_exp"),
                    elem_format=st["elem_format"],
                    block_size=st["block_size"],
                    scale_bits=st["scale_bits"], orig_dim=st["orig_dim"],
                    axis=st["axis"]),
                out_codes=arr(f"{i}.out_codes"), out_pos=arr(f"{i}.out_pos"),
                out_scale_exp=arr(f"{i}.out_scale_exp"),
                outlier_format=st["outlier_format"],
                outlier_scale_bits=st["outlier_scale_bits"])
        elif entry["kind"] == "PackedOutlierNB":
            node[last] = PackedOutlierNB(
                codes=arr(f"{i}.codes"), scale_exp=arr(f"{i}.scale_exp"),
                out_byte=arr(f"{i}.out_byte"),
                out_scale_exp=arr(f"{i}.out_scale_exp"),
                elem_format=st["elem_format"],
                outlier_format=st["outlier_format"],
                block_size=st["block_size"], orig_n=st["orig_n"],
                orig_k=st["orig_k"])
        else:
            node[last] = arr(f"{i}.a")
    return root


def _delta_combine(base: Any, other: Any, sign: int) -> Any:
    """Shared walker of make/apply delta: keys only in ``other`` pass
    through, keys only in ``base`` are kept, and a leaf of ``other`` larger
    than ``base``'s (an extended vocabulary) takes ``base`` on its leading
    slab only."""
    if isinstance(base, dict) or isinstance(other, dict):
        bd = base if isinstance(base, dict) else {}
        od = other if isinstance(other, dict) else {}
        out = {}
        for k in set(bd) | set(od):
            if k not in bd:
                out[k] = od[k]
            elif k not in od:
                out[k] = bd[k]
            else:
                out[k] = _delta_combine(bd[k], od[k], sign)
        return out
    if isinstance(base, _PACKED_TYPES) or isinstance(other, _PACKED_TYPES):
        raise TypeError("delta utilities operate on dense trees; compute "
                        "deltas pre-packing")
    if base.shape == other.shape:
        return other + sign * base
    if not (base.ndim == other.ndim and all(
            b <= o for b, o in zip(base.shape, other.shape))):
        raise ValueError(f"delta shape {tuple(other.shape)} smaller than "
                         f"base {tuple(base.shape)}")
    slab = tuple(slice(0, b) for b in base.shape)
    out = other.clone()
    out[slab] = other[slab] + sign * base
    return out


def make_delta(base: Any, target: Any) -> Any:
    """delta = target - base; target-only keys are stored as they are."""
    return _delta_combine(base, target, -1)


def apply_delta(base: Any, delta: Any) -> Any:
    """target = base + delta."""
    return _delta_combine(base, delta, +1)


def consolidate(params: Any, dtype=None) -> Any:
    """The tree on the CPU: every tensor (a packed leaf's too) moved to
    host memory, dense leaves cast to ``dtype`` where given."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, PackedMXOutlier):
            return dataclasses.replace(
                x, inlier=conv(x.inlier), out_codes=x.out_codes.cpu(),
                out_pos=x.out_pos.cpu(), out_scale_exp=x.out_scale_exp.cpu())
        if isinstance(x, _PACKED_TYPES):
            return dataclasses.replace(x, **{
                f.name: getattr(x, f.name).cpu()
                for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)})
        x = x.detach().cpu()
        return x.to(dtype) if dtype is not None else x

    return conv(params)
