"""Device mesh and sharding rules for tensor- and data-parallel serving.

Counterpart of ``microscopiq_tpu/parallel/mesh.py``. A :class:`Mesh` is a
``(data, model)`` grid of ranks; its axes' process groups (and a torch
``DeviceMesh`` with the same dims, :meth:`Mesh.device_mesh`) exist once a
process group does. The rules are JAX's (Megatron-style TP over the
``model`` axis) on the same flax names, which the port's weight trees keep:

* q/k/v (fused ``qkv_proj``), gate/up (fused ``gate_up_proj``), ``fc1`` and
  the router ``gate``: output features (column-parallel);
* ``o_proj``/``out_proj``/``down_proj``/``fc2``: input features
  (row-parallel; the model sums the partial products);
* ``lm_head``: vocabulary (column-parallel); embeddings, norm scales and
  biases replicated;
* packed leaves congruently: ``PackedMX`` in the serving layout (nb, rows,
  N) splits K on ``nb`` and N on the last axis; the side-band format its
  inlier codes, slots and exponents alike; the compact NB transport,
  stored transposed (N, K), only where the sub-byte rows and the blocks
  divide (JAX's ``fits``).

An axis that does not divide is replicated (JAX does this for dense
leaves and NB; the port for every packed leaf too, where a device_put in
JAX would fail), and the model then multiplies the whole weight (a
row-parallel layer gathers its input and skips the sum).

Where JAX lays shardings onto a global array and XLA moves data as the
program needs, explicit TP needs each rank's block: :func:`shard_params`
returns a rank's local shards as plain tensors, handed to the single-card
kernels. A fused projection's column split alone would give one rank all
of q (or all of gate): its columns are first put in rank-major order,
``[q_0 | k_0 | v_0 | q_1 | k_1 | v_1 | ...]`` (:func:`fused_column_order`),
so that a contiguous split gives each rank ``[q_r | k_r | v_r]``. A packed
weight's columns are independent (N is the lane axis, blocks run along K),
so the same permutation of its codes and exponents is exact.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.packing import PackedMX, PackedMXOutlier, PackedOutlierNB

_PACKED = (PackedMX, PackedMXOutlier, PackedOutlierNB)
NB_ROWS = 16            # the compact transport's N block (4 byte rows)


class Mesh:
    """A ``(data, model)`` grid of ranks, row-major: rank = d * model + m.

    ``shape`` is ``{"data": d, "model": m}`` as a JAX mesh's. In one
    process the mesh may be larger than the world (for the sharding rules
    alone); its groups are then None and every collective a no-op. With a
    process group of ``data * model`` ranks, :meth:`group` gives this
    rank's group along an axis (made once, by every rank together)."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int):
        self.shape = {"data": int(data), "model": int(model)}
        self.ranks = np.arange(data * model).reshape(data, model)
        self._groups: Optional[Dict[str, object]] = None

    @property
    def size(self) -> int:
        return self.ranks.size

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{"data": row, "model": column} of ``rank`` (this process's)."""
        r = _rank() if rank is None else rank
        d, m = divmod(r, self.shape["model"])
        return {"data": d, "model": m}

    def group(self, axis: str):
        """This rank's process group along ``axis``; None without a process
        group of the mesh's size."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return None
        if dist.get_world_size() != self.size:
            raise ValueError(f"mesh of {self.size} ranks in a world of "
                             f"{dist.get_world_size()}")
        if self._groups is None:
            mine = {}
            me = dist.get_rank()
            for ax, lines in (("model", self.ranks),
                              ("data", self.ranks.T)):
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if me in line:
                        mine[ax] = g
            self._groups = mine
        return self._groups[axis]

    def device_mesh(self, device_type: str = "cuda"):
        """The same grid as a torch ``DeviceMesh`` with dims ("data",
        "model") (for DTensor users; the port's TP model uses
        :meth:`group`)."""
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(device_type, self.ranks.tolist(),
                          mesh_dim_names=self.axis_names)

    def __repr__(self):
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']})"


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if (dist.is_available()
                               and dist.is_initialized()) else 0


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over ``n_devices`` ranks (default: the world
    size). Defaults as JAX's: all on ``model`` up to 8, else model 8."""
    n = n_devices or _world()
    if data is None and model is None:
        if n <= 8:
            data, model = 1, n
        else:
            model = 8
            data = n // model
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"data {data} x model {model} != {n}")
    return Mesh(data, model)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


# path-regex -> (K axis, N axis) of a kernel stored (in, out)
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r".*(q_proj|k_proj|v_proj|qkv_proj|gate_proj|up_proj|gate_up_proj"
     r"|fc1|gate)/kernel$", (None, "model")),
    (r".*(o_proj|out_proj|down_proj|fc2)/kernel$", ("model", None)),
    (r".*(embed_tokens|embed_positions)$", (None, None)),
    (r".*lm_head/kernel$", (None, "model")),
    (r".*(scale|bias)$", (None,)),
)


def spec_for_path(path: str) -> Tuple:
    for pat, spec in _RULES:
        if re.match(pat, path):
            return spec
    return ()


def _fits(axis, mesh: Mesh, *dims) -> Optional[str]:
    if axis is None:
        return None
    sz = mesh.shape.get(axis, 1)
    return axis if all(d % sz == 0 for d in dims) else None


def packed_kn(leaf) -> Tuple[int, int]:
    """The logical (K, N) of a packed kernel."""
    if isinstance(leaf, PackedOutlierNB):
        return leaf.orig_k, leaf.orig_n
    inl = leaf.inlier if isinstance(leaf, PackedMXOutlier) else leaf
    return inl.orig_dim, inl.codes.shape[-1]


def packed_axes(leaf, kernel_spec: Tuple, mesh: Mesh):
    """(K axis, N axis) a packed kernel takes: the rule's, dropped where
    the split would not fall on the layout's units (MX blocks along K; NB's
    sub-byte rows and blocks along N)."""
    parts = tuple(kernel_spec) + (None,) * (2 - len(kernel_spec))
    k_ax, n_ax = parts[0], parts[1]
    if isinstance(leaf, PackedOutlierNB):
        return (_fits(k_ax, mesh, leaf.codes.shape[1]),
                _fits(n_ax, mesh, leaf.codes.shape[0],
                      leaf.scale_exp.shape[0]))
    inl = leaf.inlier if isinstance(leaf, PackedMXOutlier) else leaf
    nb = inl.scale_exp.shape[0]
    K, N = packed_kn(leaf)
    return (_fits(k_ax, mesh, nb) if K == nb * inl.block_size else None,
            _fits(n_ax, mesh, N))


def _packed_specs(leaf, k_ax, n_ax) -> dict:
    """Per-array specs of a packed leaf, as JAX's ``_packed_sharding``."""
    if isinstance(leaf, PackedOutlierNB):
        return {"codes": (n_ax, k_ax), "scale_exp": (n_ax, k_ax),
                "out_byte": (None, n_ax, k_ax),
                "out_scale_exp": (n_ax, k_ax)}
    if isinstance(leaf, PackedMX):
        if leaf.codes.ndim == 3:
            return {"codes": (k_ax, None, n_ax),
                    "scale_exp": ((k_ax, None, n_ax)
                                  if leaf.scale_exp.ndim == 3
                                  else (k_ax, n_ax))}
        return {"codes": (k_ax, n_ax), "scale_exp": (k_ax, n_ax)}
    return {"inlier": _packed_specs(leaf.inlier, k_ax, n_ax),
            "out_codes": (k_ax, n_ax, None), "out_pos": (k_ax, n_ax, None),
            "out_scale_exp": (k_ax, n_ax)}


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(params, mesh: Mesh):
    """The spec tree of a (possibly packed) weight tree: a tuple of axis
    names (or None) per dense leaf, one per dimension; a dict of such
    tuples per packed leaf, by field."""

    def visit(path, leaf):
        if isinstance(leaf, _PACKED):
            spec = spec_for_path(path if path.endswith("kernel")
                                 else path + "/kernel")
            return _packed_specs(leaf, *packed_axes(leaf, spec, mesh))
        spec = spec_for_path(path)
        ndim = leaf.ndim
        parts = tuple(spec) + (None,) * (ndim - len(spec))
        return tuple(
            a if a is None or leaf.shape[d] % mesh.shape[a] == 0 else None
            for d, a in enumerate(parts[:ndim]))

    return _walk(params.get("params", params), visit)


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------
def fused_sections(path: str, N: int, cfg=None) -> Optional[List[int]]:
    """Column sections of a fused kernel: [H*hd, KVH*hd, KVH*hd] for
    ``qkv_proj`` (``cfg`` required), [I, I] for ``gate_up_proj``; None for
    any other kernel."""
    if re.match(r".*gate_up_proj/kernel$", path):
        return [N // 2, N // 2]
    if re.match(r".*qkv_proj/kernel$", path):
        if cfg is None:
            raise ValueError(f"{path}: a fused qkv_proj needs the model "
                             "config to find its q, k and v columns")
        H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        if N != (H + 2 * KVH) * hd:
            raise ValueError(f"{path}: {N} columns, config gives "
                             f"{(H + 2 * KVH) * hd}")
        return [H * hd, KVH * hd, KVH * hd]
    return None


def fused_column_order(sections: Sequence[int], n_shards: int
                       ) -> torch.Tensor:
    """The column permutation that puts a fused kernel's sections in
    rank-major order: rank r's slice of each section, then rank r + 1's;
    a contiguous split of the permuted columns gives rank r
    ``[sec0_r | sec1_r | ...]``."""
    starts = np.cumsum([0] + list(sections[:-1]))
    order = []
    for r in range(n_shards):
        for s0, n in zip(starts, sections):
            if n % n_shards:
                raise ValueError(f"section of {n} columns does not split "
                                 f"{n_shards} ways")
            w = n // n_shards
            order.extend(range(s0 + r * w, s0 + (r + 1) * w))
    return torch.as_tensor(order, dtype=torch.int64)


def _rank_ranges(N: int, sections: Optional[Sequence[int]], r: int,
                 m: int) -> List[Tuple[int, int]]:
    """Rank r's column ranges: its slice of each section (the permuted
    order's contiguous split)."""
    if sections is None:
        return [(r * N // m, (r + 1) * N // m)]
    out, s0 = [], 0
    for n in sections:
        w = n // m
        out.append((s0 + r * w, s0 + (r + 1) * w))
        s0 += n
    return out


def _cat(parts, dim):
    return torch.cat(parts, dim=dim).contiguous() if len(parts) > 1 \
        else parts[0].contiguous().clone()


def take_columns(leaf, ranges):
    """The kernel's columns in ``ranges`` (logical N), concatenated."""
    if isinstance(leaf, torch.Tensor):
        return _cat([leaf[..., a:b] for a, b in ranges], -1)
    if isinstance(leaf, PackedMX):
        return dataclasses.replace(
            leaf, codes=_cat([leaf.codes[..., a:b] for a, b in ranges], -1),
            scale_exp=_cat([leaf.scale_exp[..., a:b] for a, b in ranges],
                           -1))
    if isinstance(leaf, PackedMXOutlier):
        return dataclasses.replace(
            leaf, inlier=take_columns(leaf.inlier, ranges),
            out_codes=_cat([leaf.out_codes[:, a:b] for a, b in ranges], 1),
            out_pos=_cat([leaf.out_pos[:, a:b] for a, b in ranges], 1),
            out_scale_exp=_cat([leaf.out_scale_exp[:, a:b]
                                for a, b in ranges], 1))
    for a, b in ranges:
        if a % NB_ROWS or b % NB_ROWS:
            raise ValueError(f"NB columns {a}:{b} split a block of "
                             f"{NB_ROWS}")
    return dataclasses.replace(
        leaf,
        codes=_cat([leaf.codes[a // 4:b // 4] for a, b in ranges], 0),
        scale_exp=_cat([leaf.scale_exp[a // NB_ROWS:b // NB_ROWS]
                        for a, b in ranges], 0),
        out_byte=_cat([leaf.out_byte[:, a // NB_ROWS:b // NB_ROWS]
                       for a, b in ranges], 1),
        out_scale_exp=_cat([leaf.out_scale_exp[a // NB_ROWS:b // NB_ROWS]
                            for a, b in ranges], 0),
        orig_n=sum(b - a for a, b in ranges))


def take_rows(leaf, a: int, b: int):
    """The kernel's input rows a:b (logical K; on block boundaries)."""
    if isinstance(leaf, torch.Tensor):
        return leaf[a:b].contiguous().clone()
    if isinstance(leaf, PackedOutlierNB):
        return dataclasses.replace(
            leaf, codes=leaf.codes[:, a:b].contiguous(),
            scale_exp=leaf.scale_exp[:, a:b].contiguous(),
            out_byte=leaf.out_byte[:, :, a:b].contiguous(),
            out_scale_exp=leaf.out_scale_exp[:, a:b].contiguous(),
            orig_k=b - a)
    inl = leaf.inlier if isinstance(leaf, PackedMXOutlier) else leaf
    B = inl.block_size
    if a % B or b % B:
        raise ValueError(f"rows {a}:{b} split an MX block of {B}")
    if inl.codes.ndim == 3:
        codes = inl.codes[a // B:b // B]
    else:
        codes = inl.codes[a:b]
    new_inl = dataclasses.replace(
        inl, codes=codes.contiguous().clone(),
        scale_exp=inl.scale_exp[a // B:b // B].contiguous().clone(),
        orig_dim=b - a)
    if isinstance(leaf, PackedMX):
        return new_inl
    return dataclasses.replace(
        leaf, inlier=new_inl,
        out_codes=leaf.out_codes[a // B:b // B].contiguous(),
        out_pos=leaf.out_pos[a // B:b // B].contiguous(),
        out_scale_exp=leaf.out_scale_exp[a // B:b // B].contiguous())


def leaf_axes(path: str, leaf, mesh: Mesh, cfg=None) -> Tuple:
    """(K axis, N axis) that ``shard_params`` splits a kernel on, after the
    fallbacks (a fused kernel's sections must each split too)."""
    spec = spec_for_path(path)
    if isinstance(leaf, _PACKED):
        k_ax, n_ax = packed_axes(leaf, spec, mesh)
        K, N = packed_kn(leaf)
    else:
        parts = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        if leaf.ndim != 2:
            return tuple(
                a if a is None or leaf.shape[d] % mesh.shape[a] == 0
                else None for d, a in enumerate(parts[:leaf.ndim]))
        K, N = leaf.shape
        k_ax = _fits(parts[0], mesh, K)
        n_ax = _fits(parts[1], mesh, N)
    if n_ax is not None:
        secs = fused_sections(path, N, cfg)
        unit = NB_ROWS if isinstance(leaf, PackedOutlierNB) else 1
        if secs is not None and any(s % (mesh.shape[n_ax] * unit)
                                    for s in secs):
            n_ax = None
    return k_ax, n_ax


def shard_params(params, mesh: Mesh, rank: Optional[int] = None, cfg=None):
    """This rank's local shards of a weight tree, as plain tensors and
    packed weights (contiguous copies the kernels take). ``cfg`` (the model
    config) finds a fused ``qkv_proj``'s sections; fused kernels are split
    in the rank-major column order of :func:`fused_column_order`."""
    coords = mesh.coords(rank)
    tree = params.get("params", params)

    def visit(path, leaf):
        if not isinstance(leaf, _PACKED) and leaf.ndim != 2:
            axes = leaf_axes(path, leaf, mesh, cfg)
            out = leaf
            for d, a in enumerate(axes):
                if a is not None:
                    m, r = mesh.shape[a], coords[a]
                    n = leaf.shape[d] // m
                    out = out.narrow(d, r * n, n)
            return out.contiguous().clone() if out is not leaf else leaf
        k_ax, n_ax = leaf_axes(path, leaf, mesh, cfg)
        out = leaf
        if n_ax is not None:
            N = packed_kn(leaf)[1] if isinstance(leaf, _PACKED) \
                else leaf.shape[1]
            out = take_columns(out, _rank_ranges(
                N, fused_sections(path, N, cfg), coords[n_ax],
                mesh.shape[n_ax]))
        if k_ax is not None:
            K = packed_kn(leaf)[0] if isinstance(leaf, _PACKED) \
                else leaf.shape[0]
            m, r = mesh.shape[k_ax], coords[k_ax]
            out = take_rows(out, r * K // m, (r + 1) * K // m)
        return out

    local = _walk(tree, visit)
    return {"params": local} if "params" in params else local


# ---------------------------------------------------------------------------
# KV state
# ---------------------------------------------------------------------------
def kv_state_shardings(state, mesh: Mesh) -> dict:
    """Specs of a KV state's tensors, by field, as JAX's rule: batch
    (dim 1) on ``data`` and dim 2 (the KV heads of the chunked buffers) on
    ``model`` for buffers of 3 or more dims, a 1-D tensor on ``data``,
    where they divide; None for an absent field."""
    out = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        if not isinstance(t, torch.Tensor):
            out[f.name] = None
            continue
        spec = [None] * t.ndim
        if t.ndim >= 3:
            if t.shape[1] % mesh.shape.get("data", 1) == 0:
                spec[1] = "data"
            if t.shape[2] % mesh.shape.get("model", 1) == 0:
                spec[2] = "model"
        elif t.ndim == 1 and t.shape[0] % mesh.shape.get("data", 1) == 0:
            spec[0] = "data"
        out[f.name] = tuple(spec)
    return out


def shard_kv_state(state, mesh: Mesh, rank: Optional[int] = None):
    """This rank's block of a KV state by :func:`kv_state_shardings`."""
    coords = mesh.coords(rank)
    specs = kv_state_shardings(state, mesh)
    kw = {}
    for name, spec in specs.items():
        t = getattr(state, name)
        if spec is None:
            continue
        for d, a in enumerate(spec):
            if a is not None:
                n = t.shape[d] // mesh.shape[a]
                t = t.narrow(d, coords[a] * n, n)
        kw[name] = t.contiguous()
    return dataclasses.replace(state, **kw)
