"""Layer-sequential GPTQ calibration over a whole model.

Counterpart of ``microscopiq_tpu/quant/calibrate.py``: decoder layers are
quantized one at a time; within a layer the sublayer groups go in
execution order (true sequential: [q, k, v] -> [o] -> [gate, up] ->
[down]), each group's inputs captured after the groups before it were
quantized; the hidden states then pass through the quantized layer to the
next. A group's inputs are captured by forward hooks on its ``QLinear``
modules (JAX sows them with flax ``capture_intermediates``), and each hook
adds its batch to the linear's Hessian at once.

The canonical quantizer is the reference's: int2 inliers, fp4_e2m1
outliers, scale bits 8/8, block 16 on axis 0, std_dev 2.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..models.llama import DecoderLayer, causal_mask, install_tree
from ..models.opt import OPTLayer
from .gptq import GPTQ, _no_timer
from .quantizer import MXQuantizer

# sublayer groups in execution order (true sequential)
LLAMA_GROUPS = [
    ["self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj"],
    ["self_attn/o_proj"],
    ["mlp/gate_proj", "mlp/up_proj"],
    ["mlp/down_proj"],
]
OPT_GROUPS = [
    ["self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj"],
    ["self_attn/out_proj"],
    ["fc1"],
    ["fc2"],
]


def _get(tree, path: str):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def _path_exists(tree, path: str) -> bool:
    node = tree
    for k in path.split("/"):
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


def _copy_dicts(tree):
    """The tree's dicts copied, its leaves shared."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _module(root: torch.nn.Module, path: str) -> torch.nn.Module:
    for k in path.split("/"):
        root = getattr(root, k)
    return root


@torch.no_grad()
def sequential_gptq(layer_module: torch.nn.Module, layer_params: List[dict],
                    hidden: torch.Tensor,
                    layer_extra_inputs: Callable[[int, torch.Tensor], tuple],
                    quantizer: MXQuantizer,
                    groups: Sequence[Sequence[str]] = LLAMA_GROUPS,
                    nsamples_batch: int = 8, blocksize: int = 128,
                    percdamp: float = 0.01, actorder: bool = False,
                    groupsize: int = -1, static_groups: bool = False,
                    mode: str = "mx_prune", verbose: bool = True,
                    collect_decisions: bool = False, timer=None,
                    on_quantized=None):
    """Run GPTQ layer by layer.

    layer_module: one decoder layer, called as ``(x, *extra)``, into which
        each layer's weights are installed in turn.
    layer_params: per-layer weight subtrees (copies are returned, with the
        quantized kernels).
    hidden: (nsamples, seqlen, d) hidden states entering layer 0.
    layer_extra_inputs: (i, hidden) -> the layer's extra arguments.
    timer: a :class:`~.gptq.StageTimer` for the seconds of input capture
        (``capture``, forward passes with their hooks), Hessian updates
        (``hessian``, inside the hooks), Cholesky, column loop, graph
        capture and the pass through the quantized layer (``propagate``).
    on_quantized: called as (layer, path, GPTQ, Q) after each linear's
        ``fasterquant``, before its Hessian is freed.
    Returns (layer trees, hidden states after the last layer, per-layer
    decision maps keyed by sublayer path).
    """
    timer = timer or _no_timer
    dev = hidden.device
    out_params, out_decisions = [], []
    x = hidden
    for i, tree in enumerate(layer_params):
        t0 = time.time()
        params_i = _copy_dicts(tree)
        install_tree(layer_module, params_i, dev)
        extra = layer_extra_inputs(i, x)
        dec_i: Dict[str, dict] = {}
        for group in groups:
            present = [p for p in group if _path_exists(params_i, p)]
            if not present:
                continue
            gptqs: Dict[str, GPTQ] = {}
            hooks = []
            for p in present:
                g = GPTQ(_get(params_i, p)["kernel"].T, mode=mode)
                g.quantizer = quantizer
                gptqs[p] = g

                def hook(mod, inp, out, g=g):
                    with timer("hessian"):
                        g.add_batch(inp[0].reshape(-1, inp[0].shape[-1]))

                hooks.append(_module(layer_module, p).register_forward_hook(
                    hook))
            try:
                with timer("capture"):
                    for s0 in range(0, x.shape[0], nsamples_batch):
                        layer_module(x[s0:s0 + nsamples_batch], *extra)
            finally:
                for h in hooks:
                    h.remove()
            for p in present:
                Q, _ = gptqs[p].fasterquant(
                    blocksize=blocksize, percdamp=percdamp,
                    actorder=actorder, groupsize=groupsize,
                    static_groups=static_groups,
                    collect_decisions=collect_decisions, timer=timer)
                if on_quantized is not None:
                    on_quantized(i, p, gptqs[p], Q)
                kernel = Q.T.contiguous()          # back to (in, out)
                _get(params_i, p)["kernel"] = kernel
                _module(layer_module, p).kernel = kernel
                if collect_decisions:
                    dec_i[p] = gptqs[p].decisions
                gptqs[p].free()
        with timer("propagate"):
            x = torch.cat([layer_module(x[s0:s0 + nsamples_batch], *extra)
                           for s0 in range(0, x.shape[0], nsamples_batch)])
        out_params.append(params_i)
        out_decisions.append(dec_i)
        if verbose:
            print(f"layer {i}: {time.time() - t0:.1f}s")
    return out_params, x, out_decisions


@torch.no_grad()
def gptq_quantize_model(kind: str, cfg, params, calib_ids: torch.Tensor,
                        quantizer: Optional[MXQuantizer] = None,
                        mode: str = "mx_prune", blocksize: int = 128,
                        percdamp: float = 0.01, actorder: bool = False,
                        groupsize: int = -1, static_groups: bool = False,
                        nsamples_batch: int = 8, verbose: bool = True,
                        groups: Optional[Sequence[Sequence[str]]] = None,
                        collect_decisions: bool = False, timer=None,
                        on_quantized=None):
    """GPTQ-quantize every decoder layer of a ``"llama"`` or ``"opt"``
    model.

    params: the model's weight tree (``{"params": ...}``) with dense
        kernels, on the device the calibration runs on.
    calib_ids: (nsamples, seqlen) token crops on that device.
    groups: the sublayer order; default the model's true-sequential groups
        (one group with every path captures all inputs in one pass, as the
        reference's OPT driver does).
    timer, on_quantized: as :func:`sequential_gptq` takes them.
    Returns a new weight tree with the quantized kernels, and with
    ``collect_decisions`` also the decisions keyed by the full path of each
    kernel leaf, as ``nn.pack_params`` walks the tree.
    """
    if quantizer is None:
        quantizer = MXQuantizer()
        quantizer.configure(8, 8, "int2", "fp4_e2m1", std_dev=2, axes=[0],
                            block_size=16)
    p = _copy_dicts(params["params"])
    n, S = calib_ids.shape
    dev = calib_ids.device
    positions = torch.arange(S, device=dev)[None, :]
    mask = causal_mask(S, positions)
    if kind == "llama":
        tree = p["model"]
        hidden = tree["embed_tokens"][calib_ids]
        layer_module = DecoderLayer(cfg)
        extra_fn = lambda i, x: (positions, mask, None, i)  # noqa: E731
        groups = groups or LLAMA_GROUPS
    elif kind == "opt":
        tree = p
        hidden = (tree["embed_tokens"][calib_ids]
                  + tree["embed_positions"][positions + 2])
        layer_module = OPTLayer(cfg)
        extra_fn = lambda i, x: (mask, None, i, positions)  # noqa: E731
        groups = groups or OPT_GROUPS
    else:
        raise ValueError(kind)
    layer_module.to(dev)

    layers = [tree[f"layers_{i}"] for i in range(cfg.num_hidden_layers)]
    new_layers, _, layer_decisions = sequential_gptq(
        layer_module, layers, hidden, extra_fn, quantizer, groups=groups,
        nsamples_batch=nsamples_batch, blocksize=blocksize,
        percdamp=percdamp, actorder=actorder, groupsize=groupsize,
        static_groups=static_groups, mode=mode, verbose=verbose,
        collect_decisions=collect_decisions, timer=timer,
        on_quantized=on_quantized)
    for i, lp in enumerate(new_layers):
        tree[f"layers_{i}"] = lp
    if collect_decisions:
        prefix = ("model",) if kind == "llama" else ()
        decisions = {
            prefix + (f"layers_{i}",) + tuple(path.split("/")) + ("kernel",):
                dec
            for i, dec_i in enumerate(layer_decisions)
            for path, dec in dec_i.items()}
        return {"params": p}, decisions
    return {"params": p}
