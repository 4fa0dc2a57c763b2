"""A tiny Llama in each outlier transport, port against JAX on the same
weights: ``pack_params`` (compact NB from RTN decisions at budget 2, the
side-band at budget 4, and the default emi8m stream) and
``fuse_projections`` give bit-identical leaves in both packages; the port's
model, on leaves carried across by ``params_from_jax``, gives the JAX
model's logits (``use_pallas=False``, as the JAX tests run it) and the same
greedy tokens over 32 steps.

Tolerance: float32 logits within 1e-4 of max |logit|, as
tests/test_torch_llama.py (XLA and torch differ in reduction order and in
the last ulp of pow/sin/cos); greedy tokens identical.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.eval.generate import generate as j_generate
from microscopiq_tpu.models import LlamaConfig as JConfig
from microscopiq_tpu.models import LlamaForCausalLM as JModel
from microscopiq_tpu.nn import fuse_projections as j_fuse
from microscopiq_tpu.nn.mapping import find_linear_params as j_find
from microscopiq_tpu.nn.mapping import pack_params as j_pack_params
from microscopiq_tpu.ops.outlier import (
    quantize_mx_outlier_hessian_decisions as j_decisions)
from microscopiq_tpu.specs import finalize_mx_specs as j_finalize
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval.generate import generate
from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from microscopiq_tpu_torch.nn import (find_linear_params, fuse_projections,
                                      pack_params)
from microscopiq_tpu_torch.ops import outlier as tol
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.specs import finalize_mx_specs

SPECS = {"w_elem_format": "int2", "w_outlier_elem_format": "fp4_e2m1",
         "scale_bits": 8, "block_size": 16}
# transport -> (pack_params keywords, fused projections)
ARMS = {"compact": (dict(outlier_transport="compact", outlier_budget=2),
                    True),
        "sideband": (dict(outlier_transport="sideband", outlier_budget=4),
                     False),
        "emi8m": (dict(outlier_budget=4), True)}
LEAF = {"compact": tpk.PackedOutlierNB, "sideband": tpk.PackedMXOutlier,
        "emi8m": tpk.PackedMX}


def numpy_tree(seed=0):
    """Unfused flax-named weights of LlamaConfig.tiny: kernels N(0, 1/K)
    with 3% of their elements scaled by 10 (outlier mass)."""
    cfg = JConfig.tiny()
    rng = np.random.default_rng(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def k(shape):
        w = rng.standard_normal(shape) / np.sqrt(shape[0])
        w[rng.random(shape) < 0.03] *= 10.0
        return w.astype(np.float32)

    def scale():
        return (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    m = {"embed_tokens": rng.standard_normal((cfg.vocab_size, D)
                                             ).astype(np.float32)}
    for i in range(cfg.num_hidden_layers):
        m[f"layers_{i}"] = {
            "self_attn": {"q_proj": {"kernel": k((D, H * hd))},
                          "k_proj": {"kernel": k((D, KVH * hd))},
                          "v_proj": {"kernel": k((D, KVH * hd))},
                          "o_proj": {"kernel": k((H * hd, D))}},
            "mlp": {"gate_proj": {"kernel": k((D, I))},
                    "up_proj": {"kernel": k((D, I))},
                    "down_proj": {"kernel": k((I, D))}},
            "input_layernorm": {"scale": scale()},
            "post_attention_layernorm": {"scale": scale()}}
    m["norm"] = {"scale": scale()}
    return {"model": m, "lm_head": {"kernel": k((D, cfg.vocab_size))}}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def to_numpy(tree):
    """JAX tree -> numpy leaves; packed leaves -> the dicts that
    params_from_jax takes."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {f.name: to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, (str, int, float)):
        return tree
    return np.asarray(tree)


def jax_params(arm, seed=0):
    """The JAX package's packed (and, where the arm fuses, fused) tree."""
    tree = _map(numpy_tree(seed), jnp.asarray)
    kw, fused = ARMS[arm]
    dec = None
    if arm == "compact":
        dec = {}
        for path, w in j_find(tree, skip=()).items():
            _, _, d = j_decisions(w.T, 8, 8, "int2", "fp4_e2m1", "max", 2.0,
                                  [0], 16, max_outliers_per_block=2)
            dec[path] = {**d, "block_size": 16}
    packed = j_pack_params(tree, j_finalize(SPECS), skip=(), decisions=dec,
                           **kw)
    return j_fuse(packed) if fused else packed


def port_params(arm, seed=0):
    """The port's own packed tree from the same numpy weights."""
    tree = _map(numpy_tree(seed), lambda a: torch.from_numpy(np.array(a)))
    kw, fused = ARMS[arm]
    dec = None
    if arm == "compact":
        dec = {}
        for path, w in find_linear_params(tree, skip=()).items():
            _, _, d = tol.quantize_mx_outlier_hessian_decisions(
                w.T.contiguous(), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0],
                16, max_outliers_per_block=2)
            dec[path] = {**d, "block_size": 16}
    packed = pack_params(tree, finalize_mx_specs(SPECS), skip=(),
                         decisions=dec, **kw)
    return fuse_projections(packed) if fused else packed


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _raw(t):
    return t.contiguous().view(torch.uint8) if t.element_size() == 1 else t


def _same_leaf(a, b, where=""):
    """Bit-identical tensors, recursively through packed dataclasses."""
    assert type(a) is type(b), where
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(_raw(a), _raw(b)), where
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same_leaf(getattr(a, f.name), getattr(b, f.name),
                       f"{where}.{f.name}")
    else:
        assert a == b, where


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_pack_params_and_fuse_match_jax(arm):
    mine = port_params(arm)
    theirs = params_from_jax(to_numpy(jax_params(arm)), device="cpu")
    a, b = dict(_leaves(mine)), dict(_leaves(theirs))
    assert a.keys() == b.keys()
    kernels = 0
    for path in a:
        _same_leaf(a[path], b[path], "/".join(path))
        if path[-1] == "kernel":
            assert isinstance(a[path], LEAF[arm]), path
            kernels += 1
    # fused arms hold qkv and gate_up; the side-band keeps 7 per layer
    assert kernels == 2 * (4 if ARMS[arm][1] else 7) + 1
    if arm == "emi8m":
        assert all(a[p].transport == "emi8m" for p in a if p[-1] == "kernel")
    if arm == "compact":
        assert a[("lm_head", "kernel")].bits_per_element == 4.0


def test_pack_params_dense_transports_and_skip():
    """Without an outlier budget the GEMM transports pack as in JAX; the
    lm_head is skipped by default."""
    tree = _map(numpy_tree(1), lambda a: torch.from_numpy(np.array(a)))
    jtree = _map(numpy_tree(1), jnp.asarray)
    for fmt, transport in (("fp6_e3m2", "emi8"), ("int4", "sb4"),
                           ("int8", "native")):
        spec = {"w_elem_format": fmt, "scale_bits": 8, "block_size": 32}
        mine = pack_params(tree, finalize_mx_specs(spec))
        theirs = params_from_jax(to_numpy(j_pack_params(
            jtree, j_finalize(spec))), device="cpu")
        assert isinstance(mine["lm_head"]["kernel"], torch.Tensor)
        q = mine["model"]["layers_0"]["self_attn"]["q_proj"]["kernel"]
        assert q.transport == transport and q.codes.ndim == 3
        want = dict(_leaves(theirs))
        for path, leaf in _leaves(mine):
            _same_leaf(leaf, want[path], "/".join(path))


def model_pair(arm, seed=0):
    """(JAX model, JAX params, port model) on identical packed weights."""
    fused = ARMS[arm][1]
    params = jax_params(arm, seed)
    jm = JModel(JConfig.tiny(fused_projections=fused), use_pallas=False)
    port = LlamaForCausalLM(LlamaConfig.tiny(fused_projections=fused),
                            device="cpu").load_params(
        params_from_jax(to_numpy(params), device="cpu"))
    return jm, {"params": params}, port


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_logits_and_32_greedy_tokens_match_jax(arm):
    jm, jp, tm = model_pair(arm)
    ids = np.random.default_rng(1).integers(0, 256, (2, 12))
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(ids)), np.float32)
    with torch.inference_mode():
        got = tm(torch.as_tensor(ids))
    assert _rel(got.numpy(), want) < 1e-4
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (5, 9, 7)]
    np.testing.assert_array_equal(
        generate(tm, prompts, 32),
        j_generate(jm, jp, prompts, 32, cache_kind="dense"))


def test_outlier_formats_go_to_their_wrapper_at_any_token_count(
        monkeypatch):
    """With use_kernels the outlier formats go to their kernel wrapper at
    every token count (on the CPU: its twin; on a card the wrapper picks the
    GEMV or the GEMM); without, to the plain twin."""
    # the dispatch of every packed linear: nn.linear.packed_matmul
    linear = importlib.import_module("microscopiq_tpu_torch.nn.linear")

    seen = []
    for name in ("dequant_matmul_nb", "dequant_matmul_nb_reference",
                 "dequant_matmul_outlier",
                 "dequant_matmul_outlier_reference"):
        fn = getattr(linear, name)
        monkeypatch.setattr(linear, name, lambda *a, _f=fn, _n=name, **k: (
            seen.append(_n), _f(*a, **k))[1])
    for arm in ("compact", "sideband"):
        _, _, tm = model_pair(arm)
        lin = tm.lm_head
        for M in (1, 255, 256, 300):
            seen.clear()
            lin(torch.zeros(M, 64))
            assert seen == [("dequant_matmul_nb" if arm == "compact"
                             else "dequant_matmul_outlier")], (arm, M, seen)
        lin.use_kernels = False
        seen.clear()
        lin(torch.zeros(2, 64))
        assert seen[0].endswith("_reference")
