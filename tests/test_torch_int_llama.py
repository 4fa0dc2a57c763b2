"""A tiny Llama with MX integer weights, port against JAX on the same
weights: ``pack_params`` with the default GEMM transports (sb4 for int4, the
int8 container for int8) and with a ``gemm_transport`` override (sb2, pf4,
pf6) gives bit-identical leaves in both packages, ``fuse_projections``
concatenates them, ``params_from_jax`` carries them, and the port's model
gives the JAX model's logits (``use_pallas=False``, as the JAX tests run
it) and the same greedy tokens over 32 steps.

Tolerance: float32 logits within 1e-4 of max |logit|, as
tests/test_torch_llama.py; greedy tokens identical.
"""

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
from microscopiq_tpu.nn.mapping import pack_params as j_pack_params
from microscopiq_tpu.specs import finalize_mx_specs as j_finalize
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval.generate import generate
from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from microscopiq_tpu_torch.nn import fuse_projections, pack_params
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.specs import finalize_mx_specs
from test_torch_outlier_llama import (_leaves, _map, _rel, _same_leaf,
                                      numpy_tree, to_numpy)

# (format, gemm_transport override or None, the transport it packs to)
PACKINGS = [("int4", None, "sb4"), ("int8", None, "native"),
            ("int2", "sb2", "sb2"), ("fp4_e2m1", "pf4", "pf4"),
            ("fp6_e3m2", "pf6", "pf6")]


def _specs(fmt):
    return {"w_elem_format": fmt, "scale_bits": 8, "block_size": 32}


def jax_params(fmt, gemm_transport=None, seed=0):
    tree = _map(numpy_tree(seed), jnp.asarray)
    return j_fuse(j_pack_params(tree, j_finalize(_specs(fmt)), skip=(),
                                gemm_transport=gemm_transport))


def port_params(fmt, gemm_transport=None, seed=0):
    tree = _map(numpy_tree(seed), lambda a: torch.from_numpy(np.array(a)))
    return fuse_projections(pack_params(tree, finalize_mx_specs(_specs(fmt)),
                                        skip=(),
                                        gemm_transport=gemm_transport))


@pytest.mark.parametrize("fmt,override,transport", PACKINGS)
def test_pack_params_fused_match_jax(fmt, override, transport):
    mine = port_params(fmt, override)
    theirs = params_from_jax(to_numpy(jax_params(fmt, override)),
                             device="cpu")
    a, b = dict(_leaves(mine)), dict(_leaves(theirs))
    assert a.keys() == b.keys()
    kernels = [p for p in a if p[-1] == "kernel"]
    assert len(kernels) == 2 * 4 + 1        # qkv, o, gate_up, down; lm_head
    for path in a:
        _same_leaf(a[path], b[path], "/".join(path))
    for p in kernels:
        w = a[p]
        assert isinstance(w, tpk.PackedMX) and w.transport == transport
        assert w.codes.ndim == 3 and w.codes.shape[1] == (
            tpk.transport_rows_per_block(transport, 32))
    # the fused qkv holds q, k and v side by side along N
    qkv = a[("model", "layers_0", "self_attn", "qkv_proj", "kernel")]
    assert qkv.codes.shape[-1] == 64 + 2 * 32


def model_pair(fmt, seed=0):
    """(JAX model, JAX params, port model) on identical packed weights."""
    params = jax_params(fmt, seed=seed)
    jm = JModel(JConfig.tiny(fused_projections=True), use_pallas=False)
    port = LlamaForCausalLM(LlamaConfig.tiny(fused_projections=True),
                            device="cpu").load_params(
        params_from_jax(to_numpy(params), device="cpu"))
    return jm, {"params": params}, port


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_logits_and_32_greedy_tokens_match_jax(fmt):
    jm, jp, tm = model_pair(fmt)
    assert tm.lm_head.kernel.transport == {"int4": "sb4",
                                           "int8": "native"}[fmt]
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


def test_int_weights_go_to_dequant_matmul_at_any_token_count(monkeypatch):
    """A PackedMX of any transport goes to the kernel wrapper, which picks
    the GEMV or the GEMM by token count (on the CPU: the twin)."""
    # the dispatch of every packed linear: nn.linear.packed_matmul
    linear = importlib.import_module("microscopiq_tpu_torch.nn.linear")

    seen = []
    fn = linear.dequant_matmul
    monkeypatch.setattr(linear, "dequant_matmul", lambda *a, **k: (
        seen.append(a[1].transport), fn(*a, **k))[1])
    _, _, tm = model_pair("int4")
    for M in (1, 64, 65, 300):
        seen.clear()
        tm.lm_head(torch.zeros(M, 64))
        assert seen == ["sb4"]
