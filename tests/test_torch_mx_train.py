"""The fake-quant training path of the port against the JAX package:

- the tiny Llama and the tiny OPT with ``mx_specs`` (fp6_e3m2 weights and
  activations, block 32, bfloat16 containers; ``quantize_backprop`` on and
  off), and the tiny OPT under the reference's activation-quantization
  config (``scripts/parity_ref.py``'s ``ACT_CFG``: fp4 weights, int4
  activations, block 128, with ``a_axes=1`` and ``mx_linear_only``) give
  the same logits (``rtol=1e-5, atol=1e-6``) and the same gradients of the
  next-token loss for every weight (``rtol=1e-4, atol=1e-5``), the
  tolerances of ``tests/test_nn_layers.py::test_conv_backward_golden``.
  OPT's key-projection bias is the exception: its exact gradient is zero
  (a bias added to every key shifts each query's logits by one constant,
  which the softmax cancels), so both packages' values are the rounding
  noise of a sum that cancels, and they are held to be noise (below 1e-3
  of the largest bias gradient), not to each other. Under
  ``quantize_backprop`` the gradients are rounded to bfloat16 at every
  layer, and XLA and torch sum the norms' backward in other orders: a
  float32 ulp at a rounding boundary flips one bfloat16 rounding, which
  moves the gradient of that token's hidden vector by one bfloat16 step
  (ROADMAP queue 3). Such elements are counted, held within one bfloat16
  step (2^-7 relative) and to at most 0.1% of a leaf; every other element
  is held to the tolerance above;
- ``scripts.mx_ffn`` trains 20 steps from one numpy start as
  ``examples/mx_ffn.py``'s step does in JAX: the losses agree within 1e-3
  relative.

One layer a model: each JAX loss-and-gradient is one jit, whose compile
time grows with the layers.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from microscopiq_tpu import nn as jnn
from microscopiq_tpu.models import LlamaConfig as JLlamaConfig
from microscopiq_tpu.models import LlamaForCausalLM as JLlama
from microscopiq_tpu.models import OPTConfig as JOPTConfig
from microscopiq_tpu.models import OPTForCausalLM as JOPT
from microscopiq_tpu.specs import finalize_mx_specs as j_finalize
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                          OPTConfig, OPTForCausalLM)
from microscopiq_tpu_torch.models.llama import trainable_leaves
from microscopiq_tpu_torch.scripts import mx_ffn
from microscopiq_tpu_torch.specs import finalize_mx_specs

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
FP6 = {"a_elem_format": "fp6_e3m2", "w_elem_format": "fp6_e3m2",
       "block_size": 32, "bfloat": 16, "scale_bits": 8}
# scripts/parity_ref.py:92-93, with a_axes=1 as its actquant run sets it
ACT_CFG = dict(w_elem_format="fp4", a_elem_format="int4", block_size=128,
               quantize_backprop=False, a_axes=1)
MODELS = {"llama": (JLlamaConfig, JLlama, LlamaConfig, LlamaForCausalLM),
          "opt": (JOPTConfig, JOPT, OPTConfig, OPTForCausalLM)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(jmodel, seed):
    """The JAX model's parameter tree with every leaf drawn by numpy:
    kernels N(0, 1/K), embeddings N(0, 1/D) (unit-norm token vectors, so
    logits are O(1) and the absolute 1e-6 of FWD is a few float32 ulps of
    them), norm scales 1 + N(0, 0.01), biases N(0, 0.01)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        z = rng.standard_normal(s.shape)
        if name == "kernel":
            z = z / np.sqrt(s.shape[0])
        elif name.startswith("embed"):
            z = z / np.sqrt(s.shape[1])
        elif name == "scale":
            z = 1 + 0.1 * z
        elif name == "bias":
            z = 0.1 * z
        return z.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def run_both(kind, spec_dict, seed=0, mx_linear_only=False, B=2, S=16):
    """(JAX logits, loss, grads), (port logits, loss, leaves' grads, tree)
    of the tiny model with one layer, on seeded weights and tokens."""
    jcfg_cls, jcls, tcfg_cls, tcls = MODELS[kind]
    jspecs, tspecs = j_finalize(spec_dict), finalize_mx_specs(spec_dict)
    extra = {"mx_linear_only": True} if mx_linear_only else {}
    jmodel = jcls(jcfg_cls.tiny(num_hidden_layers=1), mx_specs=jspecs,
                  use_pallas=False, **extra)
    tree = numpy_tree(jmodel, seed)
    ids = np.random.default_rng(seed + 1).integers(0, 256, (B, S))

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids))
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(lp, jnp.asarray(ids)[:, 1:, None], -1)
        return nll.mean(), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree)

    ttree = params_from_jax(tree, device="cpu")
    leaves = trainable_leaves(ttree)
    model = tcls(tcfg_cls.tiny(num_hidden_layers=1), mx_specs=tspecs,
                 device="cpu", **extra).load_params(ttree)
    tlogits = model(torch.as_tensor(ids))
    tloss = F.cross_entropy(tlogits[:, :-1].reshape(-1, 256),
                            torch.as_tensor(ids[:, 1:]).reshape(-1))
    tloss.backward()
    return ((np.asarray(jlogits), float(jloss), jgrads),
            (tlogits.detach().numpy(), float(tloss.detach()), leaves, ttree))


def assert_same(j, t, qbp=False):
    (jlogits, jloss, jgrads), (tlogits, tloss, leaves, ttree) = j, t
    np.testing.assert_allclose(tlogits, jlogits, **FWD)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves_with_path(jgrads)
    tflat = jax.tree_util.tree_leaves_with_path(
        ttree, is_leaf=lambda v: isinstance(v, torch.Tensor))
    assert [p for p, _ in jleaves] == [p for p, _ in tflat]
    bias_max = max([float(np.abs(np.asarray(g)).max())
                    for p, g in jleaves if p[-1].key == "bias"] or [0.0])
    for (path, jg), (_, leaf) in zip(jleaves, tflat):
        assert leaf.grad is not None, path
        if [k.key for k in path[-2:]] == ["k_proj", "bias"]:
            for g in (leaf.grad.numpy(), np.asarray(jg)):
                assert np.abs(g).max() <= 1e-3 * bias_max, path
            continue
        got, want = leaf.grad.numpy(), np.asarray(jg)
        flips = ~np.isclose(got, want, **GRAD)
        if qbp and flips.any():
            name = jax.tree_util.keystr(path)
            assert flips.mean() <= 1e-3, (name, int(flips.sum()))
            np.testing.assert_allclose(got[flips], want[flips], rtol=2 ** -7,
                                       err_msg=name)
            got, want = got[~flips], want[~flips]
        np.testing.assert_allclose(got, want, **GRAD,
                                   err_msg=jax.tree_util.keystr(path))
    assert len(leaves) == len(tflat)


@pytest.mark.parametrize("qbp", [True, False])
def test_tiny_llama_mx_logits_and_grads(qbp):
    assert_same(*run_both("llama", dict(FP6, quantize_backprop=qbp)), qbp)


def test_tiny_opt_mx_logits_and_grads():
    assert_same(*run_both("opt", dict(FP6, quantize_backprop=True), seed=2),
                True)


def test_tiny_opt_actquant_logits_and_grads():
    """The reference's activation-quant experiment: only the linears are
    MX (fp4 weights, int4 activations along the sequence axis in the
    attention projections, along the hidden axis in fc1/fc2)."""
    assert_same(*run_both("opt", ACT_CFG, seed=3, mx_linear_only=True))


def test_fake_quant_models_build_on_every_family():
    """mx_specs reaches every linear of a family but the lm_head, and the
    norms; packed kernels keep their kernels."""
    s = finalize_mx_specs(FP6)
    for cfg in (LlamaConfig.tiny(), LlamaConfig.tiny_mpt(),
                LlamaConfig.tiny(num_local_experts=2)):
        m = LlamaForCausalLM(cfg, mx_specs=s, device="cpu")
        lin = [mod for n, mod in m.named_modules()
               if type(mod).__name__ == "QLinear"]
        assert all(mod.mx_specs is s for mod in lin if mod is not m.lm_head)
        if m.lm_head is not None:
            assert m.lm_head.mx_specs is None
        assert m.model.norm.mx_specs is s
    o = OPTForCausalLM(OPTConfig.tiny(), mx_specs=finalize_mx_specs(
        ACT_CFG), mx_linear_only=True, device="cpu")
    layer = o.layers[0]
    assert layer.self_attn.q_proj.mx_specs.a_axes == 1
    assert layer.fc1.mx_specs.a_axes is None
    assert layer.self_attn_layer_norm.mx_specs is None
    assert o.final_layer_norm.mx_specs is None


def test_mx_ffn_matches_jax_training():
    """20 SGD steps of the port's script against examples/mx_ffn.py's
    jitted JAX step, from one numpy start (D = 32, 64 rows)."""
    start = mx_ffn.numpy_start(dim=32, seed=5, rows=64)
    d = dict(w_elem_format="fp6_e3m2", a_elem_format="fp6_e3m2",
             scale_bits=4, block_size=32, bfloat=16, quantize_backprop=False)
    js = j_finalize(d)
    assert mx_ffn.default_specs() == finalize_mx_specs(d)

    def forward(p, x):
        h = jnn.gelu(jnn.linear(x, p["w1"].T, None, js), js)
        return x + jnn.linear(h, p["w2"].T, None, js)

    def loss_fn(p, x, y):
        return jnp.mean((forward(p, x) - y) ** 2)

    @jax.jit
    def step(p, x, y):
        loss, g = jax.value_and_grad(loss_fn)(p, x, y)
        return jax.tree_util.tree_map(lambda w, gw: w - 0.1 * gw, p, g), loss

    p = {"w1": jnp.asarray(start[0]), "w2": jnp.asarray(start[1])}
    x = jnp.asarray(start[2])
    jl = []
    for _ in range(20):
        p, loss = step(p, x, jnp.sin(x))
        jl.append(float(loss))
    tl = mx_ffn.train(start, 20, device="cpu")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


def test_mx_ffn_script_runs_on_the_cpu(capsys):
    assert mx_ffn.main(["--device", "cpu", "--steps", "3", "--dim", "32"]
                       ) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step    0  mse ")
    assert out[-1].startswith("final mse (MX fp6_e3m2): ")
    assert mx_ffn.main(["--device", "cpu", "--steps", "2", "--dim", "32",
                        "--w_elem_format", "int8", "--a_elem_format",
                        "int8", "--block_size", "32", "--scale_bits",
                        "8"]) == 0
    assert "MX int8" in capsys.readouterr().out
