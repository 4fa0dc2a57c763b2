"""The port's MX layer library (``microscopiq_tpu_torch.nn``) and the
fake-quant ops it calls, against the JAX package on the same numpy inputs:
formats, specs, the quantizers, the straight-through primitives, vector
and SIMD ops, activations, softmax and the linears (the norms, convs, LSTM
and ``mx_op_table``: ``tests/test_torch_mx_conv_rnn.py``).

- The quantizers (``quantize_bfloat``, ``quantize_fp``,
  ``quantize_elemwise_op``, ``quantize_mx_op``, dither fed JAX's
  ``jax.random.uniform`` draws) are bit-exact with JAX run op by op (under
  ``jax.jit`` XLA turns the denormal flush's mask-multiply into a select,
  which maps -0 to +0; op by op, as in the port, -0 stays -0).
- Layer outputs are held at ``rtol=1e-5, atol=1e-6`` and gradients
  (``torch.autograd`` against ``jax.vjp`` with one random cotangent) at
  ``rtol=1e-4, atol=1e-5``, the tolerances of
  ``tests/test_nn_layers.py::test_conv_backward_golden``; every gradient
  with ``quantize_backprop`` on and off.
- ``tests/golden/conv.npz`` (the reference's conv and transposed conv,
  forward and backward) is matched through the port.

The layers' JAX side runs under ``jax.jit`` (one compile a function, not
one an op).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microscopiq_tpu import formats as jformats
from microscopiq_tpu import nn as jnn
from microscopiq_tpu import specs as jspecs
from microscopiq_tpu.ops import elemwise as je
from microscopiq_tpu.ops import mx as jmx
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu_torch import formats as tformats
from microscopiq_tpu_torch import nn as tnn
from microscopiq_tpu_torch import specs as tspecs
from microscopiq_tpu_torch.convert import load_flax_variables, params_from_jax
from microscopiq_tpu_torch.ops import elemwise as te
from microscopiq_tpu_torch.ops import mx as tmx

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BASE = {"a_elem_format": "fp6_e3m2", "w_elem_format": "fp6_e3m2",
        "block_size": 32, "bfloat": 16, "scale_bits": 8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def specs(qbp=True, **kw):
    """(JAX spec, port spec) from one dict."""
    d = dict(BASE, quantize_backprop=qbp, **kw)
    return jspecs.finalize_mx_specs(d), tspecs.finalize_mx_specs(d)


def bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def check(jfn, tfn, arrays, seed=0, grad=True):
    """Forward (FWD) and, with ``grad``, the gradients of every input
    (GRAD) of ``jfn`` / ``tfn`` on the same float32 arrays, with one random
    cotangent. Outputs may be tuples (nested too). The JAX side is one jit
    (forward and vector-Jacobian product together)."""
    jargs = [jnp.asarray(a) for a in arrays]
    shapes = jax.eval_shape(jfn, *jargs)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(seed + 1)
    cots = [rng.standard_normal(j.shape).astype(np.float32) for j in leaves]

    def both(*a):
        if not grad:
            return jfn(*a), ()
        y, vjp = jax.vjp(jfn, *a)
        return y, vjp(jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(c) for c in cots]))

    jy, jg = jax.jit(both)(*jargs)
    targs = [torch.tensor(a, requires_grad=grad) for a in arrays]
    ty = tfn(*targs)
    tleaves = jax.tree_util.tree_leaves(
        ty, is_leaf=lambda v: isinstance(v, torch.Tensor))
    assert len(tleaves) == len(leaves)
    for j, t in zip(jax.tree_util.tree_leaves(jy), tleaves):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **FWD)
    if not grad:
        return
    torch.autograd.backward(tleaves, [torch.as_tensor(c) for c in cots])
    for j, t in zip(jg, targs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **GRAD)


def check_specs(make, arrays, qbps=(True, False, None), seed=0, **kw):
    """:func:`check` of ``make(module, spec)`` under every spec of
    ``qbps`` (``quantize_backprop`` on, off, and None for no spec) at
    once: one tuple output, one jit."""
    pairs = [specs(q, **kw) if q is not None else (None, None)
             for q in qbps]
    check(lambda *a: tuple(make(jnn, js)(*a) for js, _ in pairs),
          lambda *a: tuple(make(tnn, ts)(*a) for _, ts in pairs),
          arrays, seed)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- 1, 2
def test_rounding_mode_and_specs():
    assert ({m.name: int(m) for m in tformats.RoundingMode}
            == {m.name: int(m) for m in jformats.RoundingMode})
    assert (tformats.RoundingMode.string_enums()
            == jformats.RoundingMode.string_enums())
    assert (tspecs.get_default_mx_specs().as_dict()
            == jspecs.get_default_mx_specs().as_dict())
    for qbp in (True, False):
        js, ts = specs(qbp)
        assert (tspecs.get_backwards_mx_specs(ts).as_dict()
                == jspecs.get_backwards_mx_specs(js).as_dict())
        assert ts.get("a_axes") is None and ts.get("bfloat") == 16
        assert ts.as_dict() == js.as_dict()
    # a spec with quantize_backprop off still exists backwards, cleared
    back = tspecs.get_backwards_mx_specs(specs(False)[1])
    assert back is not None and back.block_size == 0 and back.bfloat == 0
    assert tspecs.get_backwards_mx_specs(None) is None


def test_mx_assert_test(monkeypatch):
    tspecs.mx_assert_test(None)                       # off: a no-op
    monkeypatch.setattr(tspecs, "_ASSERT_MODE", "True")
    monkeypatch.setattr(jspecs, "_ASSERT_MODE", "True")
    tspecs.mx_assert_test(specs()[1])
    with pytest.raises(ValueError, match="mx_specs is None"):
        tspecs.mx_assert_test(None)
    with pytest.raises(ValueError, match="mx_specs is None"):
        jspecs.mx_assert_test(None)


# ---------------------------------------------------------------- 3
def _special_input(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-12, 12, n))
         ).astype(np.float32)
    x[:6] = [np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-42]
    return x


@pytest.mark.parametrize("round", ["nearest", "floor", "even"])
@pytest.mark.parametrize("knob", [("bfloat", 16), ("bfloat", 12),
                                  ("fp", 16), ("fp", 8), ("bfloat", 0)])
@pytest.mark.parametrize("subnorms", [True, False])
def test_quantize_elemwise_op_bit_exact(round, knob, subnorms):
    x = _special_input(1)
    d = {knob[0]: knob[1], "bfloat_subnorms": subnorms,
         "w_elem_format": "int8"}
    js, ts = jspecs.finalize_mx_specs(d), tspecs.finalize_mx_specs(d)
    want = je.quantize_elemwise_op(jnp.asarray(x), js, round=round)
    got = te.quantize_elemwise_op(torch.as_tensor(x), ts, round=round)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("case", [("bfloat", 16), ("bfloat", 10),
                                  ("fp", (5, 10)), ("fp", (5, 2)),
                                  ("fp", (None, 3))])
@pytest.mark.parametrize("denorm", [True, False])
def test_quantize_bfloat_and_fp_bit_exact(case, denorm):
    x = _special_input(2)
    kind, arg = case
    if kind == "bfloat":
        want = je.quantize_bfloat(jnp.asarray(x), arg, allow_denorm=denorm)
        got = te.quantize_bfloat(torch.as_tensor(x), arg,
                                 allow_denorm=denorm)
    else:
        want = je.quantize_fp(jnp.asarray(x), *arg, allow_denorm=denorm)
        got = te.quantize_fp(torch.as_tensor(x), *arg, allow_denorm=denorm)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_quantize_fp_refuses_formats_without_nan():
    with pytest.raises(AssertionError, match="NaN"):
        je.quantize_fp(jnp.ones(2), 4, 3)
    with pytest.raises(ValueError, match="NaN"):
        te.quantize_fp(torch.ones(2), 4, 3)


@pytest.mark.parametrize("bad", [{"bfloat": 16, "fp": 16}, {"bfloat": 8},
                                 {"fp": 6}])
def test_quantize_elemwise_op_error_cases(bad):
    d = dict(bad, w_elem_format="int8")
    js, ts = jspecs.finalize_mx_specs(d), tspecs.finalize_mx_specs(d)
    with pytest.raises(ValueError) as jerr:
        je.quantize_elemwise_op(jnp.ones(4), js)
    with pytest.raises(ValueError) as terr:
        te.quantize_elemwise_op(torch.ones(4), ts)
    assert str(terr.value) == str(jerr.value)
    x = torch.ones(3)
    assert te.quantize_elemwise_op(x, None) is x


@pytest.mark.parametrize("fmt", ["fp6_e3m2", "int4", "bfloat16"])
def test_dither_with_jax_draws_bit_exact(fmt):
    ebits, mbits, _, max_norm, _ = tformats.get_format_params(fmt)
    x = _special_input(3, 2048)
    key = jax.random.PRNGKey(7)
    draws = np.asarray(jax.random.uniform(key, x.shape, dtype=jnp.float32))
    want = je.quantize_elemwise_core(jnp.asarray(x), mbits, ebits, max_norm,
                                     round="dither", key=key)
    got = te.quantize_elemwise_core(torch.as_tensor(x), mbits, ebits,
                                    max_norm, round="dither",
                                    rand=torch.tensor(draws))
    np.testing.assert_array_equal(bits(got), bits(want))
    # from a generator: seeded and reproducible, on the format's grid;
    # zero draws are floor rounding
    x = torch.as_tensor(_special_input(4, 2048)[6:])
    q = lambda r, **kw: te.quantize_elemwise_core(x, mbits, ebits, max_norm,
                                                  r, **kw)
    a = q("dither", generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, q("dither",
                            generator=torch.Generator().manual_seed(3)))
    assert torch.equal(te.quantize_elemwise_core(a, mbits, ebits, max_norm),
                       a)
    assert torch.equal(q("dither", rand=torch.zeros_like(x)), q("floor"))
    with pytest.raises(ValueError, match="generator"):
        te.round_mantissa(x, 4, "dither")
    with pytest.raises(ValueError, match="requires a PRNG key"):
        je.round_mantissa(jnp.asarray(x.numpy()), 4, "dither")


# ---------------------------------------------------------------- 4
@pytest.mark.parametrize("fmt", ["fp6_e3m2", "int4", "fp8_e4m3", None])
@pytest.mark.parametrize("axes,block", [([-1], None), ([0], 16),
                                        ([-2], 8)])
@pytest.mark.parametrize("scale_bits", [0, 4])
def test_quantize_mx_op_bit_exact(fmt, axes, block, scale_bits):
    rng = np.random.default_rng(5)
    x = randn(rng, 6, 40, 24) * np.exp(rng.uniform(-6, 6, (6, 40, 24))
                                       ).astype(np.float32)
    d = dict(BASE, scale_bits=scale_bits)
    js, ts = jspecs.finalize_mx_specs(d), tspecs.finalize_mx_specs(d)
    want = jmx.quantize_mx_op(jnp.asarray(x), js, elem_format=fmt,
                              block_size=block, axes=axes)
    got = tmx.quantize_mx_op(torch.as_tensor(x), ts, elem_format=fmt,
                             block_size=block, axes=axes)
    np.testing.assert_array_equal(bits(got), bits(want))


# ---------------------------------------------------------------- 5
@pytest.mark.parametrize("which", ["elemwise", "mx", "mx_outlier"])
def test_ste_primitives(which):
    x = randn(np.random.default_rng(6), 4, 64)

    def make(m, s):
        if which == "elemwise":
            return lambda a: m.ste_elemwise(a, s, "nearest")
        if which == "mx":
            return lambda a: m.ste_mx(a, s, "fp6_e3m2", (-1,), "nearest")
        return lambda a: m.ste_mx_outlier(a, s, "int4", "fp6_e3m2", (-1,),
                                          "nearest")
    check_specs(make, [x], qbps=(True, False))


# ---------------------------------------------------------------- 6
SIMD = ["add", "sub", "mul", "div", "sqrt", "square", "exp", "log",
        "reduce_sum", "reduce_mean", "norm", "split"]


@pytest.mark.parametrize("name", SIMD)
def test_simd_ops(name):
    rng = np.random.default_rng(7)
    pos = name in ("sqrt", "log", "norm")
    a = np.abs(randn(rng, 3, 4, 8)) + 0.5 if pos else randn(rng, 3, 4, 8)
    b = np.abs(randn(rng, 3, 4, 8)) + 0.5
    binary = name in ("add", "sub", "mul", "div")

    def make(m, s):
        fn = getattr(m, "simd_" + name)
        if binary:
            return lambda a, b: fn(a, b, s)
        if name in ("reduce_sum", "reduce_mean", "norm"):
            return lambda a: (fn(a, axis=-1, keepdims=True, mx_specs=s),
                              fn(a, axis=(0, 1), mx_specs=s),
                              fn(a, mx_specs=s))
        if name == "split":
            return lambda a: (tuple(fn(a, 2, axis=1, mx_specs=s)),
                              tuple(fn(a, [3, 5], axis=-1, mx_specs=s)))
        return lambda a: fn(a, s)
    check_specs(make, [a, b] if binary else [a])


@pytest.mark.parametrize("name", ["exp", "exp2", "recip", "div", "sqrt",
                                  "tanh"])
def test_vector_ops(name):
    from microscopiq_tpu.nn import vector_ops as jv
    from microscopiq_tpu_torch.nn import vector_ops as tv
    rng = np.random.default_rng(8)
    a = np.abs(randn(rng, 4, 16)) + 0.25
    b = np.abs(randn(rng, 4, 16)) + 0.25
    knobs = [{}, {"vec_use_exp2": True}, {"vec_use_recip": True}]
    pairs = [specs(True, **k) for k in knobs]
    jf, tf = getattr(jv, "vec_" + name), getattr(tv, "vec_" + name)
    if name == "div":
        check(lambda x, y: tuple(jf(x, y, js) for js, _ in pairs),
              lambda x, y: tuple(tf(x, y, ts) for _, ts in pairs), [a, b])
    else:
        check(lambda x: tuple(jf(x, js) for js, _ in pairs),
              lambda x: tuple(tf(x, ts) for _, ts in pairs), [a])


# ---------------------------------------------------------------- 7
ACTS = ["relu", "relu6", "gelu", "tanh", "sigmoid", "silu", "leaky_relu"]


@pytest.mark.parametrize("name", ACTS)
def test_activations(name):
    x = randn(np.random.default_rng(9), 4, 32, scale=3.0)
    if name == "leaky_relu":
        make = lambda m, s: lambda a: m.leaky_relu(a, 0.1, s)
    else:
        make = lambda m, s: lambda a: getattr(m, name)(a, s)
    check_specs(make, [x])


def test_activation_modules():
    js, ts = specs(True)
    x = randn(np.random.default_rng(10), 3, 16, scale=2.0)
    names = ["ReLU", "ReLU6", "GELU", "SiLU", "Sigmoid", "Tanh",
             "LeakyReLU", "Softmax"]
    jms = [getattr(jnn, n)(mx_specs=js) for n in names]
    tms = [getattr(tnn, n)(mx_specs=ts) for n in names]
    check(lambda a: tuple(m.apply({}, a) for m in jms),
          lambda a: tuple(m(a) for m in tms), [x])


@pytest.mark.parametrize("exp2", [False, True])
@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax(exp2, axis):
    x = randn(np.random.default_rng(11), 2, 6, 16, scale=2.0)
    check_specs(lambda m, s: lambda a: m.softmax(a, axis, s), [x],
                softmax_exp2=exp2)


# ---------------------------------------------------------------- 8
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("a_axes", [None, 1])
def test_mx_linear(bias, a_axes):
    rng = np.random.default_rng(12)
    x, w = randn(rng, 2, 8, 64), randn(rng, 48, 64, scale=0.125)
    args = [x, w] + ([randn(rng, 48)] if bias else [])
    check_specs(lambda m, s: lambda x, w, *b: m.mx_linear(
        x, w, b[0] if b else None, s), args, a_axes=a_axes)


def test_linear_is_the_plain_product_without_spec():
    rng = np.random.default_rng(13)
    x, w, b = randn(rng, 5, 32), randn(rng, 16, 32), randn(rng, 16)
    check(lambda x, w, b: jnn.linear(x, w, b),
          lambda x, w, b: tnn.linear(x, w, b), [x, w, b])


@pytest.mark.parametrize("mode", ["aa", "aw", "wa"])
def test_matmul_and_bmm(mode):
    rng = np.random.default_rng(14)
    a, b = randn(rng, 3, 8, 64), randn(rng, 3, 64, 40)
    check_specs(lambda m, s: lambda a, b: m.matmul(a, b, s, mode), [a, b],
                w_elem_format="int4")
    assert tnn.bmm is tnn.matmul and jnn.bmm is jnn.matmul


def test_mxlinear_module_from_flax_tree():
    rng = np.random.default_rng(15)
    x = randn(rng, 4, 64)
    pairs = [specs(q) for q in (True, False)]
    jms = [jnn.MXLinear(24, mx_specs=js) for js, _ in pairs]
    v = {"params": {"kernel": randn(rng, 64, 24, scale=0.125),
                    "bias": randn(rng, 24, scale=0.1)}}
    tms = [tnn.MXLinear(64, 24, mx_specs=ts, device="cpu") for _, ts in pairs]
    for tm in tms:
        load_flax_variables(tm, params_from_jax(v, device="cpu"))
    k, b = v["params"]["kernel"], v["params"]["bias"]
    # the input's and the parameters' gradients, one call each side
    check(lambda a, k, b: tuple(
              m.apply({"params": {"kernel": k, "bias": b}}, a) for m in jms),
          lambda a, k, b: tuple(_with(m, kernel=k, bias=b)(a) for m in tms),
          [x, k, b])
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(tms[0], {"params": {"kernel": torch.zeros(2, 2)}})
    with pytest.raises(KeyError, match="no parameter"):
        load_flax_variables(tms[0], {"params": {"scale": torch.zeros(2)}})


def _with(module, **tensors):
    """``module`` called with its parameters replaced by ``tensors``."""
    return lambda *a: torch.func.functional_call(module, tensors, a)


def _packed_dict(p):
    import dataclasses
    return {f.name: (_packed_dict(getattr(p, f.name))
                     if dataclasses.is_dataclass(getattr(p, f.name))
                     else getattr(p, f.name))
            for f in dataclasses.fields(p)}


@pytest.mark.parametrize("kind", ["mx", "nb", "sideband"])
def test_quantized_linear_plain_twins(kind):
    """QuantizedLinear on the CPU (the plain twins, which take every token
    count alike) against JAX's QuantizedLinear with use_pallas=False on
    the same packed weight; the card's GEMV/GEMM split is chip_smoke.py's
    ``mx_layers``."""
    from microscopiq_tpu.ops import outlier as jo
    rng = np.random.default_rng(16)
    K, N = 64, 48
    w = jnp.asarray(randn(rng, K, N, scale=0.02))
    if kind == "mx":
        packed = jax.jit(lambda a: jpk.to_serving_layout(jpk.pack_mx(
            a, 8, "fp6_e3m2", 32, axis=0, transport="emi8")))(w)
    elif kind == "nb":
        _, _, dec = jax.jit(lambda a: jo.quantize_mx_outlier_hessian_decisions(
            a.T, 8, 8, "int2", "fp4_e2m1", axes=[0], block_size=16,
            std_dev=2.0))(w)
        packed = jpk.pack_outlier_nb(dict(dec, block_size=16))
    else:
        packed = jpk.pack_mx_outlier(w, 8, 8, "int4", "fp8_e4m3",
                                     block_size=16, axis=0)
    leaf = jax.tree_util.tree_map(
        lambda v: np.asarray(v) if isinstance(v, jax.Array) else v,
        _packed_dict(packed))
    tp = params_from_jax({"w": leaf}, device="cpu")["w"]
    x = randn(rng, 8, K)
    want = jax.jit(lambda a: jnn.QuantizedLinear(N, use_pallas=False).apply(
        {}, a, packed))(jnp.asarray(x))
    got = tnn.QuantizedLinear()(torch.as_tensor(x), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-4)
