"""The port's MX norms, convolutions, LSTM and ``mx_op_table`` against the
JAX package on the same numpy inputs (the rest of the layer library:
``tests/test_torch_mx_layers.py``, whose helpers this file shares).

- Outputs at ``rtol=1e-5, atol=1e-6``, gradients (``torch.autograd``
  against one jitted ``jax.vjp`` with one random cotangent) at
  ``rtol=1e-4, atol=1e-5``, the tolerances of
  ``tests/test_nn_layers.py::test_conv_backward_golden``; every gradient
  with ``quantize_backprop`` on and off.
- ``tests/golden/conv.npz`` (the reference's conv and transposed conv,
  forward and backward) is matched through the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from microscopiq_tpu import nn as jnn
from microscopiq_tpu_torch import nn as tnn
from microscopiq_tpu_torch import specs as tspecs
from microscopiq_tpu_torch.convert import load_flax_variables, params_from_jax
from test_torch_mx_layers import (FWD, GRAD, _one_torch_thread,  # noqa: F401
                                  _with, check, check_specs, randn, specs)


# ---------------------------------------------------------------- 9
@pytest.mark.parametrize("norm", ["layer", "rms", "layer_nobias"])
def test_layer_and_rms_norm(norm):
    rng = np.random.default_rng(17)
    x = randn(rng, 2, 5, 32, scale=2.0) + 0.5
    scale = 1 + randn(rng, 32, scale=0.1)
    bias = randn(rng, 32, scale=0.1)
    ub = norm == "layer"

    def make(m, s):
        if norm == "rms":
            mod = m.RMSNorm(32, mx_specs=s)
        else:
            mod = m.LayerNorm(32, use_bias=ub, mx_specs=s)
        if m is jnn:
            return lambda a, w, b: mod.apply(
                {"params": {"scale": w, **({"bias": b} if ub else {})}}, a)
        tree = {"scale": torch.as_tensor(scale)}
        if ub:
            tree["bias"] = torch.as_tensor(bias)
        load_flax_variables(mod, {"params": tree})

        def run(a, w, b):       # the buffers take the tracked tensors
            mod.scale = w
            if ub:
                mod.bias = b
            return mod(a) + 0 * b
        return run
    check_specs(make, [x, scale, bias])


def test_group_norm():
    rng = np.random.default_rng(18)
    x = randn(rng, 2, 8, 5, 5, scale=2.0)
    w, b = 1 + randn(rng, 8, scale=0.1), randn(rng, 8, scale=0.1)

    def make(m, s):
        if m is jnn:
            mod = jnn.GroupNorm(4, 8, mx_specs=s)
            return lambda a, w, b: mod.apply(
                {"params": {"scale": w, "bias": b}}, a)
        mod = tnn.GroupNorm(4, 8, mx_specs=s, device="cpu")
        return lambda a, w, b: _with(mod, scale=w, bias=b)(a)
    check_specs(make, [x, w, b])


@pytest.mark.parametrize("use_ra", [True, False])
def test_batch_norm(use_ra):
    rng = np.random.default_rng(19)
    x = randn(rng, 4, 6, 3, 3, scale=2.0) + 1.0
    v = {"params": {"scale": 1 + randn(rng, 6, scale=0.1),
                    "bias": randn(rng, 6, scale=0.1)},
         "batch_stats": {"mean": randn(rng, 6, scale=0.1),
                         "var": 1 + np.abs(randn(rng, 6, scale=0.1))}}
    pairs = [specs(q) for q in (True, False)] + [(None, None)]
    jms = [jnn.BatchNorm(6, use_running_average=use_ra, mx_specs=js)
           for js, _ in pairs]
    tms = [tnn.BatchNorm(6, use_running_average=use_ra, mx_specs=ts,
                         device="cpu")
           for _, ts in pairs]
    for tm in tms:
        load_flax_variables(tm, params_from_jax(v, device="cpu")).train()
    if not use_ra:
        # one training-mode call: the running buffers move, by the
        # population variance as jnp.var gives it
        upd = jax.jit(lambda a: jms[0].apply(v, a, mutable=["batch_stats"])[1]
                      )(jnp.asarray(x))
        tms[0](torch.as_tensor(x))
        for n in ("mean", "var"):
            np.testing.assert_allclose(getattr(tms[0], n).numpy(),
                                       np.asarray(upd["batch_stats"][n]),
                                       **FWD)
        for tm in tms:
            load_flax_variables(tm, params_from_jax(v, device="cpu"))
            tm.eval()                # batch statistics, buffers untouched
    before = tms[0].var.clone()
    japply = ((lambda m, a: m.apply(v, a)) if use_ra else
              (lambda m, a: m.apply(v, a, mutable=["batch_stats"])[0]))
    check(lambda a: tuple(japply(m, a) for m in jms),
          lambda a: tuple(m(a) for m in tms), [x])
    assert torch.equal(tms[0].var, before)


# ---------------------------------------------------------------- 10
def _conv_specs(qbp):
    d = {"a_elem_format": "fp6_e3m2", "w_elem_format": "fp6_e3m2",
         "block_size": 4, "bfloat": 16, "quantize_backprop": qbp}
    return tspecs.finalize_mx_specs(d)


@pytest.mark.parametrize("qbp", [True, False])
@pytest.mark.parametrize("kind", ["conv", "convt"])
def test_conv_golden(golden_conv, qbp, kind):
    """The reference's conv / transposed conv (tests/golden/conv.npz),
    forward and the gradients of sum(out), through the port."""
    s = _conv_specs(qbp)
    x = torch.tensor(golden_conv["x"], requires_grad=True)
    w = torch.tensor(golden_conv["w" if kind == "conv" else "wt"],
                     requires_grad=True)
    b = torch.tensor(golden_conv["b"], requires_grad=True)
    if kind == "conv":
        out = tnn.conv2d(x, w, b, stride=2, padding=1, groups=2, mx_specs=s)
    else:
        out = tnn.conv_transpose2d(x, w, b, stride=2, padding=1, mx_specs=s)
    key = f"{kind}|qbp{int(qbp)}"
    np.testing.assert_allclose(out.detach().numpy(),
                               golden_conv[key + "|out"], **FWD)
    out.sum().backward()
    for t, n in ((x, "gx"), (w, "gw"), (b, "gb")):
        np.testing.assert_allclose(t.grad.numpy(), golden_conv[f"{key}|{n}"],
                                   **GRAD)


CONV_CASES = {
    "conv1d": ("conv1d", [(2, 8, 11), (4, 8, 3), (4,)],
               dict(stride=2, padding=1)),
    "conv3d": ("conv3d", [(2, 4, 5, 5, 5), (6, 2, 3, 3, 3), (6,)],
               dict(stride=1, padding=[(1, 0), (0, 1), (1, 1)], groups=2)),
    "conv2d_dilated": ("conv2d", [(2, 8, 9, 9), (4, 8, 3, 3), (4,)],
                       dict(stride=(1, 2), padding=2, dilation=2)),
    "convt_pad": ("conv_transpose2d", [(2, 8, 5, 5), (8, 4, 3, 3), (4,)],
                  dict(stride=2, padding=[(0, 2), (3, 1)])),
    "convt_dilated": ("conv_transpose2d", [(2, 8, 5, 5), (8, 4, 3, 3), (4,)],
                      dict(stride=3, padding=0, dilation=2)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_variants(case):
    f, shapes, kw = CONV_CASES[case]
    rng = np.random.default_rng(20)
    check_specs(lambda m, s: lambda x, w, b: getattr(m, f)(
        x, w, b, mx_specs=s, **kw), [randn(rng, *sh) for sh in shapes],
        block_size=4)


def test_adaptive_avg_pool_and_conv2d_module():
    rng = np.random.default_rng(21)
    x = randn(rng, 2, 4, 8, 6)
    k, b = randn(rng, 6, 2, 3, 3, scale=0.3), randn(rng, 6, scale=0.1)

    def make(m, s):
        pool = lambda a: m.adaptive_avg_pool2d(a, (4, 3), s)
        if m is jnn:
            mod = jnn.Conv2d(4, 6, 3, stride=1, padding=1, groups=2,
                             mx_specs=s)
            return lambda a, k, b: (pool(a), mod.apply(
                {"params": {"kernel": k, "bias": b}}, a))
        mod = tnn.Conv2d(4, 6, 3, stride=1, padding=1, groups=2, mx_specs=s,
                         device="cpu")
        load_flax_variables(mod, params_from_jax(
            {"params": {"kernel": k, "bias": b}}, device="cpu"))
        return lambda a, k, b: (pool(a), _with(mod, kernel=k, bias=b)(a))
    check_specs(make, [x, k, b], block_size=4)
    with pytest.raises(ValueError, match="divisible"):
        tnn.adaptive_avg_pool2d(torch.zeros(1, 1, 5, 5), 2)


# ---------------------------------------------------------------- 11
def test_lstm():
    """Two steps from a random carry (h0, c0), so that w_hh and the cell
    state take part from the first step: the port's loop against
    ``lax.scan``."""
    rng = np.random.default_rng(22)
    xs, h0, c0 = randn(rng, 2, 2, 8), randn(rng, 2, 8), randn(rng, 2, 8)
    p = {"w_ih": randn(rng, 32, 8, scale=0.3),
         "w_hh": randn(rng, 32, 8, scale=0.3), "bias": randn(rng, 32)}
    names = ("w_ih", "w_hh", "bias")

    def make(m, s):
        if m is jnn:
            mod = jnn.LSTM(8, mx_specs=s)
            return lambda a, h, c, *w: mod.apply(
                {"params": {"LSTMCell_0": dict(zip(names, w))}}, a, (h, c))
        mod = tnn.LSTM(8, 8, mx_specs=s, device="cpu")
        load_flax_variables(mod, params_from_jax(
            {"params": {"LSTMCell_0": p}}, device="cpu"))
        return lambda a, h, c, *w: torch.func.functional_call(
            mod, {f"cell.{n}": t for n, t in zip(names, w)}, (a, (h, c)))
    check_specs(make, [xs, h0, c0] + [p[n] for n in names],
                qbps=(True, False), block_size=8)


# ---------------------------------------------------------------- 12
def test_mx_op_table_and_exports():
    js, ts = specs(True)
    jt, tt = jnn.mx_op_table(js), tnn.mx_op_table(ts)
    assert set(jt) == set(tt)
    rng = np.random.default_rng(23)
    a, b = randn(rng, 4, 32), np.abs(randn(rng, 4, 32)) + 0.5
    w = randn(rng, 16, 32, scale=0.1)
    ops = lambda t: lambda a, b, w: (
        t["add"](a, b), t["mul"](a, b), t["div"](a, b), t["exp"](a),
        t["gelu"](a), t["softmax"](a), t["sum"](a, axis=-1),
        t["linear"](a, w), t["matmul"](a, w.T))
    check(ops(jt), ops(tt), [a, b, w])
    import microscopiq_tpu.nn as jpkg
    public = {n for n in dir(jpkg) if not n.startswith("_")
              and callable(getattr(jpkg, n))}
    assert public <= set(tnn.__all__)
