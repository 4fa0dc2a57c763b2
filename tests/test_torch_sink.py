"""Port sink cache (microscopiq_tpu_torch.kv.sink) against the JAX cache on
the same seeded numpy inputs; mirrors tests/test_kv.py:248.

Tolerances: slot stores, masks and lengths step by step within 1e-5 of
JAX's (cos and sin of the re-rotation may differ by an ulp between XLA and
PyTorch, and each eviction rotates the window again); ``_rope_delta``
within 1e-6; the window arithmetic of the port alone (sinks kept, the
newest token at the last slot, re-rotation equal to a rotation at the new
slot) within the JAX test's 1e-5 / 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.kv import sink as js
from microscopiq_tpu_torch.kv import sink as ts
from microscopiq_tpu_torch.models.llama import rope


def _t(a):
    return torch.tensor(np.array(a))


def test_rope_delta_matches_jax():
    k = np.random.default_rng(0).standard_normal((2, 5, 3, 16)).astype(
        np.float32)
    for delta, theta in ((-1.0, 10000.0), (3.0, 500000.0)):
        np.testing.assert_allclose(
            ts._rope_delta(_t(k), delta, theta).numpy(),
            np.asarray(js._rope_delta(jnp.asarray(k), delta, theta)),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("prompt", [1, 3])
def test_sink_steps_match_jax(prompt):
    B, KVH, hd, sink, window, T = 2, 2, 8, 2, 4, 12
    rng = np.random.default_rng(prompt)
    jst = js.init_sink_cache(1, B, sink, window, KVH, hd, jnp.float32)
    tst = ts.init_sink_cache(1, B, sink, window, KVH, hd, torch.float32,
                             device="cpu")
    t = 0
    while t < T:
        S = prompt if t == 0 else 1
        k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
        v = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
        jc = js.SinkDecodeCache(jst, sink)
        tc = ts.SinkDecodeCache(tst, sink)
        slots = tc.slot_positions(S)
        np.testing.assert_array_equal(slots.numpy(),
                                      np.asarray(jc.slot_positions(S)))
        pos = np.broadcast_to(slots.numpy()[None], (B, S))
        jk, jv, jm = jc.update(0, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), None)
        tk, tv, tm = tc.update(0, _t(k), _t(v), _t(pos), None)
        jst, tst = jc.finalize(), tc.finalize()
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        t += S
        assert tst.host_length == int(tst.length) == int(jst.length) == t


def test_sink_window_and_rerotation():
    B, KVH, hd, sink, window = 1, 1, 8, 2, 4
    rng = np.random.default_rng(4)
    state = ts.init_sink_cache(1, B, sink, window, KVH, hd, torch.float32,
                               device="cpu")
    raw = [_t(rng.standard_normal((B, 1, KVH, hd)).astype(np.float32))
           for _ in range(10)]
    at = lambda kr, slot: rope(kr, kr, torch.tensor([[slot]]), hd,
                               10000.0)[0]
    for t, kr in enumerate(raw):
        cache = ts.SinkDecodeCache(state, sink)
        slot = cache.slot_positions(1)[None, :]
        k_rot, _ = rope(kr, kr, slot, hd, 10000.0)
        _, _, mask = cache.update(0, k_rot, kr, slot, None)
        state = cache.finalize()
        assert int(mask.sum()) == min(t + 1, sink + window)
    assert int(state.length) == state.host_length == 10
    np.testing.assert_allclose(state.k[0][:, 0].numpy(),
                               at(raw[0], 0)[:, 0].numpy(), atol=1e-5)
    np.testing.assert_allclose(state.k[0][:, -1].numpy(),
                               at(raw[-1], sink + window - 1)[:, 0].numpy(),
                               atol=1e-5)
    # token 7 entered at slot 5; after two evictions it sits at slot 3
    np.testing.assert_allclose(state.k[0][:, 3].numpy(),
                               at(raw[7], 3)[:, 0].numpy(), atol=1e-4)


def test_sink_prefill_overflow_raises():
    st = ts.init_sink_cache(1, 1, 2, 4, 1, 8, torch.float32, device="cpu")
    c = ts.SinkDecodeCache(st, 2)
    with pytest.raises(ValueError, match="sink cache holds 6 slots"):
        c.update(0, torch.zeros(1, 7, 1, 8), torch.zeros(1, 7, 1, 8),
                 torch.arange(7)[None], None)
