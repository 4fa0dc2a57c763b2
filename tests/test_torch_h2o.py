"""Port H2O caches (microscopiq_tpu_torch.kv.h2o) against the JAX caches on
the same seeded numpy inputs, step by step; mirrors tests/test_h2o.py and
tests/test_h2o_quant.py.

Tolerances:
- slot positions, victims, K/V stores, codes, ring rows and lengths:
  equal (the same argmin: the first minimal slot in both);
- scores: equal (one float32 add a step of the same probabilities);
- the quantized caches' scales: equal against JAX under jit, as its caches
  run (XLA turns the division by 2^bits - 1 into a product with its f32
  reciprocal, which the port does); dequantized views 1e-6 relative (XLA
  may fuse the scale-and-shift into one multiply-add);
- a tiny float32 Llama: greedy tokens identical, slot positions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.kv import h2o as jh
from microscopiq_tpu_torch.kv import h2o as th
from test_torch_llama import model_pair


def _t(a):
    return torch.tensor(np.array(a))


def _eq(got, want, name=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=name)


def _stream(seed, T, B, KVH, hd, budget):
    rng = np.random.default_rng(seed)
    ks = rng.standard_normal((T, B, KVH, hd)).astype(np.float32)
    vs = rng.standard_normal((T, B, KVH, hd)).astype(np.float32)
    scores = rng.random((T, B, budget)).astype(np.float32)
    return ks, vs, scores


def _jit_step(mk, recent):
    """One jitted JAX cache step: update, observe, finalize; returns the
    state and the attention view."""

    @jax.jit
    def step(st, k, v, pos, sc):
        c = mk(st, recent)
        kk, vv, m = c.update(0, k, v, pos, None)
        c.observe(0, sc)
        return c.finalize(), kk, vv, m

    return step


def _drive_both(jmk, jst, tmk, tst, recent, ks, vs, scores, S0=4,
                fields=("pos", "score")):
    """Feed both caches the same prompt of S0 tokens and then one token a
    step, with the same scripted scores; compare after every step."""
    T, B = ks.shape[:2]
    step = _jit_step(jmk, recent)
    for t0, t1 in [(0, S0)] + [(t, t + 1) for t in range(S0, T)]:
        k = ks[t0:t1].transpose(1, 0, 2, 3)
        v = vs[t0:t1].transpose(1, 0, 2, 3)
        pos = np.broadcast_to(np.arange(t0, t1, dtype=np.int32), (B, t1 - t0))
        jst, jk, jv, jm = step(jst, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), jnp.asarray(scores[t0]))
        c = tmk(tst, recent)
        tk, tv, tm = c.update(0, _t(k), _t(v), _t(pos), None)
        c.observe(0, _t(scores[t0]))
        tst = c.finalize()
        _eq(tm, jm, f"mask t={t0}")
        for f in fields:
            _eq(getattr(tst, f), getattr(jst, f), f"{f} t={t0}")
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-6)
        assert tst.host_length == int(tst.length) == int(jst.length) == t1
    return jst, tst


def test_h2o_cache_steps_match_jax():
    B, KVH, hd, budget, T = 2, 2, 8, 8, 18
    ks, vs, scores = _stream(0, T, B, KVH, hd, budget)
    jst, tst = _drive_both(
        jh.H2OCache, jh.init_h2o_cache(1, B, budget, KVH, hd, jnp.float32),
        th.H2OCache, th.init_h2o_cache(1, B, budget, KVH, hd, torch.float32,
                                       device="cpu"),
        2, ks, vs, scores, fields=("pos", "score", "k", "v"))
    assert (tst.pos >= 0).all()                        # evictions happened
    assert int(tst.pos.max()) == T - 1


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quant_h2o_steps_match_jax(bits):
    B, KVH, hd, budget, T = 2, 2, 16, 8, 16
    ks, vs, scores = _stream(bits, T, B, KVH, hd, budget)
    kw = dict(bits=bits, group=8, residual_len=4)
    jst, tst = _drive_both(
        jh.QuantH2OCache,
        jh.init_quant_h2o_cache(1, B, budget, KVH, hd, dtype=jnp.float32,
                                **kw),
        th.QuantH2OCache,
        th.init_quant_h2o_cache(1, B, budget, KVH, hd, dtype=torch.float32,
                                device="cpu", **kw),
        2, ks, vs, scores,
        fields=("pos", "score", "ck", "mnk", "sck", "cv", "mnv", "scv",
                "rk", "rv", "rpos"))
    assert tst.bits == jst.bits and tst.group == jst.group


def test_quant_h2o_view_keeps_ring_tokens_exact():
    B, KVH, hd, budget, T, R = 1, 1, 8, 6, 9, 3
    ks, vs, scores = _stream(3, T, B, KVH, hd, budget)
    st = th.init_quant_h2o_cache(1, B, budget, KVH, hd, bits=2, group=8,
                                 residual_len=R, dtype=torch.float32,
                                 device="cpu")
    for t0, t1 in [(0, 4)] + [(t, t + 1) for t in range(4, T)]:
        c = th.QuantH2OCache(st, 1)
        c.update(0, _t(ks[t0:t1].transpose(1, 0, 2, 3)),
                 _t(vs[t0:t1].transpose(1, 0, 2, 3)),
                 torch.arange(t0, t1)[None], None)
        c.observe(0, _t(scores[t0]))
        st = c.finalize()
    kd, _ = th.QuantH2OCache(st, 1)._view(0)
    for s, p in enumerate(st.pos[0, 0].tolist()):
        if p >= T - R:                                 # in the ring: exact
            np.testing.assert_array_equal(kd[0, s, 0].numpy(), ks[p, 0, 0])


def test_quant_h2o_init_matches_jax_and_checks_head_dim():
    for hd, bits, group in ((80, 4, 32), (16, 2, 8), (64, 8, 32)):
        j = jh.init_quant_h2o_cache(1, 2, 8, 2, hd, bits=bits, group=group)
        t = th.init_quant_h2o_cache(1, 2, 8, 2, hd, bits=bits, group=group,
                                    device="cpu")
        assert t.group == j.group
        for f in ("ck", "mnk", "sck", "rk", "rpos", "pos", "score"):
            assert tuple(getattr(t, f).shape) == getattr(j, f).shape, f
            _eq(getattr(t, f).float(), np.asarray(getattr(j, f), np.float32))
    with pytest.raises(ValueError, match="divisible by the packing"):
        th.init_quant_h2o_cache(1, 2, 8, 2, 9, bits=2, device="cpu")


def test_h2o_guards():
    st = th.init_h2o_cache(1, 1, 8, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="recent_window"):
        th.H2OCache(st, recent_window=8)
    with pytest.raises(ValueError, match="recent_window"):
        th.SlotH2ODecodeCache(th.init_slot_h2o_cache(1, 2, 8, 2, 4,
                                                     device="cpu"),
                              torch.ones(2, dtype=torch.bool), 9)
    # a prompt over the budget raises where JAX asserts
    with pytest.raises(ValueError, match="does not fit"):
        th.H2OCache(st, 2).update(0, torch.zeros(1, 9, 2, 4),
                                  torch.zeros(1, 9, 2, 4),
                                  torch.arange(9)[None], None)


def test_argmin_takes_the_first_minimal_slot():
    """The victims of rows that tie: all protected but one, all zero, and
    equal minima; as jnp.argmin."""
    score = np.array([[0.0, 0.0, 0.0, 0.0], [0.5, 0.2, 0.2, 0.9],
                      [np.inf, np.inf, 3.0, np.inf]], np.float32)
    pos = np.array([[0, 1, 2, 3], [0, 1, 2, 3], [9, 9, 0, 9]], np.int32)
    got = th._victims(_t(pos), _t(score), 6, 2)
    want = jnp.argmin(jnp.where(jnp.asarray(pos) >= 4, jnp.inf,
                                jnp.asarray(score)), axis=1)
    _eq(got, want)
    assert got.tolist() == [0, 1, 2]


def test_slot_caches_match_jax():
    """Per-slot prefills (one right-padded) then batched decode steps with
    an inactive slot, against the JAX slot caches, every field each step."""
    L, B, budget, KVH, hd, recent, S = 1, 3, 8, 2, 4, 2, 6
    rng = np.random.default_rng(5)
    true = (6, 4, 6)
    jst = jh.init_slot_h2o_cache(L, B, budget, KVH, hd, jnp.float32)
    tst = th.init_slot_h2o_cache(L, B, budget, KVH, hd, torch.float32,
                                 device="cpu")
    for b in range(B):
        k, v = (rng.standard_normal((1, S, KVH, hd)).astype(np.float32)
                for _ in range(2))
        probs = rng.random((1, budget)).astype(np.float32)
        pos = np.arange(S, dtype=np.int32)[None]
        jc = jh.SlotH2OPrefillCache(jst, jnp.int32(b), jnp.int32(true[b]))
        jk, _, jm = jc.update(0, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), None)
        jc.observe(0, jnp.asarray(probs))
        jst = jc.finalize(true[b])
        tc = th.SlotH2OPrefillCache(tst, b, true[b])
        tk, _, tm = tc.update(0, _t(k), _t(v), _t(pos), None)
        tc.observe(0, _t(probs))
        tst = tc.finalize(true[b])
        _eq(tm, jm)
        _eq(tk, jk)
    active = np.array([True, True, False])
    for t in range(7):                          # crosses the budget
        k, v = (rng.standard_normal((B, 1, KVH, hd)).astype(np.float32)
                for _ in range(2))
        probs = rng.random((B, budget)).astype(np.float32)
        pos = np.asarray(tst.lengths)[:, None].astype(np.int32)
        jc = jh.SlotH2ODecodeCache(jst, jnp.asarray(active), recent)
        jk, _, jm = jc.update(0, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), None)
        jc.observe(0, jnp.asarray(probs))
        jst = jc.finalize()
        tc = th.SlotH2ODecodeCache(tst, torch.as_tensor(active), recent)
        tk, _, tm = tc.update(0, _t(k), _t(v), _t(pos), None)
        tc.observe(0, _t(probs))
        tst = tc.finalize()
        _eq(tm, jm, f"mask {t}")
        for f in ("pos", "score", "k", "v", "lengths"):
            _eq(getattr(tst, f), getattr(jst, f), f"{f} {t}")
    assert tst.lengths.tolist() == [13, 11, 6]


def _greedy(jm, jp, tm, jmk, tmk, jinit, tinit, S=8, steps=6, recent=2):
    """Greedy prefill + decode of a tiny Llama through a JAX cache (jitted)
    and the port's; returns both token lists and final states."""
    ids = np.random.default_rng(2).integers(0, 256, (2, S))
    B = ids.shape[0]

    @jax.jit
    def jprefill(st, ids):
        c = jmk(st, recent)
        lg = jm.apply(jp, ids, positions=jnp.broadcast_to(jnp.arange(S),
                                                          (B, S)), cache=c)
        return lg, c.finalize()

    logits, jst = jprefill(jinit, jnp.asarray(ids))

    @jax.jit
    def jstep(st, tok, t):
        c = jmk(st, recent)
        lg = jm.apply(jp, tok[:, None], positions=jnp.full((B, 1), t),
                      cache=c)
        return lg[:, -1].argmax(-1), c.finalize()

    jtok = logits[:, -1].argmax(-1)
    jout = [np.asarray(jtok)]
    for t in range(S, S + steps):
        jtok, jst = jstep(jst, jtok, t)
        jout.append(np.asarray(jtok))

    with torch.inference_mode():
        tc = tmk(tinit, recent)
        lg = tm(torch.as_tensor(ids),
                positions=torch.arange(S).expand(B, S), cache=tc)
        tst = tc.finalize()
        ttok = lg[:, -1].argmax(-1)
        tout = [ttok.numpy()]
        for t in range(S, S + steps):
            tc = tmk(tst, recent)
            lg = tm(ttok[:, None], positions=torch.full((B, 1), t), cache=tc)
            tst = tc.finalize()
            ttok = lg[:, -1].argmax(-1)
            tout.append(ttok.numpy())
    return np.stack(jout, 1), np.stack(tout, 1), jst, tst


@pytest.fixture(scope="module")
def models():
    return model_pair("float32", packed=True, fused=True)


@pytest.mark.parametrize("quant", [False, True])
def test_tiny_llama_greedy_tokens_match_jax(quant, models):
    jm, jp, tm = models
    cfg = tm.cfg
    dims = (cfg.num_hidden_layers, 2, 8, cfg.num_key_value_heads,
            cfg.head_dim)
    if quant:
        kw = dict(bits=8, group=16, residual_len=4)
        args = (jh.QuantH2OCache, th.QuantH2OCache,
                jh.init_quant_h2o_cache(*dims, dtype=jnp.float32, **kw),
                th.init_quant_h2o_cache(*dims, dtype=torch.float32,
                                        device="cpu", **kw))
    else:
        args = (jh.H2OCache, th.H2OCache,
                jh.init_h2o_cache(*dims, jnp.float32),
                th.init_h2o_cache(*dims, torch.float32, device="cpu"))
    jtoks, ttoks, jst, tst = _greedy(jm, jp, tm, *args)
    np.testing.assert_array_equal(ttoks, jtoks)
    _eq(tst.pos, jst.pos)
    assert int(tst.pos.max()) == 13                    # every step evicted
    np.testing.assert_allclose(tst.score.numpy(), np.asarray(jst.score),
                               rtol=1e-5, atol=1e-6)


def test_pad_query_mass_biases_empty_slots_as_in_jax(models):
    """ROADMAP queue 3: a right-padded slot prefill's pad QUERY rows attend
    to nothing, their softmax is uniform, and observe adds H * pads /
    budget to every slot, the empty ones (pos -1) included. The port keeps
    this for parity; the scores equal JAX's."""
    jm, jp, tm = models
    cfg = tm.cfg
    L, KVH, hd, H = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim, cfg.num_attention_heads)
    budget, S, true_len = 16, 8, 5
    ids = np.zeros((1, S), np.int64)
    ids[0, :true_len] = np.random.default_rng(3).integers(0, 256, true_len)
    @jax.jit
    def jprefill(ids):
        jc = jh.SlotH2OPrefillCache(
            jh.init_slot_h2o_cache(L, 2, budget, KVH, hd, jnp.float32),
            jnp.int32(1), jnp.int32(true_len))
        jm.apply(jp, ids, positions=jnp.arange(S)[None], cache=jc)
        return jc.finalize(true_len)

    jst = jprefill(jnp.asarray(ids))
    tc = th.SlotH2OPrefillCache(
        th.init_slot_h2o_cache(L, 2, budget, KVH, hd, torch.float32,
                               device="cpu"), 1, true_len)
    with torch.inference_mode():
        tm(torch.as_tensor(ids), positions=torch.arange(S)[None], cache=tc)
    tst = tc.finalize(true_len)
    np.testing.assert_allclose(tst.score.numpy(), np.asarray(jst.score),
                               rtol=1e-5, atol=1e-6)
    empty = tst.pos[:, 1] < 0                          # (L, budget)
    bias = H * (S - true_len) / budget
    np.testing.assert_allclose(tst.score[:, 1][empty].numpy(), bias,
                               rtol=1e-6)
    assert (tst.score[:, 0] == 0).all()                # other slot untouched
