"""Port quantized KV cache (microscopiq_tpu_torch.kv.cache) against the JAX
cache on the same numpy inputs: codecs, the GEAR side-band, the shared
decode cache, the slot caches, and the model, generate and engine on top.

Tolerances:
- codes, min/max scales and residual rows: bit-exact against JAX under jit,
  as its caches always run (same f32 operations in the same order;
  torch.round and jnp.round both round half to even). Compiled, XLA turns
  the division by 2^bits - 1 into a product with its f32 reciprocal, which
  the port does too; eager JAX divides and differs by an ulp;
- dequantized values: 1e-6 relative (XLA may contract the scale-and-shift
  into one fused multiply-add);
- GEAR-L bases: compared as their products q @ p^T, the restored chunk
  values, within atol 2e-5 / rtol 1e-4 (tests/test_gear_cache.py:61,148).
  QR may pick other column signs, and the stored p, q with them;
- greedy tokens: identical in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.eval.generate import generate as j_generate
from microscopiq_tpu.kv import cache as jc
from microscopiq_tpu.models import LlamaConfig as JConfig
from microscopiq_tpu.models import LlamaForCausalLM as JModel
from microscopiq_tpu.nn import fuse_projections as j_fuse
from microscopiq_tpu.serve.engine import BatchEngine as JEngine
from microscopiq_tpu_torch.convert import params_from_jax, quant_state_from_jax
from microscopiq_tpu_torch.eval.generate import generate
from microscopiq_tpu_torch.kv import cache as tc
from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from microscopiq_tpu_torch.models import llama as tllama
from microscopiq_tpu_torch.serve.engine import BatchEngine
from test_torch_llama import jax_to_numpy, jax_tree, model_pair, numpy_tree

B, KVH, HD, GAP = 2, 2, 16, 8


def _np_state(st):
    """A JAX QuantKVState as the field -> numpy mapping convert takes."""
    return {f.name: (None if getattr(st, f.name) is None
                     else np.asarray(getattr(st, f.name)))
            for f in dataclasses.fields(st)}


def _cfgs(**kw):
    """The same QuantKVConfig in both packages (dtypes translated)."""
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    tkw = {k: dt.get(v, v) for k, v in kw.items()}
    return jc.QuantKVConfig(**kw), tc.QuantKVConfig(**tkw)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _chunks(rng, nch, shape=(B, KVH), gap=GAP, hd=HD):
    x = rng.standard_normal(shape + (nch, gap, hd)).astype(np.float32)
    x *= np.exp(rng.uniform(-1, 1, shape + (nch, 1, hd))).astype(np.float32)
    return x


def _eq(got, want, name=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


def _lowrank_product(p, q):
    """q @ p^T per chunk: p (..., KVH, C, r, hd), q (..., C, r, gap) ->
    (..., KVH, C, gap, hd)."""
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    return np.einsum("...crg,...kcrd->...kcgd", q, p)


def _assert_state(got: tc.QuantKVState, want, cfg_t, gear_tol=True):
    """Port state vs numpy'd JAX state: codes, scales, residual and length
    bit-exact; GEAR bases as products; outliers as restored values."""
    for name in ("kq", "vq", "k_mn", "k_sc", "v_mn", "v_sc"):
        _eq(getattr(got, name).numpy(), want[name], name)
    for name in ("res_k", "res_v"):
        _eq(getattr(got, name).float().numpy(),
            np.asarray(want[name], np.float32), name)
    _eq(np.asarray(got.length), want["length"], "length")
    if cfg_t.rank > 0:
        for side in "kv":
            np.testing.assert_allclose(
                _lowrank_product(getattr(got, f"{side}_p").float().numpy(),
                                 getattr(got, f"{side}_q").float().numpy()),
                _lowrank_product(np.asarray(want[f"{side}_p"], np.float32),
                                 np.asarray(want[f"{side}_q"], np.float32)),
                atol=2e-5 if gear_tol else 0, rtol=1e-4, err_msg=side)
    if cfg_t.out_k > 0:
        for side in "kv":
            np.testing.assert_array_equal(
                np.sort(getattr(got, f"{side}_ov").numpy(), -1),
                np.sort(want[f"{side}_ov"], -1))


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_bit_exact(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2 ** bits, (B, KVH, 3, GAP, HD)).astype(np.uint8)
    per = tc._per(bits)
    want = np.asarray(jax.jit(jc._pack_codes, static_argnums=(1, 2))(
        jnp.asarray(codes), per, bits))
    got = tc._pack_codes(torch.from_numpy(codes), per, bits)
    assert got.shape == (B, KVH, 3, GAP // per, HD)
    _eq(got.numpy(), want)
    _eq(tc._unpack_codes(got, per, bits).numpy(), codes)
    # byte row r packs tokens r, r + gap/per, ... (never adjacent tokens)
    if per > 1:
        rows = GAP // per
        _eq(got[..., 0, :].numpy() & ((1 << bits) - 1), codes[..., 0, :])
        _eq(got[..., 0, :].numpy() >> bits & ((1 << bits) - 1),
            codes[..., rows, :])


@pytest.mark.parametrize("bits,group", [(2, 0), (4, 0), (8, 0), (4, 4),
                                        (2, 2)])
def test_quant_chunk_k_bit_exact(bits, group):
    x = _chunks(np.random.default_rng(10 + bits + group), 3)
    x[0, 0, 1, :, 3] = 0.5                       # a constant channel: sc = 1
    jq, jmn, jsc = jax.jit(jc._quant_chunk_k, static_argnums=(1, 2))(
        jnp.asarray(x), bits, group)
    tq, tmn, tsc = tc._quant_chunk_k(_t(x), bits, group)
    _eq(tq.numpy(), jq, "codes")
    _eq(tmn.numpy(), jmn, "mn")
    _eq(tsc.numpy(), jsc, "sc")
    np.testing.assert_allclose(
        tc._dequant_k(tq, tmn, tsc, torch.float32, bits).numpy(),
        np.asarray(jc._dequant_k(jq, jmn, jsc, jnp.float32, bits)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits,v_group", [(4, 16), (4, 8), (2, 4), (8, 16),
                                          (4, 64)])
def test_quant_chunk_v_bit_exact(bits, v_group):
    x = _chunks(np.random.default_rng(20 + bits + v_group), 2)
    jq, jmn, jsc = jax.jit(jc._quant_chunk_v, static_argnums=(1, 2))(
        jnp.asarray(x), bits, v_group)
    tq, tmn, tsc = tc._quant_chunk_v(_t(x), bits, v_group)
    _eq(tq.numpy(), jq, "codes")
    _eq(tmn.numpy(), jmn, "mn")
    _eq(tsc.numpy(), jsc, "sc")
    np.testing.assert_allclose(
        tc._dequant_v(tq, tmn, tsc, v_group, torch.float32, bits).numpy(),
        np.asarray(jc._dequant_v(jq, jmn, jsc, v_group, jnp.float32, bits)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rank,out_k", [(2, 0), (0, 2), (2, 2)])
def test_compress_chunks_gear_matches_jax(rank, out_k):
    rng = np.random.default_rng(30 + rank + out_k)
    kc, vc = _chunks(rng, 3), _chunks(rng, 3)
    jcfg, tcfg = _cfgs(bits=4, gap=GAP, v_group=HD // 2, rank=rank,
                       out_k=out_k, loop=2, lr_dtype=jnp.float32)
    want = jax.jit(lambda a, b: jc._compress_chunks(a, b, jcfg))(
        jnp.asarray(kc), jnp.asarray(vc))
    got = tc._compress_chunks(_t(kc), _t(vc), tcfg)
    assert sorted(got) == sorted(want)
    for name in ("kq", "vq", "k_mn", "k_sc", "v_mn", "v_sc"):
        _eq(got[name].numpy(), want[name], name)
    for side, raw in (("k", kc), ("v", vc)):
        # restored chunks: dequantized codes + low-rank error + outliers
        deq = (tc._dequant_k(got["kq"], got["k_mn"], got["k_sc"],
                             torch.float32, 4) if side == "k" else
               tc._dequant_v(got["vq"], got["v_mn"], got["v_sc"], HD // 2,
                             torch.float32, 4))
        jdeq = jnp.asarray(deq.numpy())
        g = lambda d, n: d.get(f"{side}_{n}")
        t_rest = tc._apply_gear(
            deq, g(got, "p"), g(got, "q"), g(got, "ov"), g(got, "oi"), tcfg)
        j_rest = jc._apply_gear(
            jdeq, g(want, "p"), g(want, "q"), g(want, "ov"), g(want, "oi"),
            jcfg)
        np.testing.assert_allclose(t_rest.numpy(), np.asarray(j_rest),
                                   atol=2e-5, rtol=1e-4, err_msg=side)
        if out_k:
            # the extremes are restored exactly
            flat = raw.reshape(B, KVH, 3, -1)
            ext = np.concatenate([np.sort(flat, -1)[..., :out_k],
                                  np.sort(flat, -1)[..., -out_k:]], -1)
            np.testing.assert_array_equal(
                np.sort(got[f"{side}_ov"].numpy(), -1), np.sort(ext, -1))


def test_extract_outliers_ties_take_the_lower_index():
    """GEAR-S on a chunk folded from the bf16 residual window, whose values
    tie: the same indices as ``lax.top_k`` (the lower one first), so the
    same values are zeroed before the codes are made."""
    rng = np.random.default_rng(33)
    kc = _chunks(rng, 2)
    kc = np.round(kc * 4) / 4        # coarse values: many ties at the ends
    want = jax.jit(lambda a: jc._extract_outliers(a, 3))(jnp.asarray(kc))
    got = tc._extract_outliers(_t(kc), 3)
    for g, w, name in zip(got, want, ("cleaned", "vals", "idx")):
        _eq(g.numpy(), w, name)


def test_init_layouts_match_jax():
    for kw in (dict(), dict(k_group=4, v_group=4),
               dict(rank=2, out_k=3, residual_len=4)):
        jcfg, tcfg = _cfgs(gap=GAP, **kw)
        want = jc.init_quant_cache(2, B, 4 * GAP, KVH, HD, jcfg)
        got = tc.init_quant_cache(2, B, 4 * GAP, KVH, HD, tcfg, device="cpu")
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            if f.name == "length":
                assert int(got.length) == got.host_length == 0
            elif w is None:
                assert getattr(got, f.name) is None, f.name
            else:
                assert tuple(getattr(got, f.name).shape) == w.shape, f.name
        wc = jc.QuantizedDecodeCache(want, jcfg)
        assert tc.QuantizedDecodeCache(got, tcfg).compression_ratio == \
            pytest.approx(wc.compression_ratio, rel=1e-12)
    with pytest.raises(ValueError, match="multiple of gap"):
        tc.init_quant_cache(1, 1, GAP + 1, KVH, HD, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# shared decode cache
# ---------------------------------------------------------------------------
CACHE_CFGS = {
    "kivi4": dict(bits=4, gap=GAP, v_group=HD),
    "kivi2_grouped_v": dict(bits=2, gap=GAP, v_group=HD // 4),
    "k_group": dict(bits=4, gap=GAP, v_group=HD, k_group=GAP // 2),
    "residual_len": dict(bits=4, gap=GAP, v_group=HD, residual_len=3),
    "gearl": dict(bits=4, gap=GAP, v_group=HD, rank=2,
                  lr_dtype=jnp.float32),
    "gears": dict(bits=8, gap=GAP, v_group=HD, out_k=2),
}


@pytest.mark.parametrize("name", sorted(CACHE_CFGS))
def test_quantized_cache_prefill_then_decode_matches_jax(name):
    """A 13-token prefill, then 20 decode steps (two or more folds), on one
    of two layers; state and assembled K/V/mask after every step."""
    jcfg, tcfg = _cfgs(**CACHE_CFGS[name])
    L, S0, steps, max_len = 2, 13, 20, 5 * GAP
    rng = np.random.default_rng(40)
    ks = rng.standard_normal((B, S0 + steps, KVH, HD)).astype(np.float32)
    vs = rng.standard_normal((B, S0 + steps, KVH, HD)).astype(np.float32)
    offset = np.array([0, 2], np.int32)
    jst = jc.init_quant_cache(L, B, max_len, KVH, HD, jcfg,
                              offset=jnp.asarray(offset))
    tst = tc.init_quant_cache(L, B, max_len, KVH, HD, tcfg,
                              offset=torch.as_tensor(offset), device="cpu")

    @jax.jit
    def j_step(st, k, v, pos):
        c = jc.QuantizedDecodeCache(st, jcfg)
        out = c.update(1, k, v, pos, None)
        return out, c.finalize()

    for t0, t1 in [(0, S0)] + [(t, t + 1) for t in range(S0, S0 + steps)]:
        pos = np.broadcast_to(np.arange(t0, t1)[None] - offset[:, None],
                              (B, t1 - t0)).astype(np.int32)
        (jk, jv, jm), jst = j_step(jst, jnp.asarray(ks[:, t0:t1]),
                                   jnp.asarray(vs[:, t0:t1]),
                                   jnp.asarray(pos))
        c = tc.QuantizedDecodeCache(tst, tcfg)
        k, v, m = c.update(1, _t(ks[:, t0:t1]), _t(vs[:, t0:t1]),
                           torch.as_tensor(pos), None)
        tst = c.finalize()
        _eq(m.numpy(), jm, f"mask at {t1}")
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=2e-5,
                                   rtol=1e-4, err_msg=f"k at {t1}")
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2e-5,
                                   rtol=1e-4, err_msg=f"v at {t1}")
        _assert_state(tst, _np_state(jst), tcfg)
    assert int(tst.length) == tst.host_length == S0 + steps


def test_fused_ingest_matches_update_state():
    """ingest_for_fused leaves the state update() leaves, returns the full
    buffers and the new length; the non-fusable layouts raise."""
    jcfg, tcfg = _cfgs(bits=4, gap=GAP, v_group=HD, rank=2)
    rng = np.random.default_rng(41)
    st = quant_state_from_jax(_np_state(jc.init_quant_cache(
        1, B, 3 * GAP, KVH, HD, jcfg)), device="cpu")
    st2 = dataclasses.replace(st, **{f: getattr(st, f).clone()
                                     for f in tc._store_fields(tcfg)
                                     + ["length"]})
    for t in range(GAP + 2):
        k = _t(rng.standard_normal((B, 1, KVH, HD)))
        v = _t(rng.standard_normal((B, 1, KVH, HD)))
        a = tc.QuantizedDecodeCache(st, tcfg)
        full, new_len = a.ingest_for_fused(0, k, v)
        assert int(new_len) == t + 1 and len(full) == 12
        assert full[0] is st.kq and full[8] is st.k_p
        st = a.finalize()
        b = tc.QuantizedDecodeCache(st2, tcfg)
        b.update(0, k, v, torch.full((B, 1), t), None)
        st2 = b.finalize()
    for f in tc._store_fields(tcfg):
        assert torch.equal(getattr(st, f), getattr(st2, f)), f
    for kw in (dict(k_group=4), dict(residual_len=2), dict(out_k=1)):
        bad = tc.QuantKVConfig(gap=GAP, **kw)
        with pytest.raises(ValueError, match="fused decode kernel"):
            tc.QuantizedDecodeCache(st, bad).ingest_for_fused(0, k, v)


def test_decode_past_the_store_raises():
    _, tcfg = _cfgs(bits=4, gap=GAP, v_group=HD)
    st = tc.init_quant_cache(1, 1, GAP, KVH, HD, tcfg, device="cpu")
    st = dataclasses.replace(st, length=torch.tensor(2 * GAP - 1,
                                                     dtype=torch.int32),
                             host_length=2 * GAP - 1)
    x = torch.zeros(1, 1, KVH, HD)
    with pytest.raises(ValueError, match="overflows"):
        tc.QuantizedDecodeCache(st, tcfg).update(0, x, x, torch.zeros(1, 1),
                                                 None)


# ---------------------------------------------------------------------------
# slot caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["kivi4", "gearl", "residual_len"])
def test_slot_caches_match_jax_mixed_active(name):
    """Per-slot prefills of different true lengths, then decode steps under
    changing active masks (update and the fused ingest), state equal to
    JAX's after every step."""
    jcfg, tcfg = _cfgs(**CACHE_CFGS[name])
    nS, L, max_len, S = 3, 1, 6 * GAP, 2 * GAP + 4
    rng = np.random.default_rng(50)
    jst = jc.init_slot_quant_cache(L, nS, max_len, KVH, HD, jcfg)
    tst = quant_state_from_jax(_np_state(jst), device="cpu")
    assert tst.length.dtype == torch.int32 and tst.length.shape == (nS,)

    @jax.jit
    def j_prefill(st, k, v, slot, tl):
        c = jc.SlotQuantPrefillCache(st, jcfg, slot, tl)
        out = c.update(0, k, v, jnp.arange(S)[None], None)
        return out, c.finalize()

    for slot, tl in ((0, S), (1, GAP - 1), (2, 2 * GAP)):
        k = rng.standard_normal((1, S, KVH, HD)).astype(np.float32)
        v = rng.standard_normal((1, S, KVH, HD)).astype(np.float32)
        (jk, _, jm), jst = j_prefill(jst, jnp.asarray(k), jnp.asarray(v),
                                     jnp.int32(slot), jnp.int32(tl))
        c = tc.SlotQuantPrefillCache(tst, tcfg, slot, tl)
        tk, _, tm = c.update(0, _t(k), _t(v), torch.arange(S)[None], None)
        tst = c.finalize()
        assert torch.equal(tk, _t(k))                 # attends raw K/V
        _eq(tm.numpy(), jm)
        _assert_state(tst, _np_state(jst), tcfg)

    @jax.jit
    def j_decode(st, k, v, act, pos):
        c = jc.SlotQuantizedDecodeCache(st, jcfg, act)
        out = c.update(0, k, v, pos, None)
        return out, c.finalize()

    fused_ok = tcfg.residual_len == 0
    for step in range(2 * GAP + 3):
        act = np.array([True, step % 3 != 0, step < GAP])
        k = rng.standard_normal((nS, 1, KVH, HD)).astype(np.float32)
        v = rng.standard_normal((nS, 1, KVH, HD)).astype(np.float32)
        pos = np.array(jst.length)[:, None]
        (jk, jv, jm), jst = j_decode(jst, jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(act), jnp.asarray(pos))
        c = tc.SlotQuantizedDecodeCache(tst, tcfg, torch.as_tensor(act))
        if fused_ok and step % 2:
            _, new_len = c.ingest_for_fused(0, _t(k), _t(v))
            _eq(new_len.numpy(), jst.length)
        else:
            tk, tv, tm = c.update(0, _t(k), _t(v), torch.as_tensor(pos),
                                  None)
            _eq(tm.numpy(), jm, f"mask at step {step}")
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       atol=2e-5, rtol=1e-4)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       atol=2e-5, rtol=1e-4)
        tst = c.finalize()
        _assert_state(tst, _np_state(jst), tcfg)


# ---------------------------------------------------------------------------
# model, generate and engine over the quantized cache
# ---------------------------------------------------------------------------
QCFG = dict(bits=4, gap=8, v_group=8)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model with kernels, port model through
    cache.update) on identical weights."""
    jm, jp, tm = model_pair("float32", packed=True, fused=True)
    plain = LlamaForCausalLM(tm.cfg, use_kernels=False, device="cpu"
                             ).load_params(params_from_jax(
                                 jax_to_numpy(jp["params"]), device="cpu"))
    return jm, jp, tm, plain


@pytest.mark.parametrize("use_kernels", [True, False])
def test_greedy_32_steps_identical_to_jax_quant_cache(models, use_kernels):
    """generate(cache_kind="quant") over 32 steps (four folds), against JAX
    with use_pallas=False, whose tiny head_dim takes the cache.update path.
    Rows have equal lengths: the fused path, in JAX and in the port, does
    not mask left pads (ROADMAP queue 3)."""
    jm, jp, tm, plain = models
    jq, tq = _cfgs(**QCFG)
    prompts = np.random.default_rng(60).integers(0, 256, (3, 10))
    want = j_generate(jm, jp, prompts, 32, cache_kind="quant", quant_cfg=jq)
    got = generate(tm if use_kernels else plain, prompts, 32,
                   cache_kind="quant", quant_cfg=tq)
    assert got.shape == (3, 32)
    np.testing.assert_array_equal(got, want)


def test_generate_quant_left_padded_matches_jax(models):
    """Ragged prompts through cache.update, where the left-pad offset is
    masked."""
    jm, jp, _, plain = models
    jq, tq = _cfgs(**QCFG, k_group=4, rank=2)
    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (5, 12, 9)]
    want = j_generate(jm, jp, prompts, 12, cache_kind="quant", quant_cfg=jq)
    got = generate(plain, prompts, 12, cache_kind="quant", quant_cfg=tq)
    np.testing.assert_array_equal(got, want)


def test_generate_quant_default_max_len_rounds_to_gap(models):
    *_, plain = models
    _, tq = _cfgs(**QCFG)
    ids = np.zeros((1, 5), np.int64)
    out = generate(plain, ids, 4, cache_kind="quant", quant_cfg=tq)
    assert out.shape == (1, 4)
    with pytest.raises(ValueError, match="multiple of gap"):
        generate(plain, ids, 4, cache_kind="quant", quant_cfg=tq,
                 max_len=20)
    with pytest.raises(ValueError, match="unknown cache_kind"):
        generate(plain, ids, 4, cache_kind="paged")


def _engine(model, tq, n_slots, buckets):
    return BatchEngine(model, n_slots=n_slots, max_len=64,
                       prompt_buckets=buckets, cache_kind="quant",
                       quant_cfg=tq, device="cpu")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_engine_quantized_kv_matches_jax_and_one_slot(models, use_kernels):
    """Continuous batching over the per-slot quantized cache
    (tests/test_engine.py:184-203): tokens equal the JAX engine's and a
    1-slot engine's. Against single-sequence generate they are equal where
    the prompt fills no chunk: generate's prefill attends over the
    dequantized chunks, the engine's over the raw prompt K/V, as in JAX."""
    jm, jp, tm, plain = models
    jq, tq = _cfgs(**QCFG)
    model = tm if use_kernels else plain
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, (s,)).astype(np.int32)
               for s in (5, 11, 19)]          # tail only / 1 chunk + tail
    outs = _engine(model, tq, 4, (8, 24)).generate(prompts,
                                                   max_new_tokens=14)
    jeng = JEngine(jm, jp, n_slots=4, max_len=64, prompt_buckets=(8, 24),
                   cache_kind="quant", quant_cfg=jq)
    assert outs == jeng.generate(prompts, max_new_tokens=14)
    one = _engine(model, tq, 1, (8, 24))
    for p, got in zip(prompts, outs):
        assert one.generate([p], max_new_tokens=14)[0] == got
    ref = generate(model, np.asarray(prompts[0])[None], 14,
                   cache_kind="quant", quant_cfg=tq, max_len=64)[0].tolist()
    assert outs[0] == ref


def test_engine_quantized_kv_slot_reuse(models):
    """More requests than slots (tests/test_engine.py:206-222): each equals
    its run alone in a 1-slot engine and the JAX engine's."""
    jm, jp, tm, _ = models
    jq, tq = _cfgs(**QCFG)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, (s,)).astype(np.int32)
               for s in (4, 9, 6, 12)]
    outs = _engine(tm, tq, 2, (16,)).generate(prompts, max_new_tokens=10)
    jeng = JEngine(jm, jp, n_slots=2, max_len=64, prompt_buckets=(16,),
                   cache_kind="quant", quant_cfg=jq)
    assert outs == jeng.generate(prompts, max_new_tokens=10)
    for p, got in zip(prompts, outs):
        assert _engine(tm, tq, 1, (16,)).generate(
            [p], max_new_tokens=10)[0] == got


def test_engine_quant_checks_max_len(models):
    _, _, tm, _ = models
    with pytest.raises(ValueError, match="multiple of the quantization gap"):
        BatchEngine(tm, max_len=100, prompt_buckets=(32,),
                    cache_kind="quant", device="cpu")


@pytest.mark.parametrize("hidden", [64, 128])
def test_fused_decode_where_the_kernel_takes_the_geometry(monkeypatch,
                                                          hidden):
    """A 2-layer model of head_dim 16 (``tiny``) or 32 (hidden 128, 4
    heads, 2 KV heads) over the quantized cache: the decode takes the fused
    branch exactly where decode_route accepts the geometry (head_dim 32,
    not 16), and the greedy tokens equal use_kernels=False (cache.update)
    and JAX's, whose gate sends both head_dims to cache.update."""
    jcfg = JConfig.tiny(hidden_size=hidden, fused_projections=True)
    params = j_fuse(jax_tree(numpy_tree(jcfg, 5), jnp.float32, True))
    tree = params_from_jax(jax_to_numpy(params), device="cpu")
    tcfg = LlamaConfig.tiny(hidden_size=hidden, dtype=torch.float32,
                            fused_projections=True)
    kern = LlamaForCausalLM(tcfg, device="cpu").load_params(tree)
    plain = LlamaForCausalLM(tcfg, use_kernels=False, device="cpu"
                             ).load_params(tree)
    jq, tq = _cfgs(**QCFG)
    hd, rep = tcfg.head_dim, 2
    route = tllama.decode_route(hd, rep, tq.gap, tq.bits, tq.v_group,
                                tq.rank)
    assert (hd, route) == ({64: 16, 128: 32}[hidden],
                           {64: "update", 128: "fused"}[hidden])
    calls = []
    fused = tllama.quant_attention_decode
    monkeypatch.setattr(tllama, "quant_attention_decode",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    prompts = np.random.default_rng(62).integers(0, 256, (3, 10))
    got = generate(kern, prompts, 24, cache_kind="quant", quant_cfg=tq)
    # one fused call a layer and decode step (the first token comes from
    # the prefill)
    assert len(calls) == (2 * 23 if route == "fused" else 0)
    np.testing.assert_array_equal(
        got, generate(plain, prompts, 24, cache_kind="quant", quant_cfg=tq))
    want = j_generate(JModel(jcfg, use_pallas=False), {"params": params},
                      prompts, 24, cache_kind="quant", quant_cfg=jq)
    np.testing.assert_array_equal(got, want)
