"""Fused quantized-KV decode attention: the port's plain twins against the
JAX kernel run as the JAX tests run it (Pallas interpret mode) and against
the JAX dequantize-everything twin, on one cache state made by the JAX
package and moved to the port by convert.quant_state_from_jax. The CUDA
kernel itself is held against the twin on a card by
tests/test_torch_kernels_gpu.py.

Tolerances (tests/test_quant_attention.py:47,84):
- port decode attention (chunks through ``chunk_attention_reference``) vs
  the interpreted Pallas kernel: atol = rtol = 2e-2. Both read q as bf16 for
  the chunks and sum in float32 in other orders;
- port twins vs JAX twins: atol = rtol = 1e-5, the same float32 algorithm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.kv import cache as jc
from microscopiq_tpu.ops.pallas import quant_attention as jqa
from microscopiq_tpu_torch.convert import quant_state_from_jax
from microscopiq_tpu_torch.ops.cuda import quant_attention as qa

KVH, HD, GAP, MAXLEN, H = 2, 32, 16, 64, 8          # rep = 4, C = 4
SCALE = HD ** -0.5
# per-slot depths: 0, gap - 1 (residual only), an exact multiple of gap
# (residual empty), and a ragged length near the end of the store
SLOT_LENGTHS = (0, GAP - 1, 2 * GAP, 3 * GAP + 5)


def _state(bits, v_group, rank, B, seed=0):
    """A JAX QuantKVState holding a prefill of MAXLEN - 3 tokens, and the
    port's copy of it."""
    cfg = jc.QuantKVConfig(bits=bits, gap=GAP, v_group=v_group, rank=rank,
                           loop=2)
    rng = np.random.default_rng(seed)
    S = MAXLEN - 3
    k = jnp.asarray(rng.standard_normal((B, S, KVH, HD)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, S, KVH, HD)), jnp.float32)

    @jax.jit
    def prefill(st):
        c = jc.QuantizedDecodeCache(st, cfg)
        c.update(0, k, v, jnp.arange(S)[None], None)
        return c.finalize()

    jst = prefill(jc.init_quant_cache(1, B, MAXLEN, KVH, HD, cfg))
    tst = quant_state_from_jax(
        {f.name: (None if getattr(jst, f.name) is None
                  else np.asarray(getattr(jst, f.name)))
         for f in dataclasses.fields(jst)}, device="cpu")
    names = ("kq", "k_mn", "k_sc", "vq", "v_mn", "v_sc", "res_k", "res_v")
    if rank:
        names += ("k_p", "k_q", "v_p", "v_q")
    return (tuple(getattr(jst, n) for n in names),
            tuple(getattr(tst, n) for n in names))


def _q(B, seed=1):
    return np.random.default_rng(seed).standard_normal((B, H, HD)
                                                       ).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol)


CASES = [(bits, vg, 0, "slots") for bits in (2, 4, 8) for vg in (HD, 8)] + [
    (4, HD, 2, "slots"), (4, 8, 2, "scalar"), (4, HD, 0, "scalar"),
    (2, 8, 2, "slots")]


@pytest.mark.parametrize("bits,v_group,rank,lengths", CASES)
def test_decode_attention_matches_jax(bits, v_group, rank, lengths):
    B = len(SLOT_LENGTHS) if lengths == "slots" else 2
    jfull, tfull = _state(bits, v_group, rank, B, seed=bits + rank)
    q = _q(B)
    if lengths == "slots":
        j_len = jnp.asarray(SLOT_LENGTHS, jnp.int32)
        t_len = torch.as_tensor(SLOT_LENGTHS, dtype=torch.int32)
    else:
        j_len, t_len = jnp.int32(2 * GAP + 7), 2 * GAP + 7
    want_twin = jqa.quant_attention_decode_reference(
        jnp.asarray(q), jfull, 0, j_len, v_group, SCALE)
    want_kernel = jqa.quant_attention_decode(
        jnp.asarray(q), jfull, 0, j_len, v_group, SCALE, interpret=True)
    qa.reset_launch_counts()
    got_twin = qa.quant_attention_decode_reference(
        torch.from_numpy(q), tfull, 0, t_len, v_group, SCALE)
    got = qa.quant_attention_decode(torch.from_numpy(q), tfull, 0, t_len,
                                    v_group, SCALE)
    assert qa.launch_counts["quant_attention"] == 0      # CPU: plain twin
    assert got.shape == (B, H, HD) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    _close(got_twin.numpy(), want_twin, 1e-5)
    _close(got.numpy(), want_kernel, 2e-2)
    # a slot of depth 0 attends to nothing: the kernel path gives zeros, not
    # NaN, where the twins' softmax over an all-masked row averages V
    live = np.broadcast_to(np.asarray(t_len), (B,)) > 0
    _close(got.numpy()[live], np.asarray(want_twin)[live], 2e-2)
    if lengths == "slots":
        assert SLOT_LENGTHS[0] == 0 and not got[0].any()


@pytest.mark.parametrize("bits,rank", [(4, 0), (2, 2), (8, 0)])
def test_chunk_state_matches_interpreted_pallas(bits, rank):
    """chunk_attention_reference's unnormalised (o, m, l) against the JAX
    kernel's, with per-slot folded-chunk counts that include 0."""
    B = len(SLOT_LENGTHS)
    jfull, tfull = _state(bits, 8, rank, B, seed=5 + bits)
    nfull = np.asarray(SLOT_LENGTHS, np.int32) // GAP
    qg = _q(B, seed=2).reshape(B, KVH, H // KVH, HD)
    jl = [a[0] for a in jfull]
    jo, jm, jl_ = jqa._chunk_attention(
        jnp.asarray(qg, jnp.bfloat16), *jl[:6], jnp.asarray(nfull), SCALE,
        GAP, bits, lowrank=tuple(jl[8:]) if rank else None, interpret=True)
    tl = [a[0] for a in tfull]
    qa.reset_launch_counts()
    to, tm, tl_ = qa.chunk_attention(
        torch.from_numpy(qg).to(torch.bfloat16), *tl[:6],
        torch.from_numpy(nfull), SCALE, GAP, bits,
        lowrank=tuple(tl[8:]) if rank else None)
    assert qa.launch_counts["quant_attention"] == 0
    assert to.shape == (B, KVH, H // KVH, HD) and tm.shape == tl_.shape == (
        B, KVH, H // KVH, 1)
    live = nfull > 0
    _close(tm.numpy()[live], np.asarray(jm)[live], 2e-2)
    # compare the normalised partial output, and l, where chunks are folded
    _close((to / tl_.clamp(min=1e-30)).numpy()[live],
           (np.asarray(jo) / np.maximum(np.asarray(jl_), 1e-30))[live], 2e-2)
    _close(tl_.numpy()[live], np.asarray(jl_)[live], 2e-2)
    # no folded chunk: o = 0, m = -1e30, l = 0
    assert not to[~torch.from_numpy(live)].any()
    assert (tm[~torch.from_numpy(live)] == qa.NEG_INF).all()
    assert not tl_[~torch.from_numpy(live)].any()


def test_twin_matches_cache_update_attention():
    """The twin equals softmax attention over the K/V that
    QuantizedDecodeCache.update assembles (tests/test_quant_attention.py
    ::test_twin_matches_cache_assembly), on the port alone."""
    from microscopiq_tpu_torch.kv import cache as tc

    cfg = tc.QuantKVConfig(bits=4, gap=GAP, v_group=8, residual_dtype=
                           torch.float32)
    st = tc.init_quant_cache(1, 1, MAXLEN, KVH, HD, cfg, device="cpu")
    rng = np.random.default_rng(3)
    S = 2 * GAP + 5
    k = torch.from_numpy(rng.standard_normal((1, S, KVH, HD)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, S, KVH, HD)).astype(
        np.float32))
    c = tc.QuantizedDecodeCache(st, cfg)
    k_all, v_all, mask = c.update(0, k, v, torch.arange(S)[None], None)
    st = c.finalize()
    q = torch.from_numpy(_q(1, seed=4))
    qg = q.reshape(1, KVH, H // KVH, HD)
    logits = torch.einsum("bgrd,btgd->bgrt", qg, k_all) * SCALE
    # the last query row sees every live key
    valid = mask[0, 0, -1]
    logits = torch.where(valid, logits, qa.NEG_INF)
    want = torch.einsum("bgrt,btgd->bgrd", torch.softmax(logits, -1), v_all)
    full = tuple(getattr(st, n) for n in ("kq", "k_mn", "k_sc", "vq", "v_mn",
                                          "v_sc", "res_k", "res_v"))
    got = qa.quant_attention_decode_reference(q, full, 0, S, 8, SCALE)
    _close(got.numpy(), want.reshape(1, H, HD).numpy(), 1e-5)


def test_chunk_splits_depend_on_chunks_and_heads_only():
    for C in (1, 4, 17, 51, 200):
        for KVH_ in (1, 2, 8, 32):
            nsplit, cps = qa.chunk_splits(C, KVH_)
            assert 1 <= nsplit <= C and (nsplit - 1) * cps < C <= nsplit * cps
    assert qa.chunk_splits(51, 8) == (51, 1)
    assert qa.chunk_splits(200, 8) == (50, 4)


def test_residual_attention_rows_do_not_depend_on_batch():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((5, KVH, 4, HD)).astype(
        np.float32))
    rk = torch.from_numpy(rng.standard_normal((5, GAP, KVH, HD)).astype(
        np.float32)).to(torch.bfloat16)
    rv = torch.from_numpy(rng.standard_normal((5, GAP, KVH, HD)).astype(
        np.float32)).to(torch.bfloat16)
    res_len = torch.tensor([0, 3, GAP, 1, 7])
    full = qa.residual_attention(q, rk, rv, res_len, SCALE)
    for b in range(5):
        one = qa.residual_attention(q[b:b + 1], rk[b:b + 1], rv[b:b + 1],
                                    res_len[b:b + 1], SCALE)
        for x, y in zip(one, full):
            assert torch.equal(x[0], y[b])
    assert not full[0][0].any() and not full[2][0].any()


@pytest.mark.parametrize("hd", [16, 32, 48, 64, 128, 256, 288])
@pytest.mark.parametrize("rep", range(1, 18))
def test_decode_route_takes_the_kernel_s_geometries(hd, rep):
    """The fused decode runs where the kernel takes the geometry: head_dim
    a multiple of 32 up to 256, up to 16 query heads per KV head (8 above
    head_dim 128) and a block's shared memory within 227 KB, which grows
    with the gap until it passes; everywhere else cache.update."""
    fits = hd % 32 == 0 and 32 <= hd <= 256 and rep <= (
        16 if hd <= 128 else 8)
    last = 0
    for gap in (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
        for bits, v_group, rank in ((4, 8, 0), (2, 128, 2), (8, 32, 1)):
            Gh = hd // min(v_group, hd)
            smem = qa.smem_bytes(rep, hd, gap, Gh, rank)
            want = fits and smem <= qa.MAX_SMEM_BYTES == 227 * 1024
            assert qa.decode_route(hd, rep, gap, bits, v_group, rank) == (
                "fused" if want else "update")
        assert smem > last
        last = smem
    if fits:                       # a short gap fits, the longest does not
        assert qa.decode_route(hd, rep, 8, 4, 8) == "fused"
        assert qa.decode_route(hd, rep, 4096, 4, 8) == "update"


def test_decode_route_refuses_bits_and_gaps_the_kernel_does_not_pack():
    assert qa.decode_route(128, 4, 64, 4, 128) == "fused"
    assert qa.decode_route(128, 4, 64, 3, 128) == "update"
    assert qa.decode_route(128, 4, 6, 2, 128) == "update"   # gap % 4
    assert qa.decode_route(128, 4, 6, 4, 128) == "fused"


def test_smem_bytes_is_the_kernel_s_layout():
    """Smem of csrc/quant_attention.cu at the Llama-3-8B decode (head_dim
    128, 4 query heads per KV head, gap 64, per-token V scales), by hand
    in floats: q 512, keys 64 x 129 (over the 4 x 4 x 128 reduction), 256
    logits, 64 x 4 probabilities, 2 x 64 V scales, 3 x 4 running values;
    with rank 2, 2 x 64 low-rank q values each for K and V and 4 x 2
    products more."""
    assert qa.smem_bytes(4, 128, 64, 1, 0) == 4 * (
        512 + 64 * 129 + 256 + 256 + 128 + 12) == 37680
    assert qa.smem_bytes(4, 128, 64, 1, 2) == 37680 + 4 * (256 + 8)
