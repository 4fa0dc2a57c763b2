"""Port Llama (microscopiq_tpu_torch.models) against the JAX model on the
same weights (LlamaConfig.tiny): weights are made with numpy, handed to JAX,
packed by the JAX package where packed, and moved to the port by
convert.params_from_jax. The JAX model runs with use_pallas=False, which
routes PackedMX to dequant_matmul_reference, as the JAX tests run it.

Tolerances:
- float32 logits: 1e-4 of max |logit|. Same algorithm in float32; XLA and
  torch differ in reduction order and in the last ulp of pow/sin/cos
  (measured ~5e-7 relative).
- bfloat16 logits: 3e-2 of max |logit|. Every layer rounds activations to
  bf16 (2^-8 relative) at ~10 points, and a flipped rounding propagates
  (measured ~1.2e-2).
- greedy tokens: identical in float32 over 32 decode steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.eval.generate import generate as j_generate
from microscopiq_tpu.models import LlamaConfig as JConfig
from microscopiq_tpu.models import LlamaForCausalLM as JModel
from microscopiq_tpu.nn import fuse_projections as j_fuse
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval.generate import generate
from microscopiq_tpu_torch.kv.cache import DenseDecodeCache, init_dense_cache
from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from microscopiq_tpu_torch.nn import fuse_projections

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def numpy_tree(cfg, seed=0):
    """Unfused flax-named weights; kernels N(0, 1/K) so logits are well
    separated (no near-ties for greedy decode)."""
    rng = np.random.default_rng(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def k(shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])
                ).astype(np.float32)

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


@jax.jit
def _pack_fp6(w):
    return jpk.to_serving_layout(jpk.pack_mx(w, 8, "fp6_e3m2", 32, axis=0,
                                             transport="emi8"))


def jax_tree(tree, dtype, packed):
    """The numpy tree as JAX arrays of ``dtype``; with ``packed`` every
    kernel is MX-FP6 emi8 (block 32) in the serving layout, as bench.py."""
    def visit(node, key=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if packed and key == "kernel":
            return _pack_fp6(jnp.asarray(node))
        return jnp.asarray(node, dtype)
    return visit(tree)


def jax_to_numpy(tree):
    """JAX tree -> numpy leaves; PackedMX -> the dict params_from_jax
    takes."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, jpk.PackedMX):
        return {f.name: (np.asarray(getattr(tree, f.name))
                         if f.name in ("codes", "scale_exp")
                         else getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def model_pair(dtype="float32", packed=True, fused=True, seed=0):
    """(JAX model, JAX params, port model) on identical weights."""
    jd, td = DTYPES[dtype]
    jcfg = JConfig.tiny(dtype=jd, fused_projections=fused)
    params = jax_tree(numpy_tree(jcfg, seed), jd, packed)
    if fused:
        params = j_fuse(params)
    tcfg = LlamaConfig.tiny(dtype=td, fused_projections=fused)
    port = LlamaForCausalLM(tcfg, device="cpu").load_params(
        params_from_jax(jax_to_numpy(params), device="cpu"))
    return JModel(jcfg, use_pallas=False), {"params": params}, port


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype,packed,fused", [
    ("float32", False, False), ("float32", True, True),
    ("bfloat16", True, True), ("bfloat16", False, True)])
def test_logits_match_jax(dtype, packed, fused):
    jm, jp, tm = model_pair(dtype, packed, fused)
    ids = np.random.default_rng(1).integers(0, 256, (2, 12))
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(ids)), np.float32)
    with torch.inference_mode():
        got = tm(torch.as_tensor(ids))
    assert got.dtype == DTYPES[dtype][1]
    assert _rel(got.float().numpy(), want) < TOL[dtype]
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      want.argmax(-1))


def test_fuse_projections_matches_jax_and_is_exact():
    jcfg = JConfig.tiny()
    params = jax_tree(numpy_tree(jcfg), jnp.float32, packed=True)
    fused_j = params_from_jax(jax_to_numpy(j_fuse(params)), device="cpu")
    unfused = params_from_jax(jax_to_numpy(params), device="cpu")
    fused_t = fuse_projections(unfused)
    assert "q_proj" in unfused["model"]["layers_0"]["self_attn"]
    for i in range(jcfg.num_hidden_layers):
        for grp, name in (("self_attn", "qkv_proj"), ("mlp", "gate_up_proj")):
            a = fused_t["model"][f"layers_{i}"][grp][name]["kernel"]
            b = fused_j["model"][f"layers_{i}"][grp][name]["kernel"]
            assert torch.equal(a.codes, b.codes)
            assert torch.equal(a.scale_exp, b.scale_exp)
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 9)))
    m0 = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").load_params(
        unfused)
    m1 = LlamaForCausalLM(LlamaConfig.tiny(fused_projections=True),
                          device="cpu").load_params(fused_t)
    with torch.inference_mode():
        assert torch.equal(m0(ids), m1(ids))


def test_cached_prefill_and_decode_match_jax():
    """last_only prefill through the dense cache, then decode steps, with
    left-padded rows (the per-row ``offset`` mask)."""
    from microscopiq_tpu.kv.cache import DenseDecodeCache as JCache
    from microscopiq_tpu.kv.cache import init_dense_cache as j_init

    jm, jp, tm = model_pair("float32", packed=True, fused=True)
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, (3, 10))
    offset = np.array([0, 3, 6], np.int32)
    pos = np.maximum(np.arange(10)[None] - offset[:, None], 0)
    jst = j_init(cfg.num_hidden_layers, 3, 32, cfg.num_key_value_heads,
                 cfg.head_dim, offset=jnp.asarray(offset))
    tst = init_dense_cache(cfg.num_hidden_layers, 3, 32,
                           cfg.num_key_value_heads, cfg.head_dim,
                           offset=torch.as_tensor(offset), device="cpu")
    @jax.jit
    def j_step(ids, pos, state):
        c = JCache(state)
        out = jm.apply(jp, ids, positions=pos, cache=c,
                       last_only=ids.shape[1] > 1)
        return out, c.finalize()

    want, jst = j_step(jnp.asarray(ids), jnp.asarray(pos), jst)
    tc = DenseDecodeCache(tst)
    with torch.inference_mode():
        got = tm(torch.as_tensor(ids), positions=torch.as_tensor(pos),
                 cache=tc, last_only=True)
    assert got.shape == (3, 1, 256)
    assert _rel(got.numpy(), want) < TOL["float32"]
    tst = tc.finalize()
    assert int(tst.length) == int(jst.length) == 10
    tok = np.asarray(want).argmax(-1)
    for step in range(3):
        p = (10 + step - offset)[:, None]
        want, jst = j_step(jnp.asarray(tok), jnp.asarray(p), jst)
        tc = DenseDecodeCache(tst)
        with torch.inference_mode():
            got = tm(torch.as_tensor(tok), positions=torch.as_tensor(p),
                     cache=tc)
        assert _rel(got.numpy(), want) < TOL["float32"]
        tst = tc.finalize()
        tok = np.asarray(want).argmax(-1)


def test_greedy_32_steps_identical_to_jax_left_padded():
    jm, jp, tm = model_pair("float32", packed=True, fused=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (5, 9, 7)]
    want = j_generate(jm, jp, prompts, 32, cache_kind="dense")
    got = generate(tm, prompts, 32)
    assert got.shape == (3, 32)
    np.testing.assert_array_equal(got, want)


def test_logit_index_gathers_before_lm_head():
    _, _, tm = model_pair("float32", packed=True, fused=True)
    ids = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (2, 8)))
    with torch.inference_mode():
        full = tm(ids)
        picked = tm(ids, logit_index=[3, 7])
    torch.testing.assert_close(picked[:, 0], full[[0, 1], [3, 7]],
                               rtol=0, atol=1e-5)


def test_out_of_slice_branches_name_their_roadmap_item():
    # the other families (queue 1 item 10) are ported: they build; only
    # Mixtral with fused projections, which no tree can serve, raises
    for kw in ({"pos_emb": "alibi"}, {"sliding_window": 16},
               {"num_local_experts": 4}, {"tie_word_embeddings": True}):
        LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    with pytest.raises(ValueError, match="experts"):
        LlamaForCausalLM(LlamaConfig.tiny(num_local_experts=4,
                                          fused_projections=True),
                         device="cpu")
    # the fake-quant branch (queue 1 item 9) is ported: it builds and runs
    from microscopiq_tpu_torch.models.llama import build_params
    from microscopiq_tpu_torch.specs import finalize_mx_specs
    specs = finalize_mx_specs({"w_elem_format": "fp6_e3m2",
                               "a_elem_format": "fp6_e3m2", "block_size": 32,
                               "bfloat": 16})
    fq = LlamaForCausalLM(LlamaConfig.tiny(), mx_specs=specs,
                          device="cpu").load_params(
        build_params(LlamaConfig.tiny(), device="cpu"))
    logits = fq(torch.zeros(1, 4, dtype=torch.long))
    assert logits.shape == (1, 4, 256) and bool(torch.isfinite(logits).all())
    # the outlier formats are in the slice now: an incomplete outlier leaf
    # names what it lacks, and a kernel of no known type raises
    with pytest.raises(KeyError, match="out_pos"):
        params_from_jax({"lm_head": {"kernel": {"inlier": {},
                                                "out_codes": 0}}},
                        device="cpu")
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    m.lm_head.kernel = object()
    with pytest.raises(TypeError, match="packed weight"):
        m.lm_head(torch.zeros(1, 64))
