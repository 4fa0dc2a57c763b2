"""The port's other model families (Mistral's sliding window, Mixtral's MoE,
MPT's ALiBi, LayerNorm, GELU MLP and tied embeddings) against HF
``transformers`` (mirroring tests/test_models.py:54-128) and against the
JAX package's LlamaForCausalLM on the same weights, dense and packed.

Tolerances:
- against HF transformers: rtol = atol = 2e-3, the bound of
  tests/test_models.py (float32; HF and the port reduce in other orders);
- the MPT decode through the cache against the full prefill: 2e-4, the
  bound of tests/test_models.py::test_mpt_decode_cache_matches_prefill;
- ALiBi slopes against JAX: 3e-7 relative (one float32 ulp: XLA's and
  torch's exp2 round differently);
- against JAX in float32, dense: 1e-4 of max |logit| (tests/
  test_torch_llama.py: same algorithm, XLA and torch differ in reduction
  order and the last ulp of exp/pow/sin/cos/erf);
- against JAX, MX-FP6 packed (the packed kernels' plain twin on both
  sides): 3e-2 of max |logit|, the bf16 bound of tests/test_torch_llama.py,
  because a packed linear rounds its input to bf16 and an ulp apart before
  that rounding can flip it (2^-8 relative), which then propagates
  (measured 1.5e-4 for Mixtral, 6.5e-4 for MPT: the expert mix and the
  exact GELU add rounding points); greedy argmax identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.models import LlamaConfig as JConfig
from microscopiq_tpu.models import LlamaForCausalLM as JModel
from microscopiq_tpu.nn import fuse_projections as j_fuse
from microscopiq_tpu.nn import pack_params as j_pack
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.specs import finalize_mx_specs as j_specs
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.kv.cache import DenseDecodeCache, init_dense_cache
from microscopiq_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                          build_params, convert_llama,
                                          convert_mpt,
                                          state_dict_from_torch_model)
from microscopiq_tpu_torch.models.llama import alibi_slopes, causal_mask
from microscopiq_tpu_torch.nn import fuse_projections, pack_params
from microscopiq_tpu_torch.specs import finalize_mx_specs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread a core makes the workers' training and
    matmuls contend for the cores (a 10x slowdown inside the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SPECS = {"w_elem_format": "fp6_e3m2", "scale_bits": 8, "block_size": 32}


def _hf_state(hf):
    return state_dict_from_torch_model(hf, device="cpu")


def test_mpt_vs_hf_transformers():
    from transformers import MptConfig as HFMptConfig
    from transformers import MptForCausalLM as HFMpt

    hf_cfg = HFMptConfig(d_model=64, n_heads=4, n_layers=2, vocab_size=128,
                         max_seq_len=64, attn_implementation="eager")
    torch.manual_seed(0)
    hf = HFMpt(hf_cfg).eval()
    cfg = LlamaConfig.tiny_mpt(vocab_size=128, hidden_size=64,
                               intermediate_size=256, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=4)
    model = LlamaForCausalLM(cfg, device="cpu").load_params(
        convert_mpt(_hf_state(hf), cfg))
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 128, (2, 12)))
    with torch.no_grad():
        want = hf(ids).logits
        got = model(ids)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_mixtral_vs_hf_transformers():
    from transformers import MixtralConfig as HFMixConfig
    from transformers import MixtralForCausalLM as HFMix

    hf_cfg = HFMixConfig(vocab_size=128, hidden_size=64,
                         intermediate_size=112, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         num_local_experts=4, num_experts_per_tok=2,
                         max_position_embeddings=64, rms_norm_eps=1e-5,
                         rope_theta=1e6, sliding_window=None,
                         attn_implementation="eager",
                         tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = HFMix(hf_cfg).eval()
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=112,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64,
                      rope_theta=1e6, num_local_experts=4,
                      num_experts_per_tok=2)
    model = LlamaForCausalLM(cfg, device="cpu").load_params(
        convert_llama(_hf_state(hf), cfg))
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 128, (2, 12)))
    with torch.no_grad():
        want = hf(ids).logits
        got = model(ids)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


def test_mistral_sliding_window_vs_hf_transformers():
    """A window of 4 over 12 tokens bites: the cacheless forward must match
    HF Mistral's windowed eager attention."""
    from transformers import MistralConfig as HFMisConfig
    from transformers import MistralForCausalLM as HFMis

    hf_cfg = HFMisConfig(vocab_size=128, hidden_size=64,
                         intermediate_size=112, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=64, rms_norm_eps=1e-5,
                         sliding_window=4, attn_implementation="eager",
                         tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = HFMis(hf_cfg).eval()
    cfg = LlamaConfig.tiny(vocab_size=128, intermediate_size=112,
                           max_position_embeddings=64, sliding_window=4)
    model = LlamaForCausalLM(cfg, device="cpu").load_params(
        convert_llama(_hf_state(hf), cfg))
    wide = LlamaForCausalLM(dataclasses.replace(cfg, sliding_window=None),
                            device="cpu").load_params(
        convert_llama(_hf_state(hf), cfg))
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 128, (2, 12)))
    with torch.no_grad():
        want = hf(ids).logits
        got = model(ids)
        unwindowed = wide(ids)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    assert (unwindowed - want).abs().max() > 1e-2      # the window bites


def test_mpt_decode_cache_matches_prefill():
    cfg = LlamaConfig.tiny_mpt()
    model = LlamaForCausalLM(cfg, device="cpu").load_params(
        build_params(dataclasses.replace(cfg, dtype=torch.float32),
                     device="cpu"))
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (1, 10)))
    with torch.no_grad():
        full = model(ids).float()
        state = init_dense_cache(cfg.num_hidden_layers, 1, 16,
                                 cfg.num_key_value_heads, cfg.head_dim,
                                 dtype=torch.float32, device="cpu")
        steps = []
        for t in range(10):
            cache = DenseDecodeCache(state)
            out = model(ids[:, t:t + 1], positions=torch.tensor([[t]]),
                        cache=cache)
            state = cache.finalize()
            steps.append(out[:, 0].float())
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=2e-4,
                               atol=2e-4)


def test_mistral_sliding_window_mask():
    cfg = LlamaConfig.tiny(sliding_window=8)
    model = LlamaForCausalLM(cfg, device="cpu").load_params(
        build_params(cfg, device="cpu"))
    logits = model(torch.zeros((1, 32), dtype=torch.long))
    assert torch.isfinite(logits).all()
    pos = torch.arange(6)[None]
    m = causal_mask(6, pos, 2)[0, 0]
    assert m.tolist() == [[j <= i and j > i - 2 for j in range(6)]
                          for i in range(6)]


def test_mixtral_moe_forward():
    cfg = LlamaConfig.tiny(num_local_experts=4, num_experts_per_tok=2)
    tree = build_params(cfg, device="cpu")
    model = LlamaForCausalLM(cfg, device="cpu").load_params(tree)
    logits = model(torch.zeros((1, 8), dtype=torch.long))
    assert torch.isfinite(logits).all()
    assert "experts_0" in tree["params"]["model"]["layers_0"][
        "block_sparse_moe"]


def test_alibi_slopes_match_jax():
    """Equal to the last ulp: XLA's and torch's exp2 round differently."""
    from microscopiq_tpu.models.llama import alibi_slopes as j_slopes

    for h in (1, 4, 6, 12, 32):
        np.testing.assert_allclose(alibi_slopes(h).numpy(),
                                   np.asarray(j_slopes(h)), rtol=3e-7)


# ---------------------------------------------------------------------------
# Against the JAX package, dense and packed
# ---------------------------------------------------------------------------
FAMILIES = {
    "llama2": dict(),
    "mistral": dict(sliding_window=4),
    "mixtral": dict(num_local_experts=4, num_experts_per_tok=2),
    "mpt": "tiny_mpt",
}


def _jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, jpk.PackedMX):
        return {f.name: (np.asarray(getattr(tree, f.name))
                         if f.name in ("codes", "scale_exp")
                         else getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def _configs(family, fused):
    kw = FAMILIES[family]
    if kw == "tiny_mpt":
        return (JConfig.tiny_mpt(fused_projections=fused),
                LlamaConfig.tiny_mpt(fused_projections=fused))
    return (JConfig.tiny(fused_projections=fused, **kw),
            LlamaConfig.tiny(fused_projections=fused, **kw))


def _pair(family, packed, fused):
    jcfg, tcfg = _configs(family, fused)
    jm = JModel(jcfg, use_pallas=False)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32)
                     )["params"]
    # spread the weights so logits separate (N(0, 0.02) leaves near-ties)
    params = jax.tree_util.tree_map(lambda a: a * 25.0 if a.ndim == 2
                                    else a, params)
    if packed:
        params = j_pack(params, j_specs(dict(SPECS)))
    if fused:
        params = j_fuse(params)
    tm = LlamaForCausalLM(tcfg, device="cpu").load_params(
        params_from_jax(_jax_to_numpy(params), device="cpu"))
    return jm, {"params": params}, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_family_logits_match_jax(family, packed):
    fused = family != "mixtral"
    jm, jp, tm = _pair(family, packed, fused)
    ids = np.random.default_rng(5).integers(0, 256, (2, 12))
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(ids)), np.float32)
    with torch.inference_mode():
        got = tm(torch.as_tensor(ids)).numpy()
    assert _rel(got, want) < (3e-2 if packed else 1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_mixtral_router_choices_match_jax():
    """Where the router's logits are distinct, the chosen experts are
    JAX's (lax.top_k and torch.topk may order ties differently)."""
    jm, jp, tm = _pair("mixtral", packed=False, fused=False)
    x = np.random.default_rng(6).standard_normal((2, 12, 64)
                                                 ).astype(np.float32)
    gate = jp["params"]["model"]["layers_0"]["block_sparse_moe"]["gate"][
        "kernel"]
    logits = x @ np.asarray(gate)
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits), 2)[1])
    moe = tm.model.layers[0].block_sparse_moe
    with torch.inference_mode():
        w, sel = moe.route(torch.as_tensor(x))
    srt = np.sort(logits, -1)
    distinct = np.all(np.diff(srt, axis=-1) > 1e-6, axis=-1)
    assert distinct.mean() > 0.9
    np.testing.assert_array_equal(sel.numpy()[distinct], want[distinct])
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_pack_and_fuse_the_new_trees_like_jax():
    """pack_params packs the router and every expert like JAX; the tied
    MPT tree has no lm_head and keeps its embedding dense;
    fuse_projections fuses MPT's attention only, and no expert."""
    for family in ("mixtral", "mpt"):
        jcfg, tcfg = _configs(family, False)
        jm = JModel(jcfg, use_pallas=False)
        params = jm.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
        tree = params_from_jax(_jax_to_numpy(params), device="cpu")
        specs = finalize_mx_specs(dict(SPECS))
        got = fuse_projections(pack_params(tree, specs))
        want = params_from_jax(_jax_to_numpy(
            j_fuse(j_pack(params, j_specs(dict(SPECS))))), device="cpu")

        def walk(a, b, path=""):
            assert a.keys() == b.keys(), path
            for k in a:
                if isinstance(a[k], dict):
                    walk(a[k], b[k], f"{path}/{k}")
                elif isinstance(a[k], torch.Tensor):
                    assert torch.equal(a[k], b[k]), f"{path}/{k}"
                else:
                    assert torch.equal(a[k].codes, b[k].codes), f"{path}/{k}"
                    assert torch.equal(a[k].scale_exp, b[k].scale_exp)

        walk(got, want)
        layer = got["model"]["layers_0"]
        assert "qkv_proj" in layer["self_attn"]
        if family == "mpt":
            assert "lm_head" not in got
            assert isinstance(got["model"]["embed_tokens"], torch.Tensor)
            assert set(layer["mlp"]) == {"up_proj", "down_proj"}
        else:
            assert "gate_proj" in layer["block_sparse_moe"]["experts_0"]
            assert layer["block_sparse_moe"]["gate"]["kernel"].codes.shape[
                -1] == 4


def test_build_params_families_install():
    """Each family's seeded build_params tree installs in its model, packed
    and dense; the Llama tree is unchanged by the other families' keys."""
    specs = finalize_mx_specs(dict(SPECS))
    for family in FAMILIES:
        _, tcfg = _configs(family, False)
        for ps in (None, specs):
            tree = build_params(tcfg, seed=1, packed_specs=ps, device="cpu")
            m = LlamaForCausalLM(tcfg, device="cpu").load_params(tree)
            assert torch.isfinite(m(torch.zeros((1, 4), dtype=torch.long))
                                  .float()).all()
            assert ("lm_head" in tree["params"]) == (family != "mpt")
