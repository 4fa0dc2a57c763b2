"""``microscopiq_tpu_torch.scripts.gear_compare`` against the JAX package's
``scripts/gear_compare.py`` loop on the CPU, at the script's size and on
JAX's own weights (``LlamaForCausalLM.init`` at PRNGKey(0), moved over by
``params_from_jax``).

The JAX side is the script's ``teacher_forced_nll`` loop (the script
itself writes its result into the repository, so the test runs a copy of
its loop): a jitted prefill, then a jitted step a token over
``eval.generate._make_cache``. Held per method: the decode perplexity
within 1e-4 relative of JAX's (float32 sums in other orders; the fused
route's query rounded to bf16, ROADMAP queue 3), its difference from
dense within 0.05 absolute of JAX's (that difference is ~0.3% of the
perplexity, so the bound is 1e-4 of the perplexity with room for the
dense run's own error), the argmax agreement with dense within 0.02 of
JAX's (argmax ties of random weights), both compression ratios equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.models import LlamaForCausalLM
from microscopiq_tpu_torch.scripts import gear_compare as gc

PPL_RTOL = 1e-4
DELTA_ATOL = 0.05
AGREE_ATOL = 0.02


def jax_methods(head_dim):
    from microscopiq_tpu.kv.cache import QuantKVConfig

    q = lambda **kw: QuantKVConfig(gap=gc.GAP, v_group=head_dim, **kw)
    return {"dense": None, "KIVI": q(bits=4),
            "GEARL-KIVI-r2": q(bits=4, rank=2),
            "GEARL-KIVI-r4": q(bits=4, rank=4),
            "GEARS-KIVI": q(bits=4, out_k=8),
            "GEARSL-KIVI": q(bits=4, rank=2, out_k=8),
            "KIVI-2bit": q(bits=2), "GEARL-2bit-r4": q(bits=2, rank=4)}


def jax_teacher_forced(model, params, cfg, ids, S_prompt, qc):
    """``scripts/gear_compare.py``'s ``teacher_forced_nll``."""
    from microscopiq_tpu.eval.generate import _make_cache

    Bn, L = ids.shape
    max_len = (L // gc.GAP + 2) * gc.GAP
    state, wrap = _make_cache("dense" if qc is None else "quant", cfg, Bn,
                              max_len, qc)

    @jax.jit
    def prefill(params, chunk, state):
        cache = wrap(state)
        positions = jnp.arange(chunk.shape[1])[None, :]
        logits = model.apply(params, chunk, positions=positions, cache=cache)
        return logits[:, -1], cache.finalize()

    @jax.jit
    def step(params, tok, state):
        cache = wrap(state)
        positions = state.length[None, None] if state.length.ndim == 0 \
            else state.length[:, None]
        logits = model.apply(params, tok, positions=positions, cache=cache)
        return logits[:, -1], cache.finalize()

    logits_last, state = prefill(params, jnp.asarray(ids[:, :S_prompt]),
                                 state)
    nll, agree = [], []
    for t in range(S_prompt, L):
        tgt = jnp.asarray(ids[:, t])
        lp = jax.nn.log_softmax(logits_last.astype(jnp.float32), -1)
        nll.append(-np.asarray(lp[jnp.arange(Bn), tgt]))
        agree.append(np.asarray(jnp.argmax(logits_last, -1)))
        if t < L - 1:
            logits_last, state = step(params, tgt[:, None], state)
    return float(np.mean(nll)), np.stack(agree, 1)


def jax_ratios(cfg, qc):
    from microscopiq_tpu.kv.cache import (QuantizedDecodeCache,
                                          init_quant_cache)

    st = init_quant_cache(cfg.num_hidden_layers, gc.B, 2 * gc.GAP,
                          cfg.num_key_value_heads, cfg.head_dim, qc)
    qc8 = dataclasses.replace(qc, gap=64, v_group=128)
    st8 = init_quant_cache(1, 1, 128, 8, 128, qc8)
    return (float(QuantizedDecodeCache(st, qc).compression_ratio),
            float(QuantizedDecodeCache(st8, qc8).compression_ratio))


@pytest.fixture(scope="module")
def both():
    from microscopiq_tpu.models import LlamaConfig
    from microscopiq_tpu.models import LlamaForCausalLM as JaxLlama

    torch.set_num_threads(2)
    cfg = LlamaConfig.tiny(**gc.CFG)
    model = JaxLlama(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    ids = gc.token_ids(cfg.vocab_size)
    want = {}
    for name, qc in jax_methods(cfg.head_dim).items():
        nll, top = jax_teacher_forced(model, params, cfg, ids, gc.S_PROMPT,
                                      qc)
        want[name] = (nll, top, None if qc is None else jax_ratios(cfg, qc))
    got = gc.run("cpu", tree=params_from_jax(jax.device_get(params),
                                             device="cpu"))
    return want, got["teacher_forced_decode"]


def test_stream_is_the_scripts():
    """The script's stream: 8 tokens repeated, moved by 0-2, seed 7."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 512, (4, 8))
    ids = np.concatenate([base] * (192 // 8 + 1), axis=1)
    ids = ((ids + rng.integers(0, 3, ids.shape)) % 512)[:, :192]
    np.testing.assert_array_equal(gc.token_ids(512), ids)


@pytest.mark.parametrize("name", list(gc.methods(32)))
def test_method_matches_jax(both, name):
    want, got = both
    nll, top, ratios = want[name]
    dense_nll, dense_top, _ = want["dense"]
    row = got[name]
    ppl = float(np.exp(nll))
    delta = ppl - float(np.exp(dense_nll))
    agree = float((top == dense_top).mean())
    print(f"GEAR {name}: port {row['decode_ppl']} jax {ppl}, delta port "
          f"{row['delta_ppl_vs_dense']} jax {delta}, agreement port "
          f"{row['top1_agreement_vs_dense']} jax {agree}, {row['route']}")
    assert row["decode_ppl"] == pytest.approx(ppl, rel=PPL_RTOL)
    assert abs(row["delta_ppl_vs_dense"] - delta) <= DELTA_ATOL
    assert abs(row["top1_agreement_vs_dense"] - agree) <= AGREE_ATOL
    want_ratios = (1.0, 1.0) if ratios is None else ratios
    assert (row["kv_compression_ratio"],
            row["ratio_at_llama8b_dims"]) == want_ratios


def test_routes_follow_the_gate():
    """GEAR-S keeps its outliers in ``cache.update`` (JAX's route at this
    head_dim, which its kernel does not take); the methods without
    outliers take the fused kernel's route (its plain composition on the
    CPU)."""
    model = LlamaForCausalLM(gc.model_config(), device="cpu")
    want = {"dense": "dense", "GEARS-KIVI": "update",
            "GEARSL-KIVI": "update"}
    for name, qc in gc.methods(32).items():
        assert gc.route(model, qc) == want.get(name, "fused"), name


def test_script_on_the_cpu(tmp_path):
    """``main --device cpu --out FILE``: one JSON line, the same in the
    file; the GSM8K runs complete."""
    import json

    out = tmp_path / "gear.json"
    assert gc.main(["--device", "cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert set(res["teacher_forced_decode"]) == set(gc.methods(32))
    assert set(res["gsm8k_synthetic"]) == set(gc.GSM8K_METHODS)
    for r in res["gsm8k_synthetic"].values():
        assert r["n"] == gc.GSM8K_LIMIT and 0.0 <= r["accuracy"] <= 1.0
    for r in res["teacher_forced_decode"].values():
        assert np.isfinite(r["decode_ppl"])
