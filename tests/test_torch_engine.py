"""Port BatchEngine (continuous batching over dense KV slots and H2O slots):
greedy tokens equal single-sequence decode and the JAX BatchEngine on the
same weights (float32, LlamaConfig.tiny with packed MX-FP6 fused
projections), with slot reuse, mid-flight admission, EOS and rejection
behaviour as in tests/test_engine.py; and temperature sampling in
``generate``. Token comparisons are exact; sampled draws are held to the
softmax's frequencies within five standard errors."""

import numpy as np
import pytest

import torch

from microscopiq_tpu.eval.generate import generate as j_generate
from microscopiq_tpu.serve.engine import BatchEngine as JEngine
from microscopiq_tpu_torch.eval.generate import generate, sample_logits
from microscopiq_tpu_torch.serve.engine import BatchEngine, Request, _bucket
from test_torch_llama import model_pair


@pytest.fixture(scope="module")
def models():
    return model_pair("float32", packed=True, fused=True)


def _single(model, prompt, n):
    return generate(model, [list(prompt)], n)[0].tolist()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (s,)).astype(np.int32) for s in lens]


def test_engine_matches_single_sequence_and_jax(models):
    jm, jp, tm = models
    prompts = _prompts(0, (5, 11, 8, 14, 3))
    got = BatchEngine(tm, n_slots=2, max_len=64, prompt_buckets=(8, 16),
                      device="cpu").generate(prompts, max_new_tokens=6)
    want = JEngine(jm, jp, n_slots=2, max_len=64,
                   prompt_buckets=(8, 16)).generate(prompts,
                                                    max_new_tokens=6)
    assert got == want
    for p, g in zip(prompts, got):
        assert g == _single(tm, p, 6)


def test_engine_mid_flight_admission(models):
    _, _, tm = models
    p1, p2 = _prompts(2, (6, 9))
    eng = BatchEngine(tm, n_slots=4, max_len=64, prompt_buckets=(16,),
                      device="cpu")
    r1 = Request(p1, max_new_tokens=8)
    eng.submit(r1)
    eng.step()
    eng.step()                          # r1 is 3 tokens in
    r2 = Request(p2, max_new_tokens=5)
    eng.submit(r2)                      # joins while r1 decodes
    eng.run_until_drained()
    assert r1.out_tokens == _single(tm, p1, 8)
    assert r2.out_tokens == _single(tm, p2, 5)


def test_engine_eos_stream_and_rejection(models):
    _, _, tm = models
    (p,) = _prompts(3, (5,))
    ref = _single(tm, p, 8)
    seen = []
    r = Request(p, max_new_tokens=8, eos_id=ref[2],
                on_token=lambda t, d: seen.append((t, d)))
    too_long = Request(np.zeros(20, np.int32), max_new_tokens=4)
    eng = BatchEngine(tm, n_slots=1, max_len=64, prompt_buckets=(8,),
                      device="cpu")
    eng.submit(too_long)
    eng.submit(r)
    eng.run_until_drained()
    assert too_long.done and "exceeds largest bucket" in too_long.error
    assert r.out_tokens == ref[:ref.index(ref[2]) + 1]
    assert [t for t, _ in seen] == r.out_tokens and seen[-1][1]


def test_engine_temperature_sampling_is_seeded(models):
    _, _, tm = models
    prompts = _prompts(4, (5, 7))

    def run(seed):
        eng = BatchEngine(tm, n_slots=2, max_len=64, prompt_buckets=(8,),
                          seed=seed, device="cpu")
        return eng.generate(prompts, max_new_tokens=5, temperature=1.0)

    a, b = run(0), run(0)
    assert a == b
    assert all(0 <= t < 256 for out in a for t in out)


def test_engine_rejects_unported_cache_kinds(models):
    _, _, tm = models
    # every cache kind of the JAX engine is ported; others are refused
    eng = BatchEngine(tm, cache_kind="h2o", device="cpu")
    assert eng.state.k.shape[2] == 256             # the largest bucket
    with pytest.raises(ValueError, match="under the largest prompt bucket"):
        BatchEngine(tm, cache_kind="h2o", h2o_budget=100, device="cpu")
    with pytest.raises(ValueError, match="unknown cache_kind"):
        BatchEngine(tm, cache_kind="paged", device="cpu")
    assert _bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError):
        _bucket(17, (8, 16))


def _jax_single(jm, jp, prompt, n):
    return j_generate(jm, jp, np.asarray(prompt, np.int32)[None], n)[
        0].tolist()


def test_engine_h2o_unconstrained_budget_matches_dense(models):
    """A budget that never evicts: the H2O engine's tokens equal the dense
    engine's, single-sequence decode's and the JAX H2O engine's."""
    jm, jp, tm = models
    prompts = _prompts(7, (5, 11, 8))
    kw = dict(n_slots=4, max_len=64, prompt_buckets=(16,))
    got = BatchEngine(tm, cache_kind="h2o", h2o_budget=48, device="cpu",
                      **kw).generate(prompts, max_new_tokens=6)
    want = JEngine(jm, jp, cache_kind="h2o", h2o_budget=48,
                   **kw).generate(prompts, max_new_tokens=6)
    assert got == want
    assert got == BatchEngine(tm, device="cpu", **kw).generate(
        prompts, max_new_tokens=6)
    for p, g in zip(prompts, got):
        assert g == _single(tm, p, 6)


def test_engine_h2o_slot_reuse_and_tight_budget(models):
    """Every request evicts (prompt + new > budget) through slot reuse;
    every request is answered in full, with the JAX engine's tokens."""
    jm, jp, tm = models
    prompts = _prompts(8, (14, 15, 13, 16, 12))
    kw = dict(n_slots=2, max_len=64, prompt_buckets=(16,),
              cache_kind="h2o", h2o_budget=16, h2o_recent=4)
    eng = BatchEngine(tm, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=8)
    assert all(len(o) == 8 for o in got)
    assert all(len(p) + 8 > 16 for p in prompts)
    assert got == JEngine(jm, jp, **kw).generate(prompts, max_new_tokens=8)
    assert int(eng.state.pos.max()) >= 16           # slots were overwritten


def test_engine_h2o_per_slot_depth_independence(models):
    """A late short request decodes as it would alone beside a deep slot."""
    jm, jp, tm = models
    long_p, short_p = _prompts(9, (15, 4))
    eng = BatchEngine(tm, n_slots=2, max_len=64, prompt_buckets=(16,),
                      cache_kind="h2o", h2o_budget=48, device="cpu")
    r_long = Request(long_p, max_new_tokens=10)
    r_short = Request(short_p, max_new_tokens=5)
    eng.submit(r_long)
    for _ in range(3):
        eng.step()
    eng.submit(r_short)
    eng.run_until_drained()
    assert r_long.out_tokens == _jax_single(jm, jp, long_p, 10)
    assert r_short.out_tokens == _jax_single(jm, jp, short_p, 5)


def test_generate_temperature_zero_is_greedy_and_seeded_draws_repeat(models):
    _, _, tm = models
    prompts = [list(p) for p in _prompts(10, (6, 9))]
    greedy = generate(tm, prompts, 6)
    assert np.array_equal(generate(tm, prompts, 6, temperature=0.0), greedy)
    draw = lambda seed: generate(
        tm, prompts, 6, temperature=1.5,
        generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(3), draw(3), draw(4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == greedy.shape and ((a >= 0) & (a < 256)).all()
    # the default generator is seeded too
    assert np.array_equal(generate(tm, prompts, 4, temperature=1.0),
                          generate(tm, prompts, 4, temperature=1.0))


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
def test_sampled_frequencies_follow_the_softmax(temp):
    """20000 rows of the same logits at one temperature: each token's
    frequency within five standard errors of softmax(logits / t)."""
    n = 20000
    logits = torch.tensor([2.0, 1.0, 0.0, -1.0, 0.5])
    toks = sample_logits(logits.expand(n, 5), np.full(n, temp, np.float32),
                         torch.Generator().manual_seed(0))
    p = torch.softmax(logits / temp, -1).numpy()
    freq = np.bincount(toks.numpy(), minlength=5) / n
    assert (np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n)).all()
    # rows at temperature 0 stay greedy among sampled ones
    temps = np.array([0.0, temp] * 4, np.float32)
    mixed = sample_logits(logits.expand(8, 5), temps,
                          torch.Generator().manual_seed(1))
    assert (mixed[temps == 0] == 0).all()
