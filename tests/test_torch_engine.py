"""Port BatchEngine (continuous batching over dense KV slots): greedy tokens
equal single-sequence decode and the JAX BatchEngine on the same weights
(float32, LlamaConfig.tiny with packed MX-FP6 fused projections), with slot
reuse, mid-flight admission, EOS and rejection behaviour as in
tests/test_engine.py. Token comparisons are exact."""

import numpy as np
import pytest

from microscopiq_tpu.serve.engine import BatchEngine as JEngine
from microscopiq_tpu_torch.eval.generate import generate
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
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        BatchEngine(tm, cache_kind="h2o", device="cpu")
    with pytest.raises(ValueError, match="unknown cache_kind"):
        BatchEngine(tm, cache_kind="paged", device="cpu")
    assert _bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError):
        _bucket(17, (8, 16))
