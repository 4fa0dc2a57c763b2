"""The dense KV cache with its length on the device, and the decode step
that a CUDA model captures in a CUDA graph (``DecodeStep``), on the
CPU against the JAX package and against the eager loop (LlamaForCausalLM
tiny, float32; greedy tokens identical).

On the CPU every call of the step runs it eagerly; the card test
``test_graph_decode_is_bit_identical_to_eager`` in
tests/test_torch_kernels_gpu.py replays the captured graph.
"""

import numpy as np
import pytest
import torch

from microscopiq_tpu.eval.generate import generate as j_generate
from microscopiq_tpu_torch.eval.generate import (DecodeStep, generate,
                                                 pad_prompts)
from microscopiq_tpu_torch.kv.cache import (DenseDecodeCache,
                                            check_dense_room,
                                            init_dense_cache)
from test_torch_llama import model_pair


@pytest.fixture(scope="module")
def pair():
    return model_pair("float32", packed=True, fused=True)


def _cache(model, B, max_len, offset=None):
    cfg = model.cfg
    return init_dense_cache(cfg.num_hidden_layers, B, max_len,
                            cfg.num_key_value_heads, cfg.head_dim,
                            offset=offset, device="cpu")


def _prefill(model, ids, offset, max_len):
    """last_only prefill of left-padded ids: (state, first greedy token)."""
    B, S = ids.shape
    state = _cache(model, B, max_len, offset)
    pos = torch.clamp(torch.arange(S)[None, :] - offset[:, None], min=0)
    cache = DenseDecodeCache(state)
    with torch.inference_mode():
        logits = model(ids, positions=pos, cache=cache, last_only=True)
    return cache.finalize(), torch.argmax(logits[:, -1], dim=-1)


@pytest.mark.parametrize("lens", [(5, 9, 7), (6, 6), (1, 12, 3, 8)])
def test_device_length_decodes_jax_tokens(pair, lens):
    """generate over the dense cache (length a 0-d int32 tensor) gives JAX's
    greedy tokens, ragged left-padded prompts included."""
    jm, jp, tm = pair
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in lens]
    want = j_generate(jm, jp, prompts, 12, cache_kind="dense")
    got = generate(tm, prompts, 12)
    np.testing.assert_array_equal(got, want)


def test_length_is_a_device_tensor_advanced_in_place(pair):
    """update writes at the device length; finalize advances that same
    tensor (and its host mirror) once per step, however many layers wrote
    at the same start."""
    _, _, tm = pair
    ids, lens = pad_prompts([[3, 4, 5], [7, 8, 9, 10, 11]])
    offset = torch.as_tensor(ids.shape[1] - lens)
    state, tok = _prefill(tm, torch.as_tensor(ids), offset, 16)
    length = state.length
    assert length.shape == () and length.dtype == torch.int32
    assert int(length) == state.host_length == 5
    step = DecodeStep(tm, state, tok)
    with torch.inference_mode():
        for i in range(3):
            step()
            assert step.state.length is length
            assert int(length) == state.host_length == 6 + i
    # the prompt's slots and the three written ones hold K, later ones none
    k = state.k[0, 1, :, 0, 0]
    assert bool((k[:8] != 0).all()) and not bool(k[8:].any())


@pytest.mark.parametrize("lens", [(5, 9, 7), (4, 4)])
def test_step_run_eagerly_gives_the_eager_loop_s_tokens(pair, lens):
    """DecodeStep, run as the card captures it but eagerly, decodes the
    tokens of the loop it replaces: a fresh DenseDecodeCache a step, host
    positions, argmax of the logits."""
    _, _, tm = pair
    rng = np.random.default_rng(len(lens))
    ids, plens = pad_prompts([rng.integers(0, 256, (n,)).tolist()
                              for n in lens])
    ids = torch.as_tensor(ids)
    offset = torch.as_tensor(ids.shape[1] - plens)
    S, steps = ids.shape[1], 10

    state, tok = _prefill(tm, ids, offset, 32)
    want = []
    with torch.inference_mode():
        for i in range(steps):
            cache = DenseDecodeCache(state)
            pos = (S + i - offset)[:, None]
            logits = tm(tok[:, None], positions=pos, cache=cache)
            state = cache.finalize()
            tok = torch.argmax(logits[:, -1], dim=-1)
            want.append(tok)
    want_logits = logits

    state, tok = _prefill(tm, ids, offset, 32)
    step = DecodeStep(tm, state, tok)
    got = []
    with torch.inference_mode():
        for _ in range(steps):
            got.append(step.eager().clone())
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert torch.equal(step.logits, want_logits)


def test_write_past_the_store_raises_from_the_host_mirror(pair):
    """The overflow check reads the host mirror: a full mirror raises
    before anything is written, whatever the device length says, and a
    step whose write would fit goes through."""
    _, _, tm = pair
    ids = torch.as_tensor(np.random.default_rng(9).integers(0, 256, (2, 6)))
    state, tok = _prefill(tm, ids, torch.zeros(2, dtype=torch.int32), 8)
    step = DecodeStep(tm, state, tok)
    with torch.inference_mode():
        step()
        step()
        assert state.host_length == int(state.length) == 8
        k_before = state.k.clone()
        with pytest.raises(ValueError, match="8 slots; 8 used, 1 more"):
            step()
        assert torch.equal(state.k, k_before)
        assert int(state.length) == 8
        # the mirror, not the device tensor, decides
        state.length.zero_()
        with pytest.raises(ValueError, match="8 slots"):
            check_dense_room(state, 1)
        state.host_length = 7
        check_dense_room(state, 1)
        with pytest.raises(ValueError, match="8 slots; 7 used, 2 more"):
            DenseDecodeCache(state).update(0, torch.zeros(2, 2, 2, 16),
                                           torch.zeros(2, 2, 2, 16),
                                           torch.zeros(2, 2), None)


def test_capture_needs_a_cuda_model(pair):
    """On the CPU the step never captures: every call is eager."""
    _, _, tm = pair
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (1, 4)))
    state, tok = _prefill(tm, ids, torch.zeros(1, dtype=torch.int32), 12)
    step = DecodeStep(tm, state, tok)
    with torch.inference_mode():
        for _ in range(3):
            step()
    assert not step.graphs and state.host_length == 7
