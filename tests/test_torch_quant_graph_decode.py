"""The shared quantized KV cache with its length on the device, and the
decode step that a CUDA model captures in two CUDA graphs (``DecodeStep``:
the plain step and the step that folds a chunk), on the CPU against the
JAX package and against the eager loop (LlamaForCausalLM tiny and a
head_dim-32 variant, float32; greedy tokens identical).

- ``generate(cache_kind="quant")`` gives JAX's greedy tokens across fold
  steps, on the ``cache.update`` route (ragged left-padded prompts) and on
  the fused route (equal-length prompts: the fused path, in JAX and in the
  port, does not mask left pads; ROADMAP queue 3).
- The step as the card captures it, run eagerly, gives the tokens and
  logits of the loop it replaces (a fresh cache a step, host positions).
- The length is a 0-d int32 device tensor advanced in place once a step,
  beside its host mirror; the plain/fold choice and the overflow check
  read the mirror, never the device.

On the CPU every call of the step runs it eagerly; the card test
``test_quant_graph_decode_is_bit_identical_to_eager`` in
tests/test_torch_kernels_gpu.py replays the captured graphs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.eval.generate import generate as j_generate
from microscopiq_tpu.models import LlamaConfig as JConfig
from microscopiq_tpu.models import LlamaForCausalLM as JModel
from microscopiq_tpu.nn import fuse_projections as j_fuse
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval.generate import (DecodeStep, generate,
                                                 pad_prompts)
from microscopiq_tpu_torch.kv import cache as tc
from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from microscopiq_tpu_torch.models import llama as tllama
from test_torch_llama import jax_to_numpy, jax_tree, numpy_tree
from test_torch_quant_kv import QCFG, _cfgs


def _models(hidden):
    """(JAX model, its params, port model with kernels, port model through
    cache.update) of hidden size 64 (``tiny``, head_dim 16) or 128
    (head_dim 32, the fused route's geometry), identical weights."""
    jcfg = JConfig.tiny(hidden_size=hidden, fused_projections=True)
    params = j_fuse(jax_tree(numpy_tree(jcfg, 5), jnp.float32, True))
    tree = params_from_jax(jax_to_numpy(params), device="cpu")
    tcfg = LlamaConfig.tiny(hidden_size=hidden, dtype=torch.float32,
                            fused_projections=True)
    kern = LlamaForCausalLM(tcfg, device="cpu").load_params(tree)
    plain = LlamaForCausalLM(tcfg, use_kernels=False, device="cpu"
                             ).load_params(tree)
    return JModel(jcfg, use_pallas=False), {"params": params}, kern, plain


@pytest.fixture(scope="module")
def tiny():
    return _models(64)


@pytest.fixture(scope="module")
def wide():
    return _models(128)


def _route(model, tq):
    cfg = model.cfg
    return tllama.decode_route(cfg.head_dim,
                               cfg.num_attention_heads
                               // cfg.num_key_value_heads, tq.gap, tq.bits,
                               tq.v_group, tq.rank)


@pytest.mark.parametrize("lens", [(5, 12, 9), (3, 10)])
def test_update_route_decodes_jax_tokens_across_folds(tiny, lens):
    """Ragged left-padded prompts through cache.update (head_dim 16), 20
    steps: two or more folds at gap 8."""
    jm, jp, _, plain = tiny
    jq, tq = _cfgs(**QCFG)
    assert _route(plain, tq) == "update"
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in lens]
    want = j_generate(jm, jp, prompts, 20, cache_kind="quant", quant_cfg=jq)
    got = generate(plain, prompts, 20, cache_kind="quant", quant_cfg=tq)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S", [10, 13])
def test_fused_route_decodes_jax_tokens_across_folds(wide, monkeypatch, S):
    """Equal-length prompts through the fused decode (head_dim 32), 20
    steps: every step takes the fused branch with the device length."""
    jm, jp, kern, _ = wide
    jq, tq = _cfgs(**QCFG)
    assert _route(kern, tq) == "fused"
    lengths = []
    fused = tllama.quant_attention_decode
    monkeypatch.setattr(
        tllama, "quant_attention_decode",
        lambda q, full, li, length, *a: lengths.append(length) or fused(
            q, full, li, length, *a))
    prompts = np.random.default_rng(S).integers(0, 256, (3, S))
    want = j_generate(jm, jp, prompts, 20, cache_kind="quant", quant_cfg=jq)
    got = generate(kern, prompts, 20, cache_kind="quant", quant_cfg=tq)
    np.testing.assert_array_equal(got, want)
    assert len(lengths) == 2 * 19
    assert all(isinstance(n, torch.Tensor) and n.shape == ()
               for n in lengths)


def _prefill(model, ids, offset, max_len, tq):
    """last_only prefill of left-padded ids over a quantized cache: (state,
    first greedy token)."""
    cfg = model.cfg
    B, S = ids.shape
    state = tc.init_quant_cache(cfg.num_hidden_layers, B, max_len,
                                cfg.num_key_value_heads, cfg.head_dim, tq,
                                offset=offset, device="cpu")
    pos = torch.clamp(torch.arange(S)[None, :] - offset[:, None], min=0)
    cache = tc.QuantizedDecodeCache(state, tq)
    with torch.inference_mode():
        logits = model(ids, positions=pos, cache=cache, last_only=True)
    return cache.finalize(), torch.argmax(logits[:, -1], dim=-1)


@pytest.mark.parametrize("route,kw", [
    ("update", {}), ("fused", {}), ("update", dict(rank=2)),
    ("update", dict(out_k=2)), ("update", dict(residual_len=3, k_group=4))])
def test_step_run_eagerly_gives_the_eager_loop_s_tokens(tiny, wide, route,
                                                        kw):
    """DecodeStep over the quantized cache, run as the card captures it but
    eagerly, decodes the tokens and last logits of the loop it replaces:
    a fresh QuantizedDecodeCache a step, host positions, argmax; in every
    configuration the card captures (GEAR-L, GEAR-S, a protected residual
    and sub-chunk K groups too)."""
    _, _, kern, plain = wide if route == "fused" else tiny
    model = kern if route == "fused" else plain
    _, tq = _cfgs(**QCFG, **kw)
    lens = (7, 7, 7) if route == "fused" else (4, 11, 7)
    rng = np.random.default_rng(len(lens))
    ids, plens = pad_prompts([rng.integers(0, 256, (n,)).tolist()
                              for n in lens])
    ids = torch.as_tensor(ids)
    offset = torch.as_tensor(ids.shape[1] - plens)
    S, steps = ids.shape[1], 12

    state, tok = _prefill(model, ids, offset, 32, tq)
    want = []
    with torch.inference_mode():
        for i in range(steps):
            cache = tc.QuantizedDecodeCache(state, tq)
            pos = (S + i - offset)[:, None]
            logits = model(tok[:, None], positions=pos, cache=cache)
            state = cache.finalize()
            tok = torch.argmax(logits[:, -1], dim=-1)
            want.append(tok)
    want_logits = logits

    state, tok = _prefill(model, ids, offset, 32, tq)
    step = DecodeStep(model, state, tok, tq)
    got, variants = [], []
    with torch.inference_mode():
        for _ in range(steps):
            variants.append(step.variant())
            got.append(step.eager().clone())
    assert torch.equal(torch.stack(got), torch.stack(want))
    assert torch.equal(step.logits, want_logits)
    # S = 11 (7): the steps at lengths 15 and 23 (15) fold at gap 8, three
    # lengths later with a protected residual of 3
    assert [i for i, v in enumerate(variants) if v == "fold"] == [
        i for i in range(steps)
        if (S + i + 1 - tq.residual_len) % 8 == 0
        and S + i + 1 - tq.residual_len >= 8]


def test_length_is_a_device_tensor_advanced_in_place(tiny):
    """The prefill and every step advance the same 0-d int32 tensor and its
    host mirror; a fold lands at the chunk the device length names."""
    _, _, _, plain = tiny
    _, tq = _cfgs(**QCFG)
    ids = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 6)))
    state, tok = _prefill(plain, ids, torch.zeros(2, dtype=torch.int32), 24,
                          tq)
    length = state.length
    assert length.shape == () and length.dtype == torch.int32
    assert int(length) == state.host_length == 6
    step = DecodeStep(plain, state, tok, tq)
    with torch.inference_mode():
        for i in range(4):
            assert step.variant() == ("fold" if i == 1 else "plain")
            kq1 = state.kq[:, :, :, 0].clone()
            step()
            assert step.state.length is length
            assert int(length) == state.host_length == 7 + i
            # the fold at length 7 writes chunk 0, the only one
            assert torch.equal(state.kq[:, :, :, 0], kq1) == (i != 1)
    assert not state.kq[:, :, :, 1:].any()


def test_fold_choice_and_overflow_read_the_host_mirror(tiny):
    """Whether a step folds, and whether its fold fits the store (2 chunks
    and the residual window: 23 tokens at gap 8), come from the host
    mirror: a fold past the store raises before anything is written,
    whatever the device length says."""
    _, _, _, plain = tiny
    _, tq = _cfgs(**QCFG)
    ids = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (1, 5)))
    state, tok = _prefill(plain, ids, torch.zeros(1, dtype=torch.int32), 16,
                          tq)
    step = DecodeStep(plain, state, tok, tq)
    assert [tc.quant_fold_step(tq, n) for n in range(5, 17)] == [
        n % 8 == 7 for n in range(5, 17)]
    assert tc.next_fold_length(tq, 5) == 7
    assert tc.next_fold_length(tq, 7) == 7
    assert tc.next_fold_length(tq, 8) == 15
    with torch.inference_mode():
        state.length.fill_(7)          # the device says "fold"; the mirror
        assert step.variant() == "plain"                # says 5
        state.length.fill_(5)
        for _ in range(18):            # lengths 5..22: folds at 7 and 15
            step()
        assert state.host_length == int(state.length) == 23
        assert step.variant() == "fold"
        before = {f: getattr(state, f).clone()
                  for f in tc._store_fields(tq)}
        with pytest.raises(ValueError, match="2 chunks; a write at chunk 2"):
            step()
        for f, v in before.items():
            assert torch.equal(getattr(state, f), v), f
        assert state.host_length == int(state.length) == 23
        # the mirror, not the device tensor, decides
        state.length.zero_()
        with pytest.raises(ValueError, match="overflows"):
            tc.check_quant_room(state, tq)
        state.host_length = 22
        tc.check_quant_room(state, tq)


def test_capture_needs_a_cuda_model(tiny):
    """On the CPU the step never captures: every call is eager, fold steps
    too."""
    _, _, _, plain = tiny
    _, tq = _cfgs(**QCFG)
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (1, 4)))
    state, tok = _prefill(plain, ids, torch.zeros(1, dtype=torch.int32), 24,
                          tq)
    step = DecodeStep(plain, state, tok, tq)
    with torch.inference_mode():
        for _ in range(6):
            step()
    assert not step.graphs and state.host_length == 10
