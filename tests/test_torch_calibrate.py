"""The port's calibration path against the JAX package on the CPU: the data
loaders (crops and token ids bit-identical), round-to-nearest
``quantize_params`` (bit-exact), the OPT model (logits, float32: 1e-4 of
max |logit|, XLA and torch differ in reduction order), and
``gptq_quantize_model`` on ``LlamaConfig.tiny`` and ``OPTConfig.tiny``
with JAX's flax-initialised weights carried across by ``params_from_jax``:
perplexity within 0.1 of JAX's (ROADMAP queue 1 item 6's criterion).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.eval import data as jdata
from microscopiq_tpu.eval.ppl import perplexity as j_perplexity
from microscopiq_tpu.models import LlamaConfig as JLlamaConfig
from microscopiq_tpu.models import LlamaForCausalLM as JLlama
from microscopiq_tpu.models import OPTConfig as JOPTConfig
from microscopiq_tpu.models import OPTForCausalLM as JOPT
from microscopiq_tpu.nn import quantize_params as j_quantize_params
from microscopiq_tpu.quant.calibrate import (
    gptq_quantize_model as j_gptq_quantize_model)
from microscopiq_tpu.specs import finalize_mx_specs as j_finalize
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval import data as tdata
from microscopiq_tpu_torch.eval.ppl import perplexity
from microscopiq_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                          OPTConfig, OPTForCausalLM)
from microscopiq_tpu_torch.nn import quantize_params
from microscopiq_tpu_torch.quant.calibrate import gptq_quantize_model
from microscopiq_tpu_torch.specs import finalize_mx_specs

SEQLEN = 64
MODELS = {"llama": (JLlamaConfig, JLlama, LlamaConfig, LlamaForCausalLM),
          "opt": (JOPTConfig, JOPT, OPTConfig, OPTForCausalLM)}


def _jax_model(kind):
    jcfg_cls, jcls, tcfg_cls, tcls = MODELS[kind]
    model = jcls(jcfg_cls.tiny())
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return model, params, tcfg_cls.tiny(), tcls


@functools.lru_cache(maxsize=None)
def _calibration_data():
    """JAX's synthetic calibration crops and test stream (made once)."""
    crops, test_ids = jdata.get_loaders("synthetic", 8, 0, SEQLEN)
    return (np.concatenate(crops, 0) % 256,
            np.asarray(test_ids)[:SEQLEN * 24] % 256)


def _to_port(params):
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    return {"params": params_from_jax(tree, device="cpu")}


def test_synthetic_corpus_and_hash_tokenizer_are_jax_s():
    assert tdata.synthetic_corpus(5000, seed=3) == jdata.synthetic_corpus(
        5000, seed=3)
    text = tdata.synthetic_corpus(2000)
    np.testing.assert_array_equal(tdata._hash_tokenize(text),
                                  jdata._hash_tokenize(text))


@pytest.mark.parametrize("seed,seqlen", [(7, 2048)])
def test_get_loaders_crops_bit_identical(seed, seqlen):
    ct, tt = tdata.get_loaders("synthetic", 5, seed, seqlen)
    cj, tj = jdata.get_loaders("synthetic", 5, seed, seqlen)
    assert len(ct) == len(cj) == 5
    for a, b in zip(ct, cj):
        assert a.shape == (1, seqlen)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt, tj)


def test_get_loaders_text_file_and_missing_dataset(tmp_path, monkeypatch):
    (tmp_path / "wikitext2.txt").write_text(
        tdata.synthetic_corpus(20000, seed=5))
    monkeypatch.setenv("MICROSCOPIQ_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jdata, "DATA_DIR", str(tmp_path))
    monkeypatch.delenv("MICROSCOPIQ_ALLOW_SYNTHETIC", raising=False)
    ct, tt = tdata.get_loaders("wikitext2", 3, 1, 128)
    cj, tj = jdata.get_loaders("wikitext2", 3, 1, 128)
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt, tj)
    with pytest.raises(FileNotFoundError, match="allow-synthetic"):
        tdata.get_loaders("ptb", 1, 0, 64)
    small = tdata.synthetic_corpus(3000)
    monkeypatch.setattr(tdata, "synthetic_corpus", lambda: small)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c1, _ = tdata.get_loaders("ptb", 1, 0, 64, allow_synthetic=True)
    c2, _ = tdata.get_loaders("synthetic", 1, 0, 64)
    np.testing.assert_array_equal(c1[0], c2[0])


def test_quantize_params_is_bit_exact():
    """Every 2-D kernel quantized, the lm_head and other leaves kept."""
    rng = np.random.default_rng(3)
    w = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa
    tree = {"layers_0": {"q_proj": {"kernel": w(64, 48)},
                         "fc1": {"kernel": w(40, 96), "bias": w(96)}},
            "lm_head": {"kernel": w(64, 32)}, "embed_tokens": w(32, 64)}
    tree["layers_0"]["q_proj"]["kernel"][::9, ::7] *= 12.0
    spec = {"w_elem_format": "int2", "w_outlier_elem_format": "fp4_e2m1",
            "scale_bits": 8, "block_size": 16, "outlier_std_dev": 2.0,
            "bfloat": 16}
    jspec = j_finalize(spec)
    want = jax.jit(lambda t: j_quantize_params(t, jspec))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    got = quantize_params(params_from_jax(tree, device="cpu"),
                          finalize_mx_specs(spec))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == 5
    for path, leaf in flat:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert not np.array_equal(got["layers_0"]["fc1"]["kernel"].numpy(),
                              tree["layers_0"]["fc1"]["kernel"])
    np.testing.assert_array_equal(got["lm_head"]["kernel"].numpy(),
                                  tree["lm_head"]["kernel"])


def test_opt_logits_match_jax():
    model, params, cfg, cls = _jax_model("opt")
    ids = np.random.default_rng(0).integers(0, 256, (2, 24))
    want = np.asarray(model.apply(params, jnp.asarray(ids)))
    tm = cls(cfg, device="cpu").load_params(_to_port(params))
    got = tm(torch.as_tensor(ids)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    last = tm(torch.as_tensor(ids), last_only=True).numpy()
    np.testing.assert_allclose(last[:, 0], got[:, -1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["llama", "opt"])
def test_gptq_quantize_model_perplexity_within_0_1_of_jax(kind):
    model, params, cfg, cls = _jax_model(kind)
    calib, test_ids = _calibration_data()
    jq, jdec = j_gptq_quantize_model(kind, model.cfg, params,
                                     jnp.asarray(calib), verbose=False,
                                     collect_decisions=True)
    jppl = j_perplexity(lambda p, ids: model.apply(p, ids), jq, test_ids,
                        seqlen=SEQLEN)
    tq, tdec = gptq_quantize_model(kind, cfg, _to_port(params),
                                   torch.as_tensor(calib).long(),
                                   verbose=False, collect_decisions=True)
    assert set(tdec) == set(jdec) and len(tdec) == 2 * (7 if kind ==
                                                        "llama" else 6)
    tppl = perplexity(cls(cfg, device="cpu").load_params(tq), test_ids,
                      seqlen=SEQLEN)
    assert np.isfinite(tppl) and abs(tppl - jppl) <= 0.1, (tppl, jppl)
    # the quantized kernels themselves: nearly every entry JAX's
    same = [np.mean(np.asarray(jl) == tl.numpy()) for jl, tl in zip(
        jax.tree_util.tree_leaves(jq["params"]),
        jax.tree_util.tree_leaves(tq["params"]))]
    assert min(same) >= 0.95, same
