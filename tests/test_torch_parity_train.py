"""The parity models' trainer (``microscopiq_tpu_torch.scripts.parity``
``train_lm`` / ``prepare``) against ``scripts/parity_ref.py``'s
``_train_lm``, and the parity grid on trained weights against JAX, on the
CPU at small sizes.

* ``train_lm`` and ``_train_lm`` (loaded by path) train a tiny OPT and a
  tiny Llama (2 layers, hidden 64, vocabulary 256) from the same JAX init
  (exported by the JAX package's ``export_*_state_dict``) on the same
  crops (32 tokens, batch 4) for 6 steps. Each step's loss within rtol
  1e-4 of JAX's (read from inside its jitted step). The weights after the
  steps: every element within 2 x the peak rate of JAX's (Adam may take a
  step the other way where a gradient is an ulp from zero), and at most
  0.1% of each leaf's elements more than 1e-6 apart, OPT's key-projection
  biases apart (their exact gradient is 0: both packages train on noise,
  ROADMAP queue 3).
* The grid's eight configs on a tiny OPT and Llama trained by the port's
  trainer until their dense perplexities are below a quarter of the
  vocabulary: each perplexity (and its packed trees') within |Δppl| <= 0.1
  of JAX's on the same trained tree, computed as
  ``tests/test_torch_parity_grid.py::jax_results`` computes them; the
  g128 static-groups config's quantized weights equal to the canonical
  config's bit for bit in both packages.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu_torch.scripts import parity
from test_torch_parity_grid import DPPL, jax_results

TINY_OPT = dict(vocab_size=256, hidden_size=64, ffn_dim=256,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=512)
TINY_LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=512,
                  rms_norm_eps=1e-5, rope_theta=10000.0)
STEPS, SEQ, BATCH = 6, 32, 4          # the trainer against _train_lm
LOSS_RTOL = 1e-4
PARAM_NEAR, PARAM_SHARE = 1e-6, 1e-3
TRAINED_STEPS = 200                   # the trained grid's trees


def parity_ref():
    spec = importlib.util.spec_from_file_location(
        "parity_ref", pathlib.Path(__file__).resolve().parents[1]
        / "scripts" / "parity_ref.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    return ref


def _port_model(kind, cfg_dict):
    from microscopiq_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                              OPTConfig)
    from microscopiq_tpu_torch.models.loading import (convert_llama,
                                                      convert_opt,
                                                      export_llama_state_dict,
                                                      export_opt_state_dict)
    from microscopiq_tpu_torch.models.opt import OPTForCausalLM

    if kind == "opt":
        cfg = OPTConfig(**cfg_dict)
        return (cfg, OPTForCausalLM(cfg, use_kernels=False, device="cpu"),
                convert_opt, export_opt_state_dict)
    cfg = LlamaConfig(**cfg_dict)
    return (cfg, LlamaForCausalLM(cfg, use_kernels=False, device="cpu"),
            convert_llama, export_llama_state_dict)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_make_tokens_are_parity_refs():
    """Training split, calibration crops and eval stream as
    ``parity_ref.py::make_tokens`` cuts them."""
    want = parity_ref().make_tokens(256)
    got = parity.make_tokens(256)
    assert len(got) == 3 and len(got[0]) == parity.TRAIN_TOKENS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["opt", "llama"])
def test_train_lm_matches_parity_ref(kind, monkeypatch):
    from microscopiq_tpu.models import (LlamaConfig, LlamaForCausalLM,
                                        OPTConfig, OPTForCausalLM)
    from microscopiq_tpu.models import loading as jl

    ref = parity_ref()
    monkeypatch.setattr(ref, "SEQLEN", SEQ)
    monkeypatch.setattr(ref, "TRAIN_BATCH", BATCH)
    train = parity.markov_stream(20_000, 256)
    if kind == "opt":
        jcfg = OPTConfig(**TINY_OPT)
        jmodel = OPTForCausalLM(jcfg, use_pallas=False)
        export, convert = jl.export_opt_state_dict, jl.convert_opt
    else:
        jcfg = LlamaConfig(**TINY_LLAMA)
        jmodel = LlamaForCausalLM(jcfg, use_pallas=False)
        export, convert = jl.export_llama_state_dict, jl.convert_llama
    init = export(jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))), jcfg)

    # _train_lm's loss at each step, from inside its jitted step
    jax_losses, vg = [], jax.value_and_grad

    def recording_value_and_grad(f, *a, **kw):
        inner = vg(f, *a, **kw)

        def call(*args, **kwargs):
            loss, grads = inner(*args, **kwargs)
            jax.debug.callback(lambda v: jax_losses.append(float(v)), loss,
                               ordered=True)
            return loss, grads
        return call

    monkeypatch.setattr(jax, "value_and_grad", recording_value_and_grad)
    want = ref._train_lm(jmodel, convert(dict(init), jcfg), train, STEPS,
                         seed=1)
    jax.effects_barrier()
    monkeypatch.setattr(jax, "value_and_grad", vg)
    want = export(jax.device_get(want), jcfg)

    cfg, model, t_convert, t_export = _port_model(
        kind, TINY_OPT if kind == "opt" else TINY_LLAMA)
    tree, losses = parity.train_lm(
        model, t_convert(parity._torch_state(init, "cpu"), cfg), train,
        STEPS, seed=1, batch=BATCH, seqlen=SEQ, log_every=0)
    assert len(jax_losses) == STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)

    got = {k: v.numpy() for k, v in t_export(tree, cfg).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * parity.TRAIN_LR, k
        if not k.endswith("k_proj.bias"):
            assert (d > PARAM_NEAR).mean() <= PARAM_SHARE, k


def test_prepare_writes_the_weights_load_state_dicts_reads(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(parity, "MODEL_OPT", TINY_OPT)
    monkeypatch.setattr(parity, "MODEL_LLAMA", TINY_LLAMA)
    rec = parity.prepare(str(tmp_path), device="cpu", steps=3,
                         log=lambda s: None)
    assert rec["steps"] == 3 and len(rec["opt_losses"]) == 3
    assert len(rec["llama_losses"]) == 3
    opt, llama = parity.load_state_dicts(str(tmp_path))
    seeded = parity.seeded_state_dicts(0)
    # OPT's tied lm_head: one trained leaf, exported as the embedding
    assert sorted(opt) == sorted([*seeded[0], "lm_head.weight"])
    np.testing.assert_array_equal(opt["lm_head.weight"],
                                  opt["model.decoder.embed_tokens.weight"])
    assert sorted(llama) == sorted(seeded[1])
    for sd, start in ((opt, seeded[0]), (llama, seeded[1])):
        for k, v in start.items():
            assert sd[k].dtype == np.float32 and sd[k].shape == v.shape
            assert np.isfinite(sd[k]).all()
        assert any(not np.array_equal(sd[k], v) for k, v in start.items())
    assert (tmp_path / "prepare_cpu.json").exists()


@pytest.fixture(scope="module")
def trained():
    """A tiny OPT and Llama trained by the port's trainer from
    ``seeded_state_dicts`` (at these shapes), with the grid's tokens."""
    mp = pytest.MonkeyPatch()
    mp.setattr(parity, "MODEL_OPT", TINY_OPT)
    mp.setattr(parity, "MODEL_LLAMA", TINY_LLAMA)
    torch.set_num_threads(2)
    train, calib, eval_ids = parity.make_tokens(256)
    seeded = parity.seeded_state_dicts(0)
    sds, dense = [], {}
    for kind, cfg_dict, sd, seed in (("opt", TINY_OPT, seeded[0], 1),
                                     ("llama", TINY_LLAMA, seeded[1], 2)):
        cfg, model, convert, export = _port_model(kind, cfg_dict)
        tree, _ = parity.train_lm(model, convert(parity._torch_state(
            sd, "cpu"), cfg), train, TRAINED_STEPS, seed=seed, log_every=0)
        sds.append({k: v.numpy() for k, v in export(tree, cfg).items()})
    yield tuple(sds), calib, eval_ids
    mp.undo()


def test_trained_models_learned_the_stream(trained):
    sds, calib, eval_ids = trained
    got = parity.run(sds, calib, eval_ids, device="cpu",
                     only=["dense", "llama_dense"], log=lambda s: None)
    for k in ("dense", "llama_dense"):
        assert got[k] < TINY_OPT["vocab_size"] / 4, (k, got[k])


@pytest.mark.parametrize("name", parity.ALL_CONFIGS)
def test_trained_config_ppl_matches_jax(trained, name):
    sds, calib, eval_ids = trained
    want = jax_results(name, sds, calib, eval_ids)
    got = parity.run(sds, calib, eval_ids, device="cpu", only=[name],
                     log=lambda s: None)
    deltas = {k: got[k] - v for k, v in want.items()}
    print(f"PARITY trained {name}: port {[got[k] for k in want]} "
          f"jax {list(want.values())} delta {deltas}")
    for k, d in deltas.items():
        assert abs(d) <= DPPL, (k, got[k], want[k])


def test_g128_static_groups_equal_the_canonical_config(trained):
    """MXQuantizer's parameters take no state from a group: the static
    groups of 128 give the canonical config's weights bit for bit, in
    each package (``parity_ref.py``'s note on the config)."""
    from microscopiq_tpu.models import OPTConfig as JOPTConfig
    from microscopiq_tpu.models.loading import convert_opt as j_convert
    from microscopiq_tpu.quant import MXQuantizer
    from microscopiq_tpu.quant.calibrate import (
        gptq_quantize_model as j_gptq)
    from microscopiq_tpu_torch.models import OPTConfig
    from microscopiq_tpu_torch.models.loading import convert_opt
    from microscopiq_tpu_torch.quant.calibrate import gptq_quantize_model

    sds, calib, _ = trained
    G = parity.GPTQ_CFG

    def jqz():
        q = MXQuantizer()
        q.configure(G["scale_bits"], G["scale_bits"], G["inlier"],
                    G["outlier"], std_dev=G["std_dev"], axes=[0],
                    block_size=G["block_size"])
        return q

    canon, static = (parity.GPTQ_VARIANTS["gptq_int2_fp4_block16"],
                     parity.GPTQ_VARIANTS["gptq_int2_fp4_g128_static"])
    cfg = OPTConfig(**TINY_OPT)
    params = convert_opt(parity._torch_state(sds[0], "cpu"), cfg)
    calib_t = torch.as_tensor(calib.astype(np.int64))
    jcfg = JOPTConfig(**TINY_OPT)
    jparams = j_convert(dict(sds[0]), jcfg)
    port, jax_out = [], []
    for knobs in (canon, static):
        kw = dict(blocksize=G["blocksize"], percdamp=G["percdamp"],
                  actorder=knobs["act_order"], groupsize=knobs["groupsize"],
                  static_groups=knobs["static_groups"],
                  groups=parity.OPT_GROUP, verbose=False)
        port.append(gptq_quantize_model("opt", cfg, params, calib_t,
                                        quantizer=parity.make_quantizer(),
                                        **kw))
        jax_out.append(j_gptq("opt", jcfg, jparams, jnp.asarray(calib),
                              quantizer=jqz(), **kw))
    a, b = (jax.tree_util.tree_leaves(t) for t in jax_out)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    ta, tb = (list(parity._leaves(t)) for t in port)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
