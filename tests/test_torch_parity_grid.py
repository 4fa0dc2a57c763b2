"""The parity grid at model scale (``scripts/parity_ref.py``'s eight
configs) through both packages on the CPU, from the same seeded 12-layer
OPT and Llama weights (``microscopiq_tpu_torch.scripts.parity.
seeded_state_dicts``) and the same Markov calibration crops and eval
windows: each config's perplexity, and its packed serving trees' where
the JAX stage computes them, within |Δppl| <= 0.1 of JAX's.

Marked slow (each GPTQ config takes minutes on the CPU in each package);
the fast tier deselects it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu_torch.scripts import parity

pytestmark = pytest.mark.slow
DPPL = 0.1


@pytest.fixture(scope="module")
def inputs():
    torch.set_num_threads(2)
    calib, eval_ids = parity.make_tokens(parity.MODEL_OPT["vocab_size"])
    return parity.seeded_state_dicts(0), calib, eval_ids


def jax_results(name, sds, calib, eval_ids):
    """The JAX package's perplexities of one config, as parity_ref.py's
    ``ours`` stage computes them."""
    from microscopiq_tpu.eval import perplexity
    from microscopiq_tpu.models import (LlamaConfig, LlamaForCausalLM,
                                        OPTConfig, OPTForCausalLM)
    from microscopiq_tpu.models.loading import convert_llama, convert_opt
    from microscopiq_tpu.nn import pack_params, quantize_params
    from microscopiq_tpu.quant import MXQuantizer
    from microscopiq_tpu.quant.calibrate import gptq_quantize_model
    from microscopiq_tpu.specs import finalize_mx_specs

    G = parity.GPTQ_CFG
    calib = jnp.asarray(calib)

    def qz():
        q = MXQuantizer()
        q.configure(G["scale_bits"], G["scale_bits"], G["inlier"],
                    G["outlier"], std_dev=G["std_dev"], axes=[0],
                    block_size=G["block_size"])
        return q

    out = {}
    if name.startswith("llama"):
        lcfg = LlamaConfig(**parity.MODEL_LLAMA)
        lm = LlamaForCausalLM(lcfg, use_pallas=False)
        lp = convert_llama(dict(sds[1]), lcfg)
        ppl = lambda p: perplexity(lambda pp, ids: lm.apply(pp, ids), p,
                                   eval_ids, seqlen=parity.SEQLEN,
                                   batch=parity.PPL_BATCH)
        if name == "llama_dense":
            out[name] = ppl(lp)
        else:
            out[name] = ppl(gptq_quantize_model(
                "llama", lcfg, lp, calib, quantizer=qz(),
                blocksize=G["blocksize"], percdamp=G["percdamp"],
                groups=parity.LLAMA_GROUP, verbose=False))
        return out
    ocfg = OPTConfig(**parity.MODEL_OPT)
    op = convert_opt(dict(sds[0]), ocfg)

    def oppl(p, **kw):
        m = OPTForCausalLM(ocfg, use_pallas=False, **kw)
        return perplexity(lambda pp, ids: m.apply(pp, ids), p, eval_ids,
                          seqlen=parity.SEQLEN, batch=parity.PPL_BATCH)

    if name == "dense":
        out[name] = oppl(op)
    elif name in parity.GPTQ_VARIANTS:
        k = parity.GPTQ_VARIANTS[name]
        collect = name == "gptq_int2_fp4_block16"
        res = gptq_quantize_model(
            "opt", ocfg, op, calib, quantizer=qz(),
            blocksize=G["blocksize"], percdamp=G["percdamp"],
            actorder=k["act_order"], groupsize=k["groupsize"],
            static_groups=k["static_groups"], groups=parity.OPT_GROUP,
            verbose=False, collect_decisions=collect)
        gp, dec = res if collect else (res, None)
        out[name] = oppl(gp)
        if collect:
            specs_o = finalize_mx_specs({
                "w_elem_format": G["inlier"],
                "w_outlier_elem_format": G["outlier"],
                "scale_bits": G["scale_bits"],
                "block_size": G["block_size"], "bfloat": 16})
            out[name + "_packed"] = oppl({"params": pack_params(
                gp["params"], specs_o, skip=parity.SKIP, outlier_budget=4)})
            out[name + "_nb_packed"] = oppl({"params": pack_params(
                gp["params"], specs_o, skip=parity.SKIP, outlier_budget=0,
                outlier_transport="compact", decisions=dec)})
    elif name == "rtn_mxfp6_block32":
        F = parity.FP6_CFG
        specs6 = finalize_mx_specs({"w_elem_format": F["fmt"],
                                    "scale_bits": F["scale_bits"],
                                    "block_size": F["block_size"],
                                    "bfloat": 16})
        rtn = quantize_params(op["params"], specs6,
                              skip=("embed_tokens", "embed_positions"))
        out[name] = oppl({"params": rtn})
        out[name + "_packed"] = oppl({"params": pack_params(
            rtn, specs6, skip=parity.SKIP)})
    else:
        out[name] = oppl(op, mx_specs=finalize_mx_specs(
            dict(parity.ACT_CFG, a_axes=1)), mx_linear_only=True)
    return out


def test_tokens_are_parity_refs():
    """The port's copy of the Markov stream is parity_ref.py's."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "parity_ref", pathlib.Path(__file__).resolve().parents[1]
        / "scripts" / "parity_ref.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    np.testing.assert_array_equal(parity.markov_stream(5000, 4096),
                                  ref.markov_stream(5000, 4096))


@pytest.mark.parametrize("name", parity.ALL_CONFIGS)
def test_config_ppl_matches_jax(inputs, name):
    sds, calib, eval_ids = inputs
    want = jax_results(name, sds, calib, eval_ids)
    got = parity.run(sds, calib, eval_ids, device="cpu", only=[name],
                     log=lambda s: None)
    deltas = {k: got[k] - v for k, v in want.items()}
    print(f"PARITY {name}: port {[got[k] for k in want]} "
          f"jax {list(want.values())} delta {deltas}")
    for k, d in deltas.items():
        assert abs(d) <= DPPL, (k, got[k], want[k])
