"""The port's checkpoints, delta utilities, CLI spec flags and quantization
CLI against the JAX package on the CPU.

Checkpoints written by either package and read by the other are equal, bit
for bit, packed leaves (PackedMX in byte and float8 codes, the side-band
PackedMXOutlier, the compact PackedOutlierNB) included. The CLI runs end to
end on ``tiny-llama`` with ``--device cpu``: GPTQ, ``--save``, ``--load``
(the same perplexity), round to nearest, and perplexity alone.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu import specs as jspecs
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.outlier import (
    quantize_mx_outlier_hessian_decisions as j_decisions)
from microscopiq_tpu.utils import checkpoint as jck
from microscopiq_tpu_torch import specs as tspecs
from microscopiq_tpu_torch.cli import llm_cli
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval import ppl as tppl
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.utils import checkpoint as tck

_PACKED = {jpk.PackedMX: tpk.PackedMX,
           jpk.PackedMXOutlier: tpk.PackedMXOutlier,
           jpk.PackedOutlierNB: tpk.PackedOutlierNB}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return {f.name: _to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, (str, int, float)):
        return tree
    return np.asarray(tree)


def _bits(a):
    a = np.asarray(a) if not isinstance(a, torch.Tensor) else a
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            a = a.view(torch.int16 if a.element_size() == 2 else torch.uint8)
        a = a.numpy()
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize]), a.dtype.itemsize, a.shape


def _assert_same(j, t, path=""):
    """A JAX tree and a port tree hold the same leaves, bit for bit."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), path
        for k in j:
            _assert_same(j[k], t[k], f"{path}/{k}")
        return
    if dataclasses.is_dataclass(j):
        assert type(t) is _PACKED[type(j)], path
        for f in dataclasses.fields(j):
            _assert_same(getattr(j, f.name), getattr(t, f.name),
                         f"{path}.{f.name}")
        return
    if isinstance(j, (str, int, float)):
        assert j == t, path
        return
    bj, bt = _bits(j), _bits(t)
    assert bj[1:] == bt[1:], path
    np.testing.assert_array_equal(bj[0], bt[0], err_msg=path)


@functools.lru_cache(maxsize=None)
def _packed_tree():
    """A JAX tree with every packed leaf type and dense leaves."""
    rng = np.random.default_rng(9)
    W = (rng.standard_normal((64, 48)) * 0.02).astype(np.float32)
    W[::7, ::5] *= 10.0
    Wj = jnp.asarray(W)

    @jax.jit
    def packed(w):
        _, _, dec = j_decisions(w.T, 8, 8, "int2", "fp4_e2m1", "max", 2.0,
                                [0], 16, max_outliers_per_block=2)
        return dec, {
            "emi8": {"kernel": jpk.to_serving_layout(jpk.pack_mx(
                w, 8, "fp6_e3m2", 32, axis=0, transport="emi8"))},
            "fp8": {"kernel": jpk.pack_mx(w, 8, "fp8_e4m3", 32, axis=0)},
            "int4": {"kernel": jpk.pack_mx(w, 8, "int4", 16, axis=0)},
            "sideband": {"kernel": jpk.pack_mx_outlier(
                w, 8, 8, "int2", "fp4_e2m1", block_size=16,
                outlier_budget=4, axis=0)}}

    dec, tree = packed(Wj)
    return {
        **tree,
        "nb": {"kernel": jpk.pack_outlier_nb({**dec, "block_size": 16},
                                             budget=2)},
        "norm": {"scale": jnp.asarray(rng.standard_normal(48), jnp.float32)},
        "ids": jnp.arange(12, dtype=jnp.int32).reshape(3, 4),
    }


def test_checkpoint_written_by_jax_reads_in_the_port(tmp_path):
    tree = _packed_tree()
    jck.save_checkpoint(str(tmp_path), tree)
    got = tck.load_checkpoint(str(tmp_path), device="cpu")
    _assert_same(tree, got)
    _assert_same(tree, params_from_jax(_to_numpy(tree), device="cpu"))


def test_checkpoint_written_by_the_port_reads_in_jax(tmp_path):
    tree = _packed_tree()
    port = params_from_jax(_to_numpy(tree), device="cpu")
    tck.save_checkpoint(str(tmp_path / "t"), port)
    _assert_same(jck.load_checkpoint(str(tmp_path / "t")), port)
    _assert_same(tree, tck.load_checkpoint(str(tmp_path / "t"),
                                           device="cpu"))
    # the same files as JAX writes, leaf for leaf
    jck.save_checkpoint(str(tmp_path / "j"), tree)
    a = np.load(tmp_path / "t" / "arrays.npz")
    b = np.load(tmp_path / "j" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_bfloat16_leaves_round_trip(tmp_path):
    t = {"w": torch.randn(5, 3).to(torch.bfloat16),
         "p": tpk.pack_mx(torch.randn(4, 64), 8, "bfloat16", 32)}
    tck.save_checkpoint(str(tmp_path), t)
    got = tck.load_checkpoint(str(tmp_path), device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))
    assert torch.equal(got["p"].codes.view(torch.int16),
                       t["p"].codes.view(torch.int16))


def test_delta_and_consolidate_match_jax():
    rng = np.random.default_rng(2)
    base = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "emb": rng.standard_normal((5, 2)).astype(np.float32),
            "only_base": np.ones(2, np.float32)}
    target = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "emb": rng.standard_normal((7, 2)).astype(np.float32),
              "proj": rng.standard_normal((2, 2)).astype(np.float32)}
    jb, jt = (jax.tree_util.tree_map(jnp.asarray, x) for x in (base, target))
    tb, tt = (params_from_jax(x, device="cpu") for x in (base, target))
    jd, td = jck.make_delta(jb, jt), tck.make_delta(tb, tt)
    for k in jd:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    ja, ta = jck.apply_delta(jb, jd), tck.apply_delta(tb, td)
    for k in ja:
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                   rtol=1e-6)
    with pytest.raises(TypeError, match="dense trees"):
        tck.make_delta({"k": tpk.pack_mx(torch.randn(2, 32), 8, "int8", 32)},
                       {"k": torch.zeros(2, 32)})
    c = tck.consolidate({"x": tb["a"], "p": params_from_jax(
        _to_numpy(_packed_tree()), device="cpu")["nb"]},
        dtype=torch.float64)
    assert c["x"].dtype == torch.float64 and c["x"].device.type == "cpu"
    assert c["p"]["kernel"].codes.dtype == torch.int8


@pytest.mark.parametrize("argv", [
    [], ["--w_elem_format", "int4", "--block_size", "32", "--scale_bits",
         "8", "--no_bfloat_subnorms", "--outlier_std_dev", "3.0"],
    ["--skip_early_exit"], ["--a_elem_format", "fp8_e4m3", "--round",
                            "even", "--bfloat", "16"]])
def test_mx_args_and_specs_match_jax(argv):
    pj = jspecs.add_mx_args(argparse.ArgumentParser()).parse_args(argv)
    pt = tspecs.add_mx_args(argparse.ArgumentParser()).parse_args(argv)
    assert vars(pj) == vars(pt)
    sj, st = jspecs.get_mx_specs(pj), tspecs.get_mx_specs(pt)
    assert (sj is None) == (st is None)
    if sj is not None:
        assert sj.as_dict() == st.as_dict()


def test_cli_gptq_save_load_and_rtn_on_cpu(tmp_path, capsys, monkeypatch):
    """On a small local corpus (``$MICROSCOPIQ_DATA_DIR/wikitext2.txt``),
    so that the test split is a few windows."""
    from microscopiq_tpu_torch.eval.data import synthetic_corpus

    (tmp_path / "wikitext2.txt").write_text(synthetic_corpus(6000, seed=2))
    monkeypatch.setenv("MICROSCOPIQ_DATA_DIR", str(tmp_path))
    base = ["tiny-llama", "wikitext2", "--nsamples", "4", "--seqlen", "128",
            "--device", "cpu"]
    ppl_gptq = llm_cli.main(base + ["--save", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "GPTQ calibration done" in out and "saved checkpoint" in out
    assert "4/4 windows" in out and np.isfinite(ppl_gptq)
    assert (tmp_path / "ck" / "arrays.npz").exists()
    ppl_load = tppl.main(["--model", "llama-tiny", "wikitext2", "--nsamples",
                          "4", "--seqlen", "128", "--device", "cpu",
                          "--load", str(tmp_path / "ck")])
    assert "loaded checkpoint" in capsys.readouterr().out
    assert ppl_load == ppl_gptq
    ppl_rtn = llm_cli.main(base + ["--nearest"])
    ppl_fp = llm_cli.main(base + ["--no-quant"])
    assert "RTN quantization done" in capsys.readouterr().out
    assert np.isfinite(ppl_rtn) and np.isfinite(ppl_fp)
    assert ppl_rtn != ppl_fp != ppl_gptq


def test_cli_models_and_devices(tmp_path):
    # a local HF directory loads since models/loading.py is ported (its
    # loading is tests/test_torch_loading.py); one without config.json
    # raises, as the JAX CLI does
    with pytest.raises(FileNotFoundError, match="config.json"):
        llm_cli.build_model(str(tmp_path), torch.device("cpu"))
    kind, cfg, cls, params, tok = llm_cli.build_model("tiny-opt",
                                                      torch.device("cpu"))
    assert kind == "opt" and tok is None
    assert params["params"]["layers_0"]["fc1"]["bias"].shape == (cfg.ffn_dim,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            llm_cli.main(["tiny-opt", "--nsamples", "1", "--seqlen", "32"])


def test_cli_tiny_opt_gptq_and_decode_benchmark(tmp_path, capsys,
                                                monkeypatch):
    """OPT through the CLI: GPTQ on its biased linears, perplexity, and the
    greedy-decode benchmark over the dense KV cache."""
    from microscopiq_tpu_torch.eval.data import synthetic_corpus

    (tmp_path / "wikitext2.txt").write_text(synthetic_corpus(6000, seed=3))
    monkeypatch.setenv("MICROSCOPIQ_DATA_DIR", str(tmp_path))
    ppl = llm_cli.main(["tiny-opt", "wikitext2", "--nsamples", "2",
                        "--seqlen", "128", "--device", "cpu",
                        "--benchmark", "4"])
    out = capsys.readouterr().out
    assert "GPTQ calibration done" in out and np.isfinite(ppl)
    assert "median decode latency" in out
