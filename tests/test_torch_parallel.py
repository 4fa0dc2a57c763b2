"""The port's parallel layer (microscopiq_tpu_torch.parallel) against the
JAX package's on the same numpy inputs:

* the sharding rules leaf by leaf against JAX's ``param_shardings`` on a
  tiny Llama (dense, MX-FP6 emi8, fused; compact NB and side-band
  leaves), the non-dividing fallback and ``kv_state_shardings``;
* the fused-column permutation and the local shards it gives;
* the tensor-parallel forward and decodes on a gloo group of world size 2,
  two spawned CPU processes (tests/torch_tp_worker.py): dense, packed,
  fused, a replicated row-parallel layer, data parallel, a quantized-KV
  decode and the compact NB transport, against the port's one-process
  forward and JAX's unsharded one at tests/test_torch_llama.py's
  tolerances (float32 logits 1e-4 of max, bfloat16 3e-2, greedy tokens
  equal in float32);
* ``tp_dequant_matmul`` and ``tp_quant_attention_decode`` against JAX's
  ``tp_pallas`` in interpret mode at model=2 on the CPU mesh.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from microscopiq_tpu.eval.generate import generate as j_generate
from microscopiq_tpu.kv.cache import QuantKVConfig as JQuantKVConfig
from microscopiq_tpu.models import LlamaConfig as JConfig
from microscopiq_tpu.models import LlamaForCausalLM as JModel
from microscopiq_tpu.nn import fuse_projections as j_fuse
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.outlier import (
    quantize_mx_outlier_hessian_decisions as j_decisions)
from microscopiq_tpu.parallel import make_mesh as j_make_mesh
from microscopiq_tpu.parallel import param_shardings as j_param_shardings
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval.generate import generate
from microscopiq_tpu_torch.kv.cache import QuantKVConfig, init_quant_cache
from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from microscopiq_tpu_torch.parallel import (kv_state_shardings, make_mesh,
                                            param_shardings, shard_kv_state,
                                            shard_params)
from microscopiq_tpu_torch.parallel.mesh import fused_column_order
from microscopiq_tpu_torch.parallel.tp_kernels import (
    tp_dequant_matmul, tp_quant_attention_decode)
from test_torch_llama import (DTYPES, TOL, _rel, jax_to_numpy, jax_tree,
                              numpy_tree)
from test_torch_outlier_llama import port_params, to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(3)


def pair(dtype="float32", packed=True, fused=True, **kw):
    """(JAX model, JAX params, the port's tree, the port's config) on the
    same numpy weights of a tiny Llama."""
    jd, td = DTYPES[dtype]
    jcfg = JConfig.tiny(dtype=jd, fused_projections=fused, **kw)
    params = jax_tree(numpy_tree(jcfg, 0), jd, packed)
    if fused:
        params = j_fuse(params)
    tcfg = LlamaConfig.tiny(dtype=td, fused_projections=fused, **kw)
    tree = params_from_jax(jax_to_numpy(params), device="cpu")
    return JModel(jcfg, use_pallas=False), {"params": params}, tree, tcfg


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------
def _jax_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_leaves(v, f"{path}/{k}" if path else k)
    elif dataclasses.is_dataclass(tree) and not hasattr(tree, "spec"):
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if hasattr(v, "spec") or dataclasses.is_dataclass(v):
                yield from _jax_leaves(v, f"{path}/{f.name}")
    else:
        yield path, tuple(tree.spec)


def _port_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tuple(tree)


def _same_rules(jtree, ttree, jmesh, tmesh):
    want = dict(_jax_leaves(j_param_shardings(jtree, jmesh)))
    got = dict(_port_leaves(param_shardings(ttree, tmesh)))
    assert set(got) == set(want)
    for path in want:
        assert got[path] == want[path], (path, got[path], want[path])
    return got


@pytest.mark.parametrize("packed,fused,data,model", [
    (False, False, 2, 4), (False, True, 2, 4), (False, False, 1, 2),
    (True, True, 1, 2), (True, False, 2, 2), (True, True, 2, 2)])
def test_rules_match_jax_leaf_by_leaf(packed, fused, data, model):
    _, jp, tree, _ = pair("float32", packed, fused)
    jmesh = j_make_mesh(data * model, data=data, model=model)
    got = _same_rules(jp["params"], tree, jmesh, make_mesh(
        data * model, data=data, model=model))
    l0 = "model/layers_0"
    if not packed:
        assert got[f"{l0}/self_attn/o_proj/kernel"] == ("model", None)
        assert got["lm_head/kernel"] == (None, "model")
    else:
        assert got[f"{l0}/mlp/down_proj/kernel/codes"] == ("model", None,
                                                            None)


def test_packed_rows_that_split_a_block_are_replicated():
    """o_proj's K of 64 is 2 MX blocks of 32: no 4-way split falls on
    block boundaries, so the port replicates it (JAX names the axis and
    leaves the placement to fail), and keeps the 2-way split."""
    _, _, tree, _ = pair("float32", True, True)
    got = dict(_port_leaves(param_shardings(tree, make_mesh(4))))
    o = "model/layers_0/self_attn/o_proj/kernel"
    assert got[f"{o}/codes"] == (None, None, None)
    assert got[f"{o}/scale_exp"] == (None, None)
    got = dict(_port_leaves(param_shardings(tree, make_mesh(2))))
    assert got[f"{o}/codes"] == ("model", None, None)


def _nb_and_sideband():
    """A JAX compact NB leaf (N=64, K=64) and a side-band leaf (K=64,
    N=128), as JAX's test_sharded_compact_transport_forward makes the
    first."""
    W = RNG.standard_normal((64, 64)).astype(np.float32)
    W[RNG.random(W.shape) < 0.05] *= 8.0
    _, _, dec = jax.jit(lambda w: j_decisions(
        w, 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0], 16,
        max_outliers_per_block=2))(jnp.asarray(W))
    nb = jpk.pack_outlier_nb({**dec, "block_size": 16}, budget=2)
    sb = jax.jit(lambda a: jpk.pack_mx_outlier(
        a, 8, 8, "int2", "fp4_e2m1", block_size=16, outlier_budget=4,
        axis=0))(jnp.asarray(RNG.standard_normal((64, 128)), jnp.float32))
    return nb, sb


def test_rules_match_jax_nb_sideband_and_fallback():
    nb, sb = _nb_and_sideband()
    jtree = {"mlp": {"gate_proj": {"kernel": nb},
                     "down_proj": {"kernel": sb}},
             "self_attn": {"o_proj": {"kernel": nb}},
             "odd": {"gate_proj": {"kernel": jnp.ones((16, 9))}}}
    ttree = params_from_jax(to_numpy(jtree), device="cpu")
    for data, model in ((1, 4), (2, 2), (1, 2)):
        got = _same_rules(jtree, ttree, j_make_mesh(data * model, data=data,
                                                    model=model),
                          make_mesh(data * model, data=data, model=model))
        # feature dim 9 does not divide: replicated
        assert got["odd/gate_proj/kernel"] == (None, None)
    got = dict(_port_leaves(param_shardings(ttree, make_mesh(4))))
    assert got["mlp/gate_proj/kernel/codes"] == ("model", None)
    assert got["mlp/gate_proj/kernel/out_byte"] == (None, "model", None)


def test_kv_state_shardings_match_jax():
    from microscopiq_tpu.kv.cache import init_quant_cache as j_init
    from microscopiq_tpu.parallel import kv_state_shardings as j_kv

    jst = j_init(2, 4, 64, 4, 16, JQuantKVConfig(bits=4, gap=8, rank=2))
    tst = init_quant_cache(2, 4, 64, 4, 16, QuantKVConfig(bits=4, gap=8,
                                                          rank=2),
                           device="cpu")
    for data, model in ((2, 4), (4, 2), (1, 8)):
        want = j_kv(jst, j_make_mesh(8, data=data, model=model))
        got = kv_state_shardings(tst, make_mesh(8, data=data, model=model))
        for f in dataclasses.fields(jst):
            w = getattr(want, f.name)
            if w is None or not hasattr(w, "spec"):
                continue
            assert got[f.name] == tuple(w.spec), f.name
    mesh = make_mesh(8, data=2, model=4)
    tst.kq.copy_(torch.randint(0, 255, tst.kq.shape, dtype=torch.uint8))
    blk = shard_kv_state(tst, mesh, rank=6)          # data 1, model 2
    assert torch.equal(blk.kq, tst.kq[:, 2:4, 2:3])
    assert blk.length.shape == ()


# ---------------------------------------------------------------------------
# Fused columns
# ---------------------------------------------------------------------------
def test_fused_column_order_puts_sections_rank_major():
    order = fused_column_order([4, 2, 2], 2).tolist()
    assert order == [0, 1, 4, 6, 2, 3, 5, 7]
    with pytest.raises(ValueError, match="split"):
        fused_column_order([3, 2], 2)


@pytest.mark.parametrize("packed", [False, True])
def test_shard_params_fused_equals_unfused_shards(packed):
    """Rank r's fused qkv/gate_up shard is [q_r | k_r | v_r] / [gate_r |
    up_r] of the unfused shards, codes and exponents exactly."""
    _, _, fused, cfg = pair("float32", packed, True)
    _, _, unfused, _ = pair("float32", packed, False)
    mesh = make_mesh(2, data=1, model=2)

    def cat(ts):
        if packed:
            return (torch.cat([t.codes for t in ts], -1),
                    torch.cat([t.scale_exp for t in ts], -1))
        return (torch.cat(ts, -1),)

    for r in range(2):
        f = shard_params(fused, mesh, rank=r, cfg=cfg)["model"]["layers_0"]
        u = shard_params(unfused, mesh, rank=r, cfg=cfg)["model"]["layers_0"]
        for grp, name, parts in (("self_attn", "qkv_proj",
                                  ("q_proj", "k_proj", "v_proj")),
                                 ("mlp", "gate_up_proj",
                                  ("gate_proj", "up_proj"))):
            got = f[grp][name]["kernel"]
            want = cat([u[grp][p]["kernel"] for p in parts])
            got = (got.codes, got.scale_exp) if packed else (got,)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
                assert a.is_contiguous()
        down = u["mlp"]["down_proj"]["kernel"]
        K = cfg.intermediate_size // 2
        if packed:
            assert down.orig_dim == K and down.codes.shape[0] == K // 32
        else:
            assert down.shape == (K, cfg.hidden_size)
    with pytest.raises(ValueError, match="config"):
        shard_params(fused, mesh, rank=0)


# ---------------------------------------------------------------------------
# TP forward over a gloo group of two processes
# ---------------------------------------------------------------------------
def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


CASES = {
    # name: (dtype, packed, fused, mesh, config keywords, decode, quant)
    "dense": ("float32", False, False, (1, 2), {}, True, False),
    "emi8_fused": ("float32", True, True, (1, 2), {}, True, True),
    "emi8_fused_bf16": ("bfloat16", True, True, (1, 2), {}, False, False),
    "emi8_down_replicated": ("float32", True, True, (1, 2),
                             {"intermediate_size": 96}, True, False),
    "data_parallel": ("float32", True, True, (2, 1), {}, True, False),
}


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Run every case on two gloo ranks; returns (the ranks' results, the
    cases' JAX models and params, the port's trees and configs, ids)."""
    tmp = tmp_path_factory.mktemp("tp")
    ids = RNG.integers(0, 256, (2, 12))
    cases, refs = {}, {}
    for name, (dtype, packed, fused, mesh, kw, dec, quant) in CASES.items():
        jm, jp, tree, cfg = pair(dtype, packed, fused, **kw)
        cases[name] = dict(tree=tree, cfg=cfg, mesh=mesh, ids=ids,
                           decode=dec, quant=quant)
        refs[name] = (jm, jp)
    cases["compact"] = dict(tree=port_params("compact"),
                            cfg=LlamaConfig.tiny(fused_projections=True),
                            mesh=(1, 2), ids=ids, decode=True, quant=False)
    cfg80 = LlamaConfig.tiny(fused_projections=True, intermediate_size=80)
    cases["compact_gate_up_replicated"] = dict(
        tree=compact_tree(cfg80), cfg=cfg80, mesh=(1, 2), ids=ids,
        decode=False, quant=False)
    torch.save(cases, tmp / "cases.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    worker = os.path.join(os.path.dirname(__file__), "torch_tp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(r), "2",
         str(tmp / "cases.pt"), str(tmp / f"out{r}.pt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(2)]
    lines = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
        lines.append(json.loads(out.strip().splitlines()[-1]))
    assert [x["primary"] for x in lines] == [True, False]
    res = [torch.load(tmp / f"out{r}.pt", weights_only=False)
           for r in range(2)]
    return res, refs, cases, ids


def compact_tree(cfg):
    """The port's fused compact-NB tree of ``cfg`` from seeded weights
    (budget 2): with an intermediate size of 80, each rank's 40 gate/up
    columns cut a 16-row NB block, so the rules replicate gate_up."""
    from microscopiq_tpu_torch.models.llama import build_params
    from microscopiq_tpu_torch.nn import (find_linear_params,
                                          fuse_projections, pack_params)
    from microscopiq_tpu_torch.ops import outlier as tol
    from microscopiq_tpu_torch.specs import finalize_mx_specs

    tree = _float(build_params(cfg, seed=5, device="cpu")["params"])
    dec = {}
    for path, w in find_linear_params(tree, skip=()).items():
        _, _, d = tol.quantize_mx_outlier_hessian_decisions(
            w.T.contiguous(), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0], 16,
            max_outliers_per_block=2)
        dec[path] = {**d, "block_size": 16}
    specs = finalize_mx_specs({"w_elem_format": "int2",
                               "w_outlier_elem_format": "fp4_e2m1",
                               "scale_bits": 8, "block_size": 16})
    return fuse_projections(pack_params(tree, specs, skip=(), decisions=dec,
                                        outlier_transport="compact",
                                        outlier_budget=2))


def _float(node):
    if isinstance(node, dict):
        return {k: _float(v) for k, v in node.items()}
    return node.float()


def test_compact_gate_up_is_replicated_where_a_split_cuts_a_block():
    cfg = LlamaConfig.tiny(fused_projections=True, intermediate_size=80)
    tree = compact_tree(cfg)
    local = shard_params(tree, make_mesh(2, data=1, model=2), rank=1,
                         cfg=cfg)["model"]["layers_0"]
    assert local["mlp"]["gate_up_proj"]["kernel"].orig_n == 160
    assert local["mlp"]["down_proj"]["kernel"].orig_k == 40
    assert local["self_attn"]["qkv_proj"]["kernel"].orig_n == 64


def _one_process(case):
    m = LlamaForCausalLM(case["cfg"], device="cpu").load_params(case["tree"])
    with torch.inference_mode():
        return m, m(torch.as_tensor(case["ids"]))


@pytest.mark.parametrize("name", list(CASES) + [
    "compact", "compact_gate_up_replicated"])
def test_tp_forward_matches_one_process_and_jax(tp_run, name):
    res, refs, cases, ids = tp_run
    case = cases[name]
    dtype = "bfloat16" if case["cfg"].dtype == torch.bfloat16 else "float32"
    a, b = res[0][name], res[1][name]
    # both ranks hold the whole (gathered) output
    assert torch.equal(a["logits"], b["logits"])
    model, one = _one_process(case)
    got = a["logits"].float().numpy()
    assert _rel(got, one.float().numpy()) < TOL[dtype]
    tp = case["mesh"][1]
    assert a["kv_heads"] == case["cfg"].num_key_value_heads // tp
    if name in refs:
        jm, jp = refs[name]
        want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(ids)),
                          np.float32)
        assert _rel(got, want) < TOL[dtype]
        if dtype == "float32":
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if case["decode"]:
        np.testing.assert_array_equal(a["tokens"], generate(model, ids, 4))
        if name in refs:
            np.testing.assert_array_equal(
                a["tokens"], j_generate(jm, jp, ids, 4, cache_kind="dense"))
    if case["quant"]:
        qcfg = QuantKVConfig(bits=4, gap=8)
        np.testing.assert_array_equal(
            a["quant_tokens"],
            generate(model, ids, 4, cache_kind="quant", quant_cfg=qcfg))
        np.testing.assert_array_equal(
            a["quant_tokens"], j_generate(
                jm, jp, ids, 4, cache_kind="quant",
                quant_cfg=JQuantKVConfig(bits=4, gap=8)))


# ---------------------------------------------------------------------------
# The TP kernel wrappers against JAX's tp_pallas (interpret mode)
# ---------------------------------------------------------------------------
def _jmesh2():
    return JMesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                 ("data", "model"))


def test_tp_dequant_matmul_matches_jax_interpret():
    from microscopiq_tpu.parallel.tp_pallas import tp_dequant_matmul as jtp

    K, N, M = 256, 512, 8
    W = (RNG.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = RNG.standard_normal((M, K)).astype(np.float32)
    jw = jpk.pack_mx(jnp.asarray(W), 8, "fp6_e3m2", 32, axis=0,
                     transport="emi8")
    want = np.asarray(jtp(_jmesh2(), jnp.asarray(x), jw, interpret=True))
    tw = params_from_jax(to_numpy({"w": jw}), device="cpu")["w"]
    mesh = make_mesh(2, data=1, model=2)
    parts = [tp_dequant_matmul(mesh, torch.from_numpy(x), tw, rank=r,
                               gather=False) for r in range(2)]
    assert parts[0].shape == (M, N // 2)
    got = torch.cat(parts, -1).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_tp_quant_attention_decode_matches_jax_interpret():
    from microscopiq_tpu.kv.cache import (QuantizedDecodeCache,
                                          init_quant_cache as j_init)
    from microscopiq_tpu.parallel.tp_pallas import (
        tp_quant_attention_decode as jtp)
    from microscopiq_tpu_torch.convert import quant_state_from_jax

    B, KVH, hd, gap, maxlen, length, H = 1, 2, 32, 16, 48, 37, 4
    cfg = JQuantKVConfig(bits=4, gap=gap, v_group=hd, rank=2)
    k = jnp.asarray(RNG.standard_normal((B, length, KVH, hd)), jnp.float32)
    v = jnp.asarray(RNG.standard_normal((B, length, KVH, hd)), jnp.float32)

    @jax.jit
    def prefill(st):
        cache = QuantizedDecodeCache(st, cfg)
        cache.update(0, k, v, jnp.arange(length)[None], None)
        return cache.finalize()

    st = prefill(j_init(1, B, maxlen, KVH, hd, cfg))
    names = ("kq", "k_mn", "k_sc", "vq", "v_mn", "v_sc", "res_k", "res_v",
             "k_p", "k_q", "v_p", "v_q")
    full = tuple(getattr(st, n) for n in names)
    q = RNG.standard_normal((B, H, hd)).astype(np.float32)
    want = np.asarray(jtp(_jmesh2(), jnp.asarray(q), full, 0,
                          jnp.int32(length), hd, hd ** -0.5,
                          interpret=True))
    tst = quant_state_from_jax(
        {f.name: (None if getattr(st, f.name) is None
                  else np.asarray(getattr(st, f.name)))
         for f in dataclasses.fields(st)}, device="cpu")
    tfull = tuple(getattr(tst, n) for n in names)
    mesh = make_mesh(2, data=1, model=2)
    parts = [tp_quant_attention_decode(mesh, torch.from_numpy(q), tfull, 0,
                                       length, hd, hd ** -0.5, rank=r,
                                       gather=False) for r in range(2)]
    got = torch.cat(parts, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
