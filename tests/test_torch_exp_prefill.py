"""The prefill-GEMM experiments of the port (``ops/cuda/exp_prefill.py``,
``scripts/exp_prefill_*.py``) on the CPU, against the JAX package.

The TPU kernels of ``scripts/exp_prefill_*.py`` are closures behind a TPU
check, so the port's plain versions are held to what those scripts hold
their kernels to: JAX's ``dequant_matmul_reference`` on the same weight
(``rtol=2e-5, atol=1e-4``, tests/test_pallas_kernels.py:68) and the shipped
``_dq_matmul_kernel`` in interpret mode (2e-3 of max |reference|, bf16 MMA
with f32 accumulation), at a small shape. The bf16-weight arm (``pre``) is
held to a bf16 dot with f32 accumulation in JAX. On the CPU each wrapper
runs its plain version and counts no launch; the kernels themselves are
held to these plain versions on a card by tests/test_torch_kernels_gpu.py.
"""

import contextlib
import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul as j_dequant_matmul,
    dequant_matmul_reference as j_reference,
)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import exp_prefill as ep
from microscopiq_tpu_torch.scripts import (_prefill, exp_prefill_floor,
                                           exp_prefill_overlap,
                                           exp_prefill_pipe,
                                           exp_prefill_tiles2)

K, N, M = 256, 512, 256           # every arm's tiles divide it
SCRIPTS = {m.NAME: m for m in (exp_prefill_floor, exp_prefill_tiles2,
                               exp_prefill_overlap, exp_prefill_pipe)}
# (script, arm) of every arm that runs a kernel of csrc/exp_prefill.cu
KERNEL_ARMS = [(name, a.name) for name, m in SCRIPTS.items()
               for a in m.arms() if a.kernel.startswith("exp_gemm")]


def _arm(script, name):
    return next(a for a in SCRIPTS[script].arms() if a.name == name)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def pair():
    """The scripts' setup at a small shape, from numpy weights packed by
    both packages, with JAX's outputs on each weight."""
    rng = np.random.default_rng(0)
    W = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    tw = {"wd": torch.from_numpy(W).to(torch.bfloat16),
          "emi8": tpk.to_serving_layout(tpk.pack_mx(
              torch.from_numpy(W), 8, "fp6_e3m2", 32, axis=0,
              transport="emi8")),
          "int8": tpk.to_serving_layout(tpk.pack_mx(
              torch.from_numpy(W), 8, "int8", 32, axis=0))}
    jw = {"emi8": jpk.to_serving_layout(jpk.pack_mx(
              jnp.asarray(W), 8, "fp6_e3m2", 32, axis=0, transport="emi8")),
          "int8": jpk.to_serving_layout(jpk.pack_mx(
              jnp.asarray(W), 8, "int8", 32, axis=0))}
    xj = jnp.asarray(xb.float().numpy())          # the same bf16 x
    ref = {k: np.asarray(j_reference(xj, jpk.from_serving_layout(w)))
           for k, w in jw.items()}
    ref["wd"] = np.asarray(jnp.dot(
        xj.astype(jnp.bfloat16), jnp.asarray(W).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32))
    kern = {k: np.asarray(j_dequant_matmul(xj, w, interpret=True))
            for k, w in jw.items()}
    setup = _prefill.Setup(device=torch.device("cpu"), card="cpu", x=xb,
                           weights={k: [w] for k, w in tw.items()})
    return setup, jw, ref, kern


@pytest.mark.parametrize("weight", ["emi8", "int8"])
def test_both_packages_pack_the_same_codes(pair, weight):
    setup, jw, _, _ = pair
    t, j = setup.weights[weight][0], jw[weight]
    assert np.array_equal(t.codes.numpy(), np.asarray(j.codes))
    assert np.array_equal(t.scale_exp.numpy(), np.asarray(j.scale_exp))


@pytest.mark.parametrize("weight", ["wd", "emi8", "int8"])
def test_plain_version_matches_jax(pair, weight):
    setup, _, ref, kern = pair
    y = ep.reference(setup.x, setup.weights[weight][0]).numpy()
    np.testing.assert_allclose(y, ref[weight], rtol=2e-5, atol=1e-4)
    if weight in kern:                      # the Pallas GEMM, interpret mode
        assert _rel(y, kern[weight]) < 2e-3


@pytest.mark.parametrize("script,arm", KERNEL_ARMS)
def test_wrapper_on_cpu_is_its_plain_version(pair, script, arm):
    """Each wrapper, on CPU tensors, returns its plain version's output (in
    its out dtype), which agrees with JAX; no launch is counted."""
    setup, _, ref, kern = pair
    a = _arm(script, arm)
    w = setup.weights[a.weight][0]
    ep.reset_launch_counts()
    y = a.call(setup.x, w)
    assert not any(ep.launch_counts.values())
    assert a.kernel in ep.launch_counts
    assert y.dtype == a.out_dtype and tuple(y.shape) == (M, N)
    assert torch.equal(y, ep.reference(setup.x, w, a.out_dtype))
    yf = y.float().numpy()
    if a.out_dtype == torch.float32:
        np.testing.assert_allclose(yf, ref[a.weight], rtol=2e-5, atol=1e-4)
    else:                                   # bf16 out: its rounding
        assert _rel(yf, ref[a.weight]) < 2 ** -8
    if a.weight in kern:
        assert _rel(yf, kern[a.weight]) < 2e-3 + (
            0 if a.out_dtype == torch.float32 else 2 ** -8)


def _bad_configs(setup):
    x = setup.x
    w, w8, wd = (setup.weights[k][0] for k in ("emi8", "int8", "wd"))
    Wr = torch.randn(200, 64)                 # K = 200: not whole blocks
    ragged = tpk.to_serving_layout(tpk.pack_mx(Wr, 8, "fp6_e3m2", 32,
                                               axis=0, transport="emi8"))
    return {
        "rx_shared_memory": (
            "shared memory", lambda: ep.gemm_rx(x, w, tn=512, bk=128)),
        "tiles_shared_memory": (
            "shared memory",
            lambda: ep.gemm_tiles(x, w, bm=256, bn=256, bk=256)),
        "tile_does_not_divide_M": (
            "does not divide",
            lambda: ep.gemm_tiles(x[:100], w, bm=128, bn=128, bk=32)),
        "tile_does_not_divide_N": (
            "does not divide",
            lambda: ep.gemm_pipe(x, _first_columns(w, 384), bm=128, bn=256,
                                 bk=32)),
        "pre_tile_does_not_divide_K": (
            "does not divide", lambda: ep.gemm_pre(x[:, :48], wd[:48])),
        "s_does_not_divide_bk": (
            "sub-chunks", lambda: ep.gemm_unroll(x, w, s=3, interleave=True,
                                                 bm=128, bn=128, bk=64)),
        "sub_chunk_under_16_rows": (
            "sub-chunks", lambda: ep.gemm_unroll(x, w, s=8, interleave=True,
                                                 bm=128, bn=128, bk=64)),
        "tiles_not_compiled": (
            "not compiled",
            lambda: ep.gemm_tiles(x, w, bm=64, bn=64, bk=32)),
        "unroll_not_compiled": (
            "not compiled", lambda: ep.gemm_unroll(x, w8, s=4,
                                                   interleave=True, bm=128,
                                                   bn=128, bk=64)),
        "pipe_not_compiled": (
            "not compiled", lambda: ep.gemm_pipe(x, w, bm=64, bn=128,
                                                 bk=32)),
        "rx_not_compiled": (
            "not compiled", lambda: ep.gemm_rx(x, w, tn=128)),
        "k_not_whole_blocks": (
            "multiple of the block",
            lambda: ep.gemm_rx(torch.zeros(16, 200), ragged, tn=64)),
        "pipe_takes_emi8_only": (
            "takes", lambda: ep.gemm_pipe(x, w8, bm=128, bn=128, bk=32)),
        "pre_needs_bf16": (
            "bf16", lambda: ep.gemm_pre(x, wd.float())),
        "x_of_another_K": (
            "must be", lambda: ep.gemm_rx(x[:, :128], w, tn=256)),
    }


def _first_columns(w, n):
    """w cut to its first n columns (a weight whose N is n)."""
    return dataclasses.replace(w, codes=w.codes[..., :n].contiguous(),
                               scale_exp=w.scale_exp[..., :n].contiguous())


BAD = ["rx_shared_memory", "tiles_shared_memory", "tile_does_not_divide_M",
       "tile_does_not_divide_N", "pre_tile_does_not_divide_K",
       "s_does_not_divide_bk", "sub_chunk_under_16_rows",
       "tiles_not_compiled", "unroll_not_compiled", "pipe_not_compiled",
       "rx_not_compiled", "k_not_whole_blocks", "pipe_takes_emi8_only",
       "pre_needs_bf16", "x_of_another_K"]


@pytest.mark.parametrize("case", BAD)
def test_invalid_tile_configuration_raises(pair, case):
    """Checked on any device, before the CPU's plain version runs."""
    cases = _bad_configs(pair[0])
    assert sorted(cases) == sorted(BAD)
    match, call = cases[case]
    ep.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        call()
    assert not any(ep.launch_counts.values())


def test_smem_of_the_gate_up_arms_fits_and_32_x_rows_would_not():
    assert ep.rx_smem(4096, 512, 32) <= ep.SMEM_MAX
    assert 2 * ep.RX_ROWS * (4096 + 8) * 2 > ep.SMEM_MAX   # 32 rows of x
    for _, bm, bn, bk in ep.TILES:
        assert ep.tiles_smem(bm, bn, bk) <= ep.SMEM_MAX
    for _, s, _, bm, bn, bk in ep.UNROLL:
        assert ep.unroll_smem(bm, bn, bk, s) <= ep.SMEM_MAX


@pytest.mark.parametrize("M_,N_,tn,want", [(1024, 28672, 256, 56),
                                           (1024, 28672, 512, 28),
                                           (256, 512, 256, 1),
                                           (16, 1024, 256, 1)])
def test_rx_tiles_per_block(M_, N_, tn, want):
    tiles = ep.rx_tiles_per_block(M_, N_, tn, 132)
    assert tiles == want
    assert (N_ // tn) % tiles == 0
    assert (M_ // ep.RX_ROWS) * (N_ // tn // tiles) <= max(132, M_ // 16)


def _run_main(mod, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recs = mod.main([], device="cpu", K=K, N=N, M=M, **kw)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    return recs, lines


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_main_on_cpu_prints_one_line_per_arm(name):
    mod = SCRIPTS[name]
    recs, lines = _run_main(mod)
    arm_lines = [ln for ln in lines if "arm" in ln]
    assert arm_lines == recs
    assert [r["arm"] for r in recs] == [a.name for a in mod.arms()]
    assert recs[0]["arm"] == "dense" and recs[0]["rel_err"] is None
    assert any(r["arm"] == "inkernel" for r in recs)
    for r in recs:
        assert r["script"] == name and r["card"] == "cpu"
        assert (r["M"], r["K"], r["N"]) == (M, K, N)
        assert r["ms"] is None and r["vs_dense"] is None   # nothing timed
        assert r["bound_ms"] > 0
        if r["arm"] == "dense":
            continue
        if r["out"] == "f32":
            assert r["rel_err"] == 0.0
        else:
            assert 0 <= r["rel_err"] < 2 ** -8


def test_floor_prints_and_writes_its_decomposition(tmp_path):
    out = tmp_path / "floor.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        exp_prefill_floor.main(["--out", str(out)], device="cpu", K=K, N=N,
                               M=M)
    last = json.loads(buf.getvalue().splitlines()[-1])
    dec = last["decomposition"]
    assert json.loads(out.read_text()) == dec
    assert set(dec["arms_ms"]) == {a.name for a in exp_prefill_floor.arms()}
    assert dec["shape"] == {"K": K, "N": N, "M": M, "block": 32}
    with pytest.raises(ValueError, match="TPU"):
        exp_prefill_floor.main(["--out", str(tmp_path / exp_prefill_floor
                                             .TPU_RECORD)], device="cpu",
                               K=K, N=N, M=M)
    assert not (tmp_path / exp_prefill_floor.TPU_RECORD).exists()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_main_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCRIPTS[name].main([])


def test_ptxas_report_names_each_kernel(tmp_path, monkeypatch):
    """The build's report pairs each kernel with its registers and spills
    (the experiments read occupancy from it)."""
    from microscopiq_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    name = ("_ZN47_GLOBAL__N__cb217a5d_14_exp_prefill_cu_e541f9617"
            "gemm_rxILi512ELi32EEEvPK13__nv_bfloat16PKaS5_Pfiiiiii")
    build._lib_path("exp_prefill").with_suffix(".ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {name}\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n")
    assert build.ptxas_report(("exp_prefill", "mx_quant")) == [
        "exp_prefill gemm_rxILi512ELi32EEEvPK13__nv_bfloat16PKaS5_Pfiiiiii: "
        "Used 128 registers, used 1 barriers; 8 bytes stack frame, 8 bytes "
        "spill stores, 8 bytes spill loads"]
