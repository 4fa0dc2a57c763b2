"""Rules of the PyTorch/CUDA port: it imports neither JAX nor the JAX
package, its entry points never fall back to the CPU when asked for a CUDA
device, chip_smoke.py refuses to run without a card, and card-only tests
are marked ``gpu``."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import microscopiq_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax"))
             or m == "microscopiq_tpu" or m.startswith("microscopiq_tpu."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 70
    assert bad == "[]", bad


_SLICE19 = ("microscopiq_tpu_torch.posit", "microscopiq_tpu_torch.posit.posit",
            "microscopiq_tpu_torch.quant.vq", "microscopiq_tpu_torch.parallel",
            "microscopiq_tpu_torch.parallel.distributed",
            "microscopiq_tpu_torch.parallel.mesh",
            "microscopiq_tpu_torch.parallel.tp_kernels",
            "microscopiq_tpu_torch.scripts.check_tp",
            "microscopiq_tpu_torch.scripts.parity")


def test_posit_vq_parallel_and_their_scripts_import_no_jax():
    """The rule holds for the subpackages and scripts of posit, VQ and the
    parallel layer, each imported alone."""
    code = ("import importlib, sys\n"
            f"for n in {_SLICE19!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'flax')) or "
            "m == 'microscopiq_tpu' or m.startswith('microscopiq_tpu.'))\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _need_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_cuda_entry_points_raise_without_a_card():
    _need_no_cuda()
    from microscopiq_tpu_torch.convert import (params_from_jax,
                                               quant_state_from_jax)
    from microscopiq_tpu_torch.kv.cache import (init_dense_cache,
                                                init_quant_cache,
                                                init_slot_quant_cache)
    from microscopiq_tpu_torch.kv.h2o import (init_h2o_cache,
                                              init_quant_h2o_cache,
                                              init_slot_h2o_cache)
    from microscopiq_tpu_torch.kv.sink import init_sink_cache
    from microscopiq_tpu_torch.utils.profiling import format_mse_profile
    from microscopiq_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                              OPTConfig, OPTForCausalLM,
                                              build_params)
    from microscopiq_tpu_torch.models import opt
    from microscopiq_tpu_torch.serve.engine import (BatchEngine,
                                                    init_slot_cache)
    from microscopiq_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant_state_from_jax({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OPTForCausalLM(OPTConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt.build_params(OPTConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint("checkpoint-that-is-never-read")
    for init in (init_dense_cache, init_slot_cache, init_quant_cache,
                 init_slot_quant_cache, init_h2o_cache, init_quant_h2o_cache,
                 init_slot_h2o_cache):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init(1, 1, 64, 1, 32)
        init(1, 1, 64, 1, 32, device="cpu")           # the CPU when asked
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_sink_cache(1, 1, 4, 60, 1, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        format_mse_profile(n=64)
    from microscopiq_tpu_torch.eval.retrieval import (CopyTask,
                                                      init_train_params,
                                                      train_copy)
    from microscopiq_tpu_torch.models import loading
    from microscopiq_tpu_torch.scripts import kv_accuracy

    for family in (LlamaConfig.llama2_7b, LlamaConfig.mistral_7b,
                   LlamaConfig.mixtral_8x7b, LlamaConfig.mpt_7b):
        small = family(num_hidden_layers=1, hidden_size=64,
                       intermediate_size=64, vocab_size=64,
                       num_attention_heads=4, num_key_value_heads=4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LlamaForCausalLM(small)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_params(small)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loading.read_safetensors("checkpoint-that-is-never-read")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loading.load_hf_state_dict("checkpoint-that-is-never-read")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loading.state_dict_from_torch_model(torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv_accuracy.model_and_task(n=8)
    from microscopiq_tpu_torch.scripts import mx_ffn

    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx_ffn.train(mx_ffn.numpy_start(32, rows=8), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx_ffn.main(["--steps", "1", "--dim", "32"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_copy(LlamaForCausalLM(cfg), CopyTask(n=4), steps=1)
    from microscopiq_tpu_torch import nn as tnn

    for make in (lambda d: tnn.MXLinear(8, 8, device=d),
                 lambda d: tnn.Conv2d(4, 4, 3, device=d),
                 lambda d: tnn.LSTMCell(4, 4, device=d),
                 lambda d: tnn.LSTM(4, 4, device=d),
                 lambda d: tnn.GroupNorm(2, 4, device=d),
                 lambda d: tnn.BatchNorm(4, device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make("cuda")
        make("cpu")                                   # the CPU when asked
    from microscopiq_tpu_torch.posit import Posit
    from microscopiq_tpu_torch.scripts import check_tp, parity

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Posit(8, 1)
    Posit(8, 1, device="cpu")                         # the CPU when asked
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_tp.run_rank(0, 1, 0, "gloo", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.run(({}, {}), None, None)
    cpu_model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchEngine(cpu_model)
    for kind in ("quant", "h2o"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchEngine(cpu_model, cache_kind=kind)


def test_kernel_wrappers_reject_cpu_weights_for_cuda_inputs():
    """The CUDA path validates devices before launching; on the CPU the
    plain version runs and no kernel launch is counted."""
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm
    from microscopiq_tpu_torch.ops.packing import pack_mx, to_serving_layout

    w = to_serving_layout(pack_mx(torch.randn(64, 32), 8, "fp6_e3m2", 32,
                                  axis=0, transport="emi8"))
    dm.reset_launch_counts()
    y = dm.dequant_matmul(torch.randn(2, 64), w)
    assert y.shape == (2, 32)
    assert sum(dm.launch_counts.values()) == 0


def test_outlier_wrappers_take_the_twin_on_cpu_and_check_devices():
    """The NB and side-band wrappers run their plain twin on CPU tensors,
    count no launch, and raise when x and the weight lie on different
    devices (never a silent move or fallback)."""
    import dataclasses

    from microscopiq_tpu_torch.ops import packing as pk
    from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om
    from microscopiq_tpu_torch.ops.outlier import (
        quantize_mx_outlier_hessian_decisions)

    g = torch.Generator().manual_seed(0)
    W = torch.randn(64, 48, generator=g) * 0.02
    W[::7, ::5] *= 10
    _, _, dec = quantize_mx_outlier_hessian_decisions(
        W.T.contiguous(), 8, 8, "int2", "fp4_e2m1", "max", 2.0, [0], 16,
        max_outliers_per_block=2)
    nb = pk.pack_outlier_nb({**dec, "block_size": 16}, budget=2)
    sb = pk.pack_mx_outlier(W, 8, 8, "int2", "fp4_e2m1", block_size=16,
                            outlier_budget=4, axis=0)
    om.reset_launch_counts()
    for M in (3, om.GEMM_FROM_M + 44):
        x = torch.randn(M, 64, generator=g)
        for fns, ref, w in (
                ((om.dequant_matmul_nb, om.dequant_gemv_nb,
                  om.dequant_gemm_nb), om.dequant_matmul_nb_reference, nb),
                ((om.dequant_matmul_outlier, om.dequant_gemv_outlier,
                  om.dequant_gemm_outlier),
                 om.dequant_matmul_outlier_reference, sb)):
            for fn in fns:
                assert torch.equal(fn(x, w), ref(x, w))
    assert sum(om.launch_counts.values()) == 0
    x = torch.randn(3, 64, generator=g)
    with pytest.raises(ValueError, match="one device"):
        om.dequant_matmul_nb(x, dataclasses.replace(
            nb, out_byte=nb.out_byte.to("meta")))
    with pytest.raises(ValueError, match="one device"):
        om.dequant_matmul_outlier(x.to("meta"), sb)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    _need_no_cuda()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0 and out.stdout == ""
    # alone in a directory, without the package, it fails too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_gpu_marker_is_registered(request):
    markers = request.config.getini("markers")
    assert any(m.startswith("gpu:") for m in markers)
