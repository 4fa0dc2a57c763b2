"""y = x @ dequant(W) for the outlier formats: the port's plain twins
against the JAX kernels run as the JAX tests run them (Pallas interpret
mode), on weights packed by both packages from the same numpy inputs. The
CUDA kernels are held against the twins on a card by
tests/test_torch_kernels_gpu.py.

Tolerances, the JAX tests' own:
- NB twin vs ``dequant_matmul_nb``: atol 3e-6 of max |reference|
  (tests/test_packing.py::test_dequant_matmul_nb_kernel_matches_reference);
- side-band twin vs ``dequant_matmul_outlier``: rtol 2e-5, atol 1e-4
  (tests/test_pallas_kernels.py::
  test_dequant_matmul_outlier_matches_reference);
- port twin vs JAX twin: 1e-6 of max |reference|, the same bf16 weights and
  exact products summed in float32 by two libraries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.ops.pallas.dequant_matmul import (
    dequant_matmul_nb as j_nb, dequant_matmul_nb_reference as j_nb_ref,
    dequant_matmul_outlier as j_outlier,
    dequant_matmul_outlier_reference as j_outlier_ref)
from microscopiq_tpu_torch.ops import packing as tpk
from microscopiq_tpu_torch.ops.cuda import outlier_matmul as om


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(M, K, seed):
    return np.random.default_rng(seed).standard_normal((M, K)
                                                       ).astype(np.float32)


def _max_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max(), np.abs(want).max()


def _nb_pair(cap, N, K, budget, seed=3):
    """GPTQ decisions from the JAX package (tests/test_packing.py), packed
    by both packages."""
    from test_packing import _gptq_decisions

    _, dec = _gptq_decisions(cap=cap, seed=seed, N=N, K=K)
    j = jpk.pack_outlier_nb(dec, budget=budget)
    t = tpk.pack_outlier_nb({k: (_t(v) if hasattr(v, "shape") else v)
                             for k, v in dec.items()}, budget=budget)
    np.testing.assert_array_equal(t.out_byte.numpy(), np.asarray(j.out_byte))
    return j, t


@pytest.mark.parametrize("cap,M", [(2, 3), (2, 1), (1, 8)])
def test_nb_twin_matches_jax_kernel(cap, M):
    j, t = _nb_pair(cap, 160, 128, cap)
    x = _x(M, 128, 9 + M)
    y_t = om.dequant_matmul_nb(_t(x), t).numpy()
    y_j = np.asarray(j_nb(jnp.asarray(x), j, interpret=True))
    assert y_t.shape == (M, 160)
    err, ref = _max_err(y_t, y_j)
    assert err <= 3e-6 * ref
    err, ref = _max_err(y_t, j_nb_ref(jnp.asarray(x), j))
    assert err <= 1e-6 * ref


def test_nb_twin_multi_k_and_m_tiles(monkeypatch):
    """nk >= 2 and three M tiles on the JAX side (the tiles are set there
    only; the port's twin has none)."""
    monkeypatch.setenv("MICROSCOPIQ_NB_TK", "128")   # K=256 -> nk=2
    monkeypatch.setenv("MICROSCOPIQ_NB_TM", "8")     # M=20 -> 3 M tiles
    j, t = _nb_pair(2, 160, 256, 2)
    x = _x(20, 256, 10)
    y_t = om.dequant_matmul_nb(_t(x), t).numpy()
    y_j = np.asarray(j_nb(jnp.asarray(x), j, interpret=True))
    err, ref = _max_err(y_t, y_j)
    assert err <= 3e-6 * ref


def test_nb_twin_ragged_n_and_batched_input():
    """N = 40 pads to 48 rows in storage; the output keeps 40 columns."""
    j, t = _nb_pair(2, 40, 64, 2, seed=5)
    x = np.random.default_rng(6).standard_normal((2, 3, 64)
                                                 ).astype(np.float32)
    y = om.dequant_matmul_nb(_t(x), t, out_dtype=torch.bfloat16)
    assert y.shape == (2, 3, 40) and y.dtype == torch.bfloat16
    want = np.asarray(j_nb(jnp.asarray(x.reshape(6, 64)), j, interpret=True))
    err, ref = _max_err(y.float().numpy().reshape(6, 40), want)
    assert err <= 2 ** -8 * ref


def _sideband_pair(ifmt, ofmt, K, N, budget, seed):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((K, N))
         * np.exp(rng.uniform(-1, 1, (1, N)))).astype(np.float32)
    W.ravel()[rng.integers(0, K * N, K * N // 64)] *= 25.0
    args = (8, 8, ifmt, ofmt)
    kw = dict(std_dev=2.0, block_size=16, outlier_budget=budget, axis=0)
    return (jpk.pack_mx_outlier(jnp.asarray(W), *args, **kw),
            tpk.pack_mx_outlier(_t(W), *args, **kw))


@pytest.mark.parametrize("ifmt,ofmt,K,N,M,budget", [
    ("int2", "fp4_e2m1", 256, 256, 4, 4),
    ("fp6_e3m2", "fp8_e4m3", 256, 256, 4, 4),
    ("int2", "fp4_e2m1", 1024, 200, 3, 2),         # two K tiles, ragged N
    ("int2", "fp4_e2m1", 512, 256, 200, 4),        # two M tiles
])
def test_sideband_twin_matches_jax_kernel(ifmt, ofmt, K, N, M, budget):
    j, t = _sideband_pair(ifmt, ofmt, K, N, budget, seed=K + M)
    x = _x(M, K, M)
    y_t = om.dequant_matmul_outlier(_t(x), t).numpy()
    y_j = np.asarray(j_outlier(jnp.asarray(x), j, interpret=True))
    assert y_t.shape == (M, N)
    np.testing.assert_allclose(y_t, y_j, rtol=2e-5, atol=1e-4)
    err, ref = _max_err(y_t, j_outlier_ref(jnp.asarray(x), j))
    assert err <= 1e-6 * ref


def kernel_semantics_dense(w):
    """The dense weight the TPU side-band kernel computes: inlier code ·
    2^(se - fold) plus outlier code · 2^(seo - se) with NO fold on the
    outlier code, rounded to bf16 (float64 numpy, from the port's leaf)."""
    inl = w.inlier
    B = inl.block_size
    fold = om._scale_fold(inl.elem_format)
    codes = inl.codes.to(torch.float32).numpy().astype(np.float64)
    se = np.repeat(inl.scale_exp.numpy().astype(np.float64), B, 0)
    seo = np.repeat(w.out_scale_exp.numpy().astype(np.float64), B, 0)
    dense = codes * np.exp2(se - fold)
    oc = w.out_codes.to(torch.float32).numpy().astype(np.float64)
    pos = w.out_pos.numpy()
    rows = np.arange(codes.shape[0]) % B
    for s in range(pos.shape[-1]):
        hit = rows[:, None] == np.repeat(pos[..., s], B, 0)
        dense += np.where(hit, np.repeat(oc[..., s], B, 0), 0.0) * np.exp2(
            seo - se)
    return torch.from_numpy(dense.astype(np.float32)).to(torch.bfloat16)


def test_int_outlier_format_kernel_does_not_fold_the_code():
    """The trap of ROADMAP queue 3: for an int outlier format of more than
    2 bits the TPU kernel scales the outlier *code* by 2^(seo - se) with no
    fold, where the twin decodes it by 2^-(mbits-2) first. With int8
    outliers the kernel's outlier contributions are 64x the twin's; the
    kernel equals the no-fold dense weight below, which the CUDA kernel is
    held to on the card."""
    j, t = _sideband_pair("int2", "int8", 256, 128, 4, seed=21)
    x = _x(4, 256, 22)
    y_k = np.asarray(j_outlier(jnp.asarray(x), j, interpret=True))
    y_twin = om.dequant_matmul_outlier(_t(x), t).numpy()
    dense = kernel_semantics_dense(t).to(torch.float32)
    y_nofold = (torch.from_numpy(x).to(torch.bfloat16).float() @ dense
                ).numpy()
    np.testing.assert_allclose(y_k, y_nofold, rtol=2e-5, atol=1e-4)
    err, ref = _max_err(y_k, y_twin)
    assert err > 0.5 * ref             # far apart: the 64x outliers
    # int2 and fp outlier formats have no fold: kernel and twin agree
    j2, t2 = _sideband_pair("int2", "fp4_e2m1", 256, 128, 4, seed=21)
    dense2 = kernel_semantics_dense(t2).to(torch.float32)
    np.testing.assert_array_equal(dense2.numpy(), tpk.dequantize_mx_outlier(
        t2, torch.bfloat16).float().numpy())


@pytest.mark.parametrize("K,N", [(4096, 6144), (4096, 4096), (4096, 28672),
                                 (14336, 4096), (4096, 128256), (200, 48)])
def test_nb_ksplit_covers_k_and_ignores_m(K, N):
    """The NB GEMV's K split (nb_gemv_plan: 128-column stages) covers every
    column once and is the same at every M."""
    Np = -(-N // 16) * 16
    plans = [om.nb_gemv_plan(Np, K, 2, M) for M in (1, 8, 64, 255)]
    stages = -(-K // om.NB_GEMV_K)
    for p in plans:
        ks, per = p["ksplit"], p["split_stages"]
        assert ks * per >= stages > (ks - 1) * per  # every column, once
    assert len({(p["ksplit"], p["split_stages"]) for p in plans}) == 1