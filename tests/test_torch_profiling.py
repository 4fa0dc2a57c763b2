"""Port offline profilers (microscopiq_tpu_torch.utils.profiling) against
the JAX module on the same seeded inputs. Outlier statistics are counts
and their ratios: equal to JAX's within 1e-6 (float32 means and standard
deviations summed in other orders); the format MSEs within 1e-6 relative
(the quantized values are bit-exact, the mean of their squared errors is
summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.utils import profiling as jpr
from microscopiq_tpu_torch.utils import profiling as tpr
from test_torch_llama import jax_to_numpy, jax_tree, numpy_tree

from microscopiq_tpu.models import LlamaConfig as JConfig
from microscopiq_tpu_torch.convert import params_from_jax


def _w(seed, shape=(64, 96)):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[rng.random(shape) < 0.03] *= 10
    return w


@pytest.mark.parametrize("std_dev,block", [(2.5, 16), (2.0, 32), (3.0, 8)])
def test_analyze_outliers_matches_jax(std_dev, block):
    w = _w(int(std_dev * 10) + block)
    got = tpr.analyze_outliers(torch.as_tensor(w), std_dev, block)
    want = jpr.analyze_outliers(jnp.asarray(w), std_dev, block)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert got["outlier_fraction"] > 0


def test_profile_model_outliers_matches_jax():
    params = jax_tree(numpy_tree(JConfig.tiny()), jnp.float32, packed=False)
    want = jpr.profile_model_outliers(params)
    got = tpr.profile_model_outliers(params_from_jax(jax_to_numpy(params),
                                                     device="cpu"))
    assert got.keys() == want.keys() and len(got) == 15   # lm_head too
    for path in want:
        for k in want[path]:
            assert got[path][k] == pytest.approx(want[path][k], abs=1e-6)


@pytest.mark.parametrize("block", [0, 32])
def test_format_mse_profile_matches_jax(block):
    kw = dict(mean=0.5, std=2.0, n=1 << 12, seed=3, block_size=block)
    got = tpr.format_mse_profile(device="cpu", **kw)
    want = jpr.format_mse_profile(**kw)
    assert got.keys() == want.keys()
    for fmt in want:
        assert got[fmt] == pytest.approx(want[fmt], rel=1e-6), fmt
    assert got["int8"] < got["int4"] and got["fp6_e3m2"] < got["fp4_e2m1"]
