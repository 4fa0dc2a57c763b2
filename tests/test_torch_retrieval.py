"""The port's KV-cache accuracy probes (``eval/retrieval.py``) against the
JAX package's: the numpy samplers bit-equal; three training updates of
``train_copy`` (warm-up schedule, whose first rate is 0) and
``train_retrieval`` (AdamW under a cosine decay) from JAX's initial
weights equal optax's (float32: 1e-5 of each leaf's max |value| for
``train_copy``, 1e-4 for ``train_retrieval``, whose full first rate lets
Adam magnify float32 gradient differences); the optimizer on the same
float64 gradients and rates equals optax's within 1e-12; the schedules
equal optax's float32 values within 1e-5 relative; and ``copy_accuracy`` /
``retrieval_accuracy`` on a tiny trained model equal to JAX's through the
dense, 4-bit quantized and H2O caches. The probe script's arms and
ordering checks match ``scripts/kv_accuracy.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu.eval import retrieval as jr
from microscopiq_tpu.kv.cache import QuantKVConfig as JQuant
from microscopiq_tpu.models import LlamaConfig as JConfig
from microscopiq_tpu.models import LlamaForCausalLM as JModel
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.eval import retrieval as tr
from microscopiq_tpu_torch.kv.cache import QuantKVConfig
from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread a core makes the workers' training and
    matmuls contend for the cores (a 10x slowdown inside the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _max_rel(got, want):
    worst = 0.0
    for k in want:
        if isinstance(want[k], dict):
            worst = max(worst, _max_rel(got[k], want[k]))
        else:
            w = np.asarray(want[k], np.float64)
            g = got[k].detach().double().numpy()
            worst = max(worst, np.abs(g - w).max() / np.abs(w).max())
    return worst


@pytest.mark.parametrize("seed", [0, 3])
def test_samplers_bit_equal(seed):
    rt = jr.RetrievalTask(n_keys=20, n_vals=12, n_pairs=9)
    for q in (1, 4):
        a = jr.sample_batch(np.random.default_rng(seed), rt, 6, q)
        b = tr.sample_batch(np.random.default_rng(seed), rt, 6, q)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert tr.RetrievalTask(n_pairs=5).prompt_len == \
        jr.RetrievalTask(n_pairs=5).prompt_len
    ct = jr.CopyTask(vocab_extra=40, n=11)
    a = jr.sample_copy(np.random.default_rng(seed), ct, 5)
    b = tr.sample_copy(np.random.default_rng(seed),
                       tr.CopyTask(vocab_extra=40, n=11), 5)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _cfgs(vocab):
    kw = dict(vocab_size=vocab, hidden_size=64, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=96,
              max_position_embeddings=128)
    return JConfig.tiny(**kw), LlamaConfig.tiny(**kw)


def _train_both(which, dtype):
    """(JAX's init, optax's weights after 3 updates, the port's, the port's
    after 1 update) in ``dtype`` (float32 as the probes train)."""
    jd, td = {"float32": (jnp.float32, torch.float32),
              "float64": (jnp.float64, torch.float64)}[dtype]
    if which == "copy":
        jtask, ttask = (jr.CopyTask(vocab_extra=30, n=12),
                        tr.CopyTask(vocab_extra=30, n=12))
        L = 2 * 12 + 2
    else:
        jtask, ttask = (jr.RetrievalTask(n_keys=16, n_vals=16, n_pairs=6),
                        tr.RetrievalTask(n_keys=16, n_vals=16, n_pairs=6))
        L = 2 * 6 + 2 + 2 * 3
    jcfg, tcfg = _cfgs(jtask.vocab_size)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "dtype": jd})
    tcfg = tcfg.__class__(**{**tcfg.__dict__, "dtype": td})
    with jax.enable_x64(dtype == "float64"):
        jm = JModel(jcfg, use_pallas=False)
        init = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32))
        tm = LlamaForCausalLM(tcfg, device="cpu")
        t_init = params_from_jax(_np(init), device="cpu")
        if which == "copy":
            want = jr.train_copy(jm, jtask, steps=3, B=8, lr=3e-3, seed=0)
            got = tr.train_copy(tm, ttask, steps=3, B=8, lr=3e-3, seed=0,
                                init_params=t_init)
            one = tr.train_copy(tm, ttask, steps=1, B=8, seed=0,
                                init_params=t_init)
        else:
            want = jr.train_retrieval(jm, jtask, steps=3, B=8, lr=2e-3,
                                      seed=0, n_queries=3)
            got = tr.train_retrieval(tm, ttask, steps=3, B=8, lr=2e-3,
                                     seed=0, n_queries=3, init_params=t_init)
            one = None
    return _np(init["params"]), _np(want["params"]), got["params"], one


@pytest.mark.parametrize("which", ["copy", "retrieval"])
def test_three_train_steps_match_optax(which):
    """float32, as the probes train: train_copy within 1e-5 of each leaf's
    max |value|; train_retrieval within 1e-4, because its cosine schedule
    takes the full rate from the first update and Adam's normalized step
    magnifies float32 gradient differences where consecutive gradients
    nearly cancel (measured 6e-5); on the same float64 gradients the
    optimizer is optax's (below)."""
    init, want, got, one = _train_both(which, "float32")
    assert _max_rel(got, want) < (1e-5 if which == "copy" else 1e-4)
    assert _max_rel(got, init) > 1e-4                      # they moved
    if which == "copy":
        # the warm-up's first rate is 0: one update leaves the weights
        assert _max_rel(one["params"], init) == 0.0


@pytest.mark.parametrize("wd", [0.0, 1e-4], ids=["adam", "adamw"])
def test_optimizer_matches_optax_float64(wd):
    """The loops' optimizer on the same float64 gradients and rates:
    optax's adam (train_copy's) and adamw (train_retrieval's) within
    1e-12, so the float32 gaps above come from the forward and backward
    passes."""
    import optax

    rng = np.random.default_rng(0)
    w0 = {"a": rng.standard_normal((5, 3)), "b": rng.standard_normal(7)}
    grads = [{k: rng.standard_normal(v.shape) * 10.0 ** -rng.integers(0, 6)
              for k, v in w0.items()} for _ in range(6)]
    with jax.enable_x64(True):
        if wd:
            sched_j = optax.cosine_decay_schedule(2e-3, 5, alpha=0.05)
            opt_j = optax.adamw(sched_j, weight_decay=wd)
        else:
            sched_j = optax.join_schedules(
                [optax.linear_schedule(0.0, 3e-3, 3),
                 optax.constant_schedule(3e-3)], [3])
            opt_j = optax.adam(sched_j)
        # optax evaluates its schedules at its int32 count, in float32 even
        # under x64: hand the port the same rates (the schedules are held
        # to optax's below)
        rates = [float(sched_j(jnp.asarray(t, jnp.int32)))
                 for t in range(len(grads) + 1)]
        wj = jax.tree_util.tree_map(jnp.asarray, w0)
        state = opt_j.init(wj)
        for g in grads:
            upd, state = opt_j.update(jax.tree_util.tree_map(jnp.asarray, g),
                                      state, wj)
            wj = optax.apply_updates(wj, upd)
        wj = _np(wj)
    wt = {k: torch.tensor(v, requires_grad=True) for k, v in w0.items()}
    opt, rate = tr.optimizer(list(wt.values()), lambda t: rates[t], wd)
    for g in grads:
        for k, v in wt.items():
            v.grad = torch.tensor(g[k])
        opt.step()
        rate.step()
    for k in w0:
        np.testing.assert_allclose(wt[k].detach().numpy(), wj[k],
                                   rtol=1e-12, atol=1e-15)


def test_schedules_are_optax():
    """Within 1e-5 relative: optax evaluates in float32, and its warm-up as
    (0 - lr) * (1 - t / 150) + lr, which cancels at small t (4e-6
    relative at t = 1); the port computes lr * t / 150 in float64."""
    import optax

    cos = optax.cosine_decay_schedule(2e-3, 50, alpha=0.05)
    warm = optax.join_schedules([optax.linear_schedule(0.0, 3e-3, 150),
                                 optax.constant_schedule(3e-3)], [150])
    for t in (0, 1, 7, 49, 50, 80, 149, 150, 151, 400):
        assert tr.cosine_decay(2e-3, 50, 0.05)(t) == pytest.approx(
            float(cos(t)), rel=1e-5)
        assert tr.warmup_constant(3e-3, 150)(t) == pytest.approx(
            float(warm(t)), rel=1e-5, abs=0)


@pytest.fixture(scope="module")
def trained_pair():
    """A tiny copy model trained by the port, in both packages."""
    task = tr.CopyTask(vocab_extra=30, n=16)
    jcfg, tcfg = _cfgs(task.vocab_size)
    tm = LlamaForCausalLM(tcfg, device="cpu")
    tree = tr.train_copy(tm, task, steps=260, B=32, lr=3e-3, seed=0)
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    return JModel(jcfg, use_pallas=False), jp, tm, task


@pytest.mark.parametrize("arm", ["dense", "quant4", "h2o"])
def test_copy_accuracy_equals_jax(trained_pair, arm):
    jm, jp, tm, task = trained_pair
    kw_j = kw_t = {"kind": "dense"}
    if arm == "quant4":
        kw_j = {"kind": "quant", "quant_cfg": JQuant(bits=4, gap=16,
                                                     v_group=16)}
        kw_t = {"kind": "quant", "quant_cfg": QuantKVConfig(
            bits=4, gap=16, v_group=16)}
    elif arm == "h2o":
        kw_j = kw_t = {"kind": "h2o", "h2o_budget": 12}
    jtask = jr.CopyTask(vocab_extra=30, n=16)
    want = jr.copy_accuracy(jm, jp, jtask, B=16, n_batches=2, **kw_j)
    got = tr.copy_accuracy(tm, task, B=16, n_batches=2, **kw_t)
    assert got == want
    if arm == "dense":
        assert got > 0.9                     # the model learned the task


def test_retrieval_accuracy_equals_jax(trained_pair):
    """The same probe on the retrieval layout (an untrained task for this
    model: the predictions, not the score, are what must agree)."""
    jm, jp, tm, _ = trained_pair
    jt = jr.RetrievalTask(n_keys=14, n_vals=14, n_pairs=6)
    tt = tr.RetrievalTask(n_keys=14, n_vals=14, n_pairs=6)
    for kw in ({"kind": "dense"}, {"kind": "h2o", "h2o_budget": 10}):
        want = jr.retrieval_accuracy(jm, jp, jt, B=8, n_batches=2, **kw)
        got = tr.retrieval_accuracy(tm, tt, B=8, n_batches=2, **kw)
        assert got == want


def test_kv_accuracy_script_arms_and_checks():
    """The port's script keeps the JAX script's ten arms and five checks."""
    from microscopiq_tpu_torch.scripts import kv_accuracy as ka

    model, task = ka.model_and_task(n=192, device="cpu")
    assert task.vocab_size == 2048 and model.cfg.head_dim == 16
    names = ["dense"] + list(ka.quant_arms(16)) + list(ka.h2o_arms(task))
    assert len(names) == 10
    assert ka.h2o_arms(task) == {"H2O-full": 201, "H2O-75pct": 144,
                                 "H2O-50pct": 96}
    results = {n: {"accuracy": 1.0} for n in names}
    results["KIVI-2bit"]["accuracy"] = 0.87
    assert all(ka.ordering_checks(results).values())
    results["GEARL-2bit-r4"]["accuracy"] = 0.5
    results["GEARSL-2bit"]["accuracy"] = 0.5
    assert not ka.ordering_checks(results)["gear_corrects_2bit"]


def test_kv_accuracy_script_writes_only_to_out(tmp_path, monkeypatch,
                                              capsys):
    """The script's weight cache goes to the temporary directory, its
    result only to --out (a run too short to learn writes none), and it
    refuses to run without --out."""
    import tempfile

    from microscopiq_tpu_torch.scripts import kv_accuracy as ka

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(SystemExit):
        ka.main(["--device", "cpu", "--n", "20", "--steps", "2"])
    assert ka.main(["--train-only", "--device", "cpu", "--n", "20",
                    "--steps", "2"]) == 0
    assert (tmp_path / "copy_params_torch_h8_20_2_cpu.pt").exists()
    out = tmp_path / "sub" / "kv.json"
    (tmp_path / "sub").mkdir()
    assert ka.main(["--out", str(out), "--device", "cpu", "--n", "20",
                    "--steps", "2"]) == 1
    assert "loaded trained params" in capsys.readouterr().out
    assert not out.exists() and not list((tmp_path / "sub").iterdir())
