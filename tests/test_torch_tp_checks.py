"""The checks of ``chip_smoke.tp_main_path`` on the CPU: the token
divergences of a teacher-forced run, the linears' summary, the cut of a
weight tree to its first layers, the M = 1 rows of the GEMV phases, and
that the linears' bounds tell float32 row-parallel partial sums from a
bfloat16 all-reduce on a float64 model of both sums."""

import numpy as np
import pytest
import torch

import chip_smoke as cs


def test_divergences_lists_every_differing_token_with_its_gap():
    want = np.array([[3, 1, 2], [0, 0, 0]])
    got = np.array([[3, 2, 2], [1, 0, 2]])
    ref = [torch.zeros(2, 4) for _ in range(3)]
    ref[1][0] = torch.tensor([0.0, 10.0, 9.5, 0.0])     # row 0, step 1
    ref[0][1] = torch.tensor([8.0, 4.0, 0.0, 0.0])      # row 1, step 0
    ref[2][1] = torch.tensor([5.0, 0.0, 5.0, 0.0])      # row 1, step 2: tie
    share, div = cs._divergences(got, want, ref)
    assert share == pytest.approx(3 / 6)
    assert [(d["row"], d["step"]) for d in div] == [(0, 1), (1, 0), (1, 2)]
    assert [d["gap"] for d in div] == pytest.approx([0.05, 0.5, 0.0])


def test_linear_summary_groups_by_kind_and_phase():
    checks = {"model.layers.0.self_attn.o_proj|prefill": (1e-3, 1e-4),
              "model.layers.1.self_attn.o_proj|prefill": (2e-3, 0.0),
              "model.layers.0.self_attn.o_proj|decode": (0.0, 0.0),
              "lm_head|decode": (0.0, 0.0)}
    s = cs._linear_summary(checks)
    assert s["o_proj|prefill"] == dict(rel_err_max=2e-3,
                                       differ_share_max=1e-4, linears=2,
                                       bit_equal=1)
    assert s["o_proj|decode"]["bit_equal"] == 1
    assert s["lm_head|decode"]["linears"] == 1


def test_first_layers_keeps_the_first_n_and_the_same_leaves():
    leaf = torch.zeros(2)
    tree = {"model": {"embed_tokens": leaf, "norm": {"scale": leaf},
                      **{f"layers_{i}": {"w": torch.full((1,), i)}
                         for i in range(12)}},
            "lm_head": {"kernel": leaf}}
    cut = cs.first_layers(tree, 2)
    assert sorted(cut["model"]) == ["embed_tokens", "layers_0", "layers_1",
                                    "norm"]
    assert cut["model"]["layers_1"] is tree["model"]["layers_1"]
    assert cut["lm_head"] is tree["lm_head"] and len(tree["model"]) == 14


def test_m1_rows_at_one_shape_a_kernel():
    assert cs.with_m1(cs.M1_LINEAR, cs.S8_M) == (1,) + cs.S8_M
    assert cs.with_m1("qkv", cs.S8_M) == cs.S8_M
    assert cs.M1_LINEAR in [lin for lin, _, _ in cs.SHAPES]


@pytest.mark.parametrize("K", [4096, 14336])
def test_linear_bounds_tell_f32_partials_from_a_bf16_all_reduce(K):
    g = torch.Generator().manual_seed(K)
    x = torch.randn(64, K, generator=g).bfloat16().double()
    w = (torch.randn(K, 512, generator=g) * 0.02).bfloat16().double()
    h = K // 2
    parts = [(x[:, s].float() @ w[s].float())
             for s in (slice(0, h), slice(h, K))]
    one = (x.float() @ w.float()).bfloat16()

    def judged(y):
        rel = float((y.float() - one.float()).abs().max()
                    / one.float().abs().max())
        share = float((y != one).float().mean())
        return (rel <= cs.TP_LINEAR_REL_TOL
                and share <= cs.TP_LINEAR_DIFFER_MAX)

    assert judged((parts[0] + parts[1]).bfloat16())
    assert not judged((parts[0].bfloat16().float()
                       + parts[1].bfloat16().float()).bfloat16())
