"""``chip_smoke.kernel_split_ms`` on the CPU, with stand-in profiler
windows: a window must hold at least as many kernel events as the
wrappers' launch counts rose by over its calls, and a multiple of its
calls; a short window is taken again over half the calls, and a second
short one raises naming the phase and both counts. ``device_ms`` takes its
windows through the same check."""

import pytest

import chip_smoke as cs
from microscopiq_tpu_torch.ops.cuda import mx_quant as mq


def _call(i):
    """A stand-in for a wrapper call: one counted launch."""
    mq.launch_counts["quantize_mx"] += 1


def _window(per_call, lost=0):
    """A window that runs its calls and records ``per_call`` kernel events
    a call, ``lost`` of them dropped; returns the window and its log."""
    taken = []

    def window(fn, n_args, n):
        taken.append(n)
        for i in range(n):
            fn(i % n_args)
        events = [(f"k{j}", 2.0 * n, n) for j in range(per_call)]
        name, us, count = events[-1]
        events[-1] = (name, us, count - lost)
        return [e for e in events if e[2] > 0]

    return window, taken


def test_short_window_is_retaken_then_raises():
    mq.reset_launch_counts()
    window, taken = _window(1, lost=1)
    with pytest.raises(AssertionError,
                       match=r"phase_x: .*7 kernel events over 8 calls .*"
                             r"counted 8"):
        cs.kernel_split_ms(_call, 2, calls=16, phase="phase_x",
                           window=window, sync=lambda: None)
    assert taken == [16, 8]


def test_window_with_events_dropped_beyond_the_counts_is_short():
    """Three kernels a call where the wrapper counts one (the W8A8 call):
    a window that dropped one event still holds more events than counted
    launches, but no multiple of its calls."""
    mq.reset_launch_counts()
    window, taken = _window(3, lost=1)
    with pytest.raises(AssertionError, match="twice short"):
        cs.kernel_split_ms(_call, 1, calls=16, window=window,
                           sync=lambda: None)
    assert taken == [16, 8]


def test_whole_window_gives_ms_by_kernel_and_launches_a_call():
    mq.reset_launch_counts()
    window, taken = _window(3)
    ms, per_call = cs.kernel_split_ms(_call, 1, calls=16, window=window,
                                      sync=lambda: None)
    assert taken == [16]
    assert per_call == 3.0
    assert ms == {"k0": 0.002, "k1": 0.002, "k2": 0.002}


def test_short_then_whole_window_takes_the_second():
    mq.reset_launch_counts()
    full, _ = _window(2)
    short, _ = _window(2, lost=3)
    taken = []

    def window(fn, n_args, n):
        taken.append(n)
        return (short if len(taken) == 1 else full)(fn, n_args, n)

    ms, per_call = cs.kernel_split_ms(_call, 1, calls=16, window=window,
                                      sync=lambda: None)
    assert taken == [16, 8] and per_call == 2.0 and set(ms) == {"k0", "k1"}


def test_device_ms_sums_a_whole_window(monkeypatch):
    import torch

    mq.reset_launch_counts()
    window, taken = _window(2)
    monkeypatch.setattr(cs, "profile_window", window)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    assert cs.device_ms(_call, 1, calls=16) == pytest.approx(0.004)
    assert taken == [16]


def test_device_ms_raises_on_a_short_window(monkeypatch):
    """The plain versions count no launches: a window that lost one of
    their events holds no multiple of its calls."""
    import torch

    window, taken = _window(2, lost=1)
    monkeypatch.setattr(cs, "profile_window", window)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with pytest.raises(AssertionError, match="plain_x: .*twice short"):
        cs.device_ms(lambda i: None, 1, calls=16, phase="plain_x")
    assert taken == [16, 8]


def _route_row(kernel, kind, block, M, any_block=False, **extra):
    return {**dict(kernel=kernel, kind=kind, format="f", block=block,
                   budget=0, M=M, any=any_block, max_abs_err=1e-3,
                   rel_err=1e-7, ms=0.7, bound_ms=0.24, bound_by="operations",
                   plain_ms=8.0, library_ms=0.3), **extra}


def test_block_route_records_name_the_run_time_block_kernels():
    """The kernels line's block-route records: one a gemm_any.cu kernel
    (ANY_KERNELS), timed at its first run-time-block row and listing only
    those rows, and one a gemv_any.cu GEMV decode (W8A8, then bf16 x), each
    with the contract's keys, its launches from ``by_path`` and the
    decode's block-16 yardstick; the records of the kernels compiled per
    block list none of gemm_any.cu's rows."""
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    rows = []
    for kind, (name, _) in cs.ANY_KERNELS.items():
        counter = ("dequant_gemm_outlier" if kind == "sideband"
                   else f"dequant_matmul_{kind}")
        rows += [_route_row(counter, kind, 64, cs.SM90_M),
                 _route_row(counter, kind, 48, cs.SM90_M, True)]
    rows += [_route_row(f"dequant_gemv_{d}_any", d, 8, 8)
             for d in cs.GEMV_ANY_DECODES]
    rows += [_route_row(f"dequant_gemv_s8_{d}_any", d, 4, 8)
             for d in cs.S8_ANY_DECODES]
    # the block-16 yardsticks: timed, not in the entry point's run
    yards = [_route_row(f"dequant_gemv_{d}", d, 16, 8, ms=0.1,
                        yardstick=True) for d in cs.GEMV_ANY_DECODES]
    yards += [_route_row(f"dequant_gemv_s8_{d}", d, 16, 8, ms=0.05,
                         yardstick=True) for d in cs.S8_ANY_DECODES]
    # the main paths count what the wrappers' launch_counts hold;
    # gemm_any.cu's names only the block routes' entry point counts, as
    # by_route_kernel gives them its rows' launches
    zero = {k: 0 for k in cs.launches()}
    paths = {"mxfp6": {"prefill": dict(zero), "decode": dict(zero)}}
    counts = {}
    for r in rows:
        counts[r["kernel"]] = counts.get(r["kernel"], 0) + 1
    flat = {"block_routes": cs.by_route_kernel(rows, counts)}
    recs = cs.block_route_records(
        rows + yards, lambda n: cs.launches_by_path(paths, flat, n))
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    assert [r["name"] for r in recs] == (
        [n for n, _ in cs.ANY_KERNELS.values()]
        + [f"dequant_gemv_s8_{d}_any" for d in cs.S8_ANY_DECODES]
        + [f"dequant_gemv_{d}_any" for d in cs.GEMV_ANY_DECODES])
    for r in recs:
        assert keys <= set(r) and r["launches"] == 1, r["name"]
    for r in recs[len(cs.ANY_KERNELS):]:
        assert r["source"].endswith("csrc/gemv_any.cu")
        assert r["yardstick_ms"] == (0.05 if "_s8_" in r["name"] else 0.1)
        assert r["replaces"].endswith(
            ":267" if "_s8_" in r["name"] else
            ":80" if "_fp8_" in r["name"] else ":162")
    for r in recs[:len(cs.ANY_KERNELS)]:
        assert r["source"].endswith("csrc/gemm_any.cu")
        assert [b[1] for b in r["blocks"]] == [48]
    assert [b[1] for b in cs._route_rows(rows, "dequant_matmul_emi8")] \
        == [64]
    assert set(cs.ANY_KERNELS) - {"sideband"} == set(dm._DECODES)


def test_by_route_kernel_gives_run_time_block_launches_their_kernel():
    """The block-route entry point's counts: a row on gemm_any.cu's kernel
    (``any``) moves its one launch from the wrapper's counter to its
    ANY_KERNELS name; the other rows keep theirs, and nothing is lost."""
    rows = [_route_row("dequant_matmul_emi8", "emi8", 64, cs.SM90_M),
            _route_row("dequant_matmul_emi8", "emi8", 48, cs.SM90_M, True),
            _route_row("dequant_matmul_emi8", "emi8", 128, cs.SM90_M, True),
            _route_row("dequant_gemm_outlier", "sideband", 8, cs.SM90_M,
                       True),
            _route_row("dequant_gemv_emi8_any", "emi8", 8, 8)]
    counts = {"dequant_matmul_emi8": 3, "dequant_gemm_outlier": 1,
              "dequant_gemv_emi8_any": 1}
    got = cs.by_route_kernel(rows, counts)
    assert got == {"dequant_matmul_emi8": 1, "gemm_any_sm90_emi8": 2,
                   "sideband_any_sm90": 1, "dequant_gemv_emi8_any": 1}
    assert sum(got.values()) == sum(counts.values())
    assert counts["dequant_matmul_emi8"] == 3


def test_block_routes_take_every_formerly_refused_w8a8_block():
    """The W8A8 cases of ``route_phase`` (ROUTE_CASES' blocks no multiple of
    16, S8_EXTRA_CASES) hold the blocks the card refused before gemv_any.cu
    (int8 at 2, sb4 at 2 and 4, sb2 at 4 and 8), each on gemv_s8_any; the
    GEMV cases each decode of GEMV_ANY_DECODES on gemv_any, and the
    yardstick block is on the tensor-core GEMVs."""
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    s8 = {(k, b) for k, _, b, _ in cs.ROUTE_CASES + cs.S8_EXTRA_CASES
          if k in cs.S8_ANY_DECODES and dm.s8_route(k, b) == "any"}
    assert {("native", 2), ("sb4", 2), ("sb4", 4), ("sb2", 4),
            ("sb2", 8)} <= s8
    assert {k for k, _ in s8} == set(cs.S8_ANY_DECODES)
    gemv = {k for k, _, b, _ in cs.ROUTE_CASES
            if k != "sideband" and dm.gemv_route(k, b) == "any"}
    assert gemv == set(cs.GEMV_ANY_DECODES)
    for k in cs.GEMV_ANY_DECODES:
        assert dm.gemv_route(k, cs.YARDSTICK_BLOCK) == "tc"
        if k in cs.S8_ANY_DECODES:
            assert dm.s8_route(k, cs.YARDSTICK_BLOCK) == "tc"


def test_gemv_route_times_cases():
    """--gemv-route-times: every block-route GEMV on gemv_any.cu (the blocks
    no multiple of 16, the 16-bit containers at 256) and each decode's
    block-16 yardstick on gemv_tc, each case once."""
    from microscopiq_tpu_torch.ops.cuda import dequant_matmul as dm

    cases = cs.GEMV_ROUTE_TIME_CASES
    assert len(set(cases)) == len(cases)
    routes = {(k, b): dm.gemv_route(k, b) for k, _, b in cases}
    assert {k for (k, b), r in routes.items() if r == "tc"} == \
        set(cs.GEMV_ANY_DECODES)
    assert all(r == "any" for (k, b), r in routes.items()
               if b != cs.YARDSTICK_BLOCK)
    assert {("bf16", 256), ("fp16", 256), ("native", 2),
            ("emi8", 8)} <= set(routes)
    assert cs.GEMV_ROUTE_TIME_M == (1, 8, 64)
