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
