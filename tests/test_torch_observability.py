"""Port observability (microscopiq_tpu_torch.utils.observability) against
the JAX module; mirrors tests/test_observability.py. The same synthetic
``.trace.json.gz`` goes through JAX's readers and the port's: the results
are equal. The port's own ``trace`` writes a trace both read, and the
readers leave ``trace``'s spin-kernel filler out and refuse a window short
of the caller's launch count."""

import gzip
import json
import os

import pytest
import torch

from microscopiq_tpu.utils import observability as jo
from microscopiq_tpu_torch.utils import observability as to

# the rows torch.profiler gives a card's kernels ("GPU 0") and a host row
EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 0,
     "args": {"name": "GPU 0"}},
    {"ph": "M", "name": "process_name", "pid": 1,
     "args": {"name": "/device:TPU:0"}},
    {"ph": "M", "name": "process_name", "pid": 2,
     "args": {"name": "python3"}},
    {"ph": "X", "pid": 0, "ts": 0, "dur": 100.0,
     "name": "void gemv_tc<1, 0>(Plan)"},
    {"ph": "X", "pid": 0, "ts": 50, "dur": 100.0,
     "name": "void gemv_tc<1, 0>(Plan)"},
    {"ph": "X", "pid": 1, "ts": 300, "dur": 50.0, "name": "fused_gemv.1"},
    {"ph": "X", "pid": 1, "ts": 400, "dur": 70.0, "name": "fused_gemv.2"},
    {"ph": "X", "pid": 2, "ts": 0, "dur": 9999.0, "name": "host_thing"},
    {"ph": "s", "pid": 0, "ts": 10, "name": "ac2g"},
]


def _write(tmp_path, events, sub=("plugins", "profile", "run1")):
    d = tmp_path.joinpath(*sub)
    os.makedirs(d)
    with gzip.open(d / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def test_metrics_counters_gauges_timers_and_dump(tmp_path):
    m = to.Metrics()
    m.count("tokens", 5)
    m.count("tokens", 3)
    m.gauge("queue", 2)
    for _ in range(2):
        with m.timer("step"):
            pass
    snap = m.snapshot()
    assert snap["counters"]["tokens"] == 8 and snap["gauges"]["queue"] == 2
    assert snap["timers"]["step"]["n"] == 2
    rec = m.dump(str(tmp_path / "m" / "metrics.jsonl"), run="r1")
    assert rec["run"] == "r1"
    m.dump(str(tmp_path / "m" / "metrics.jsonl"), run="r2")
    lines = (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["run"] for x in lines] == ["r1", "r2"]
    assert json.loads(lines[0])["counters"]["tokens"] == 8


@pytest.mark.parametrize("device_only", [True, False])
def test_readers_equal_jax_on_one_trace(tmp_path, device_only):
    d = _write(tmp_path, EVENTS)
    got = to.device_kernel_stats(d, device_only=device_only)
    assert got == jo.device_kernel_stats(d, device_only=device_only)
    assert to.device_busy_us(d) == jo.device_busy_us(d) == 270.0
    assert set(got) >= {"void gemv_tc<1, 0>(Plan)", "fused_gemv"}
    assert ("host_thing" in got) != device_only
    assert got["fused_gemv"] == {"count": 2, "total_us": 120.0,
                                 "mean_us": 60.0}


def test_filler_is_dropped_and_short_windows_raise(tmp_path):
    spin = lambda ts: {"ph": "X", "pid": 0, "ts": ts, "dur": 1.0,
                       "name": "void at::cuda::spin_kernel(long)"}
    d = _write(tmp_path, [spin(-5), spin(-3)] + EVENTS + [spin(900)])
    stats = to.device_kernel_stats(d)
    assert not any("spin_kernel" in k for k in stats)
    assert to.device_busy_us(d) == 270.0
    assert to.filler_kept(d) == (2, 1)
    assert to.device_kernel_stats(d, min_events=4)
    with pytest.raises(AssertionError, match="holds 4 events.*launched 5"):
        to.device_kernel_stats(d, min_events=5)


def test_bandwidth_and_decode_token_stats():
    assert to.achieved_bandwidth(380e9, 1.0) == pytest.approx(380.0)
    to.assert_bandwidth(200e9, 1.0, target_gbps=380, fraction=0.5)
    with pytest.raises(AssertionError):
        to.assert_bandwidth(100e9, 1.0, target_gbps=380, fraction=0.5)
    # the default target is the H100's HBM rate
    to.assert_bandwidth(2e12, 1.0)
    with pytest.raises(AssertionError, match="3350 GB/s"):
        to.assert_bandwidth(1e12, 1.0)
    steps = [0.01, 0.02, 0.03, 0.05]
    assert to.decode_token_stats(steps, 8) == jo.decode_token_stats(steps, 8)
    assert to.decode_token_stats(steps[:3], 8)["tokens_per_s"] == \
        pytest.approx(400.0)


def test_trace_writes_a_trace_both_readers_parse(tmp_path):
    out = str(tmp_path / "tr")
    with to.trace(out) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == out
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".trace.json.gz")
    got = to.device_kernel_stats(out, device_only=False)
    assert any("mm" in k for k in got)
    assert got == jo.device_kernel_stats(out, device_only=False)
    # no card here: no device rows
    assert to.device_kernel_stats(out) == {} and to.device_busy_us(out) == 0
