"""The port's multi-process runtime (microscopiq_tpu_torch.parallel.
distributed) on torch.distributed, the counterparts of
tests/test_distributed.py: every helper a no-op in one process, and two
real gloo processes (tests/torch_dist_worker.py) joined at a tcp address:
the hybrid mesh, rank 0's weight everywhere, the global batch, a
column-parallel linear checked against a local replay, the work-list split
and a barrier."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from microscopiq_tpu_torch.parallel import distributed as dd
from microscopiq_tpu_torch.parallel import make_mesh


def test_single_process_degenerate():
    idx, count = dd.init_distributed()
    assert (idx, count) == (0, 1)
    assert dd.is_primary()
    dd.sync()

    mesh = dd.make_hybrid_mesh(ici_model=4, dcn_data=2, n_devices=8)
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.ranks.shape == (2, 4) and mesh.axis_names == ("data",
                                                               "model")
    assert mesh.coords(6) == {"data": 1, "model": 2}
    assert mesh.group("model") is None             # no process group

    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    np.testing.assert_array_equal(dd.global_batch(x, mesh), x)
    t = torch.from_numpy(x)
    assert torch.equal(dd.global_batch({"w": t}, mesh)["w"], t)
    assert torch.equal(dd.replicate({"w": t}, mesh)["w"], t)
    assert dd.broadcast_from_primary({"a": 1}) == {"a": 1}
    assert dd.process_chunk(list(range(10))) == list(range(10))
    assert dd.process_chunk(list(range(10)), 1, 2) == [5, 6, 7, 8, 9]
    assert dd.get_chunk(list(range(7)), 3, 2) == [6]
    assert torch.equal(dd.all_reduce(t.clone(), None), t)
    with pytest.raises(ValueError):
        dd.make_hybrid_mesh(ici_model=3, dcn_data=2, n_devices=8)
    with pytest.raises(ValueError):
        make_mesh(8, data=3)


def test_unknown_backend_raises():
    with pytest.raises(RuntimeError, match="not available"):
        dd.init_distributed("localhost:1", 2, 0, backend="no-such")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo():
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=root)
             for i in range(2)]
    outs = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"proc {i} failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0]["primary"] and not outs[1]["primary"]
    assert outs[0]["loss"] == pytest.approx(outs[1]["loss"])
    assert outs[0]["chunk"] + outs[1]["chunk"] == list(range(10))
