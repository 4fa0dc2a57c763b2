"""Worker process of tests/test_torch_distributed.py (one per rank).

Joins a gloo group, builds the hybrid (data, model) mesh, takes rank 0's
weight everywhere, stitches each rank's half of the batch into the global
batch, runs a column-parallel linear over a (1, 2) mesh and checks the
math against a local replay. Prints one JSON line.

Run: python tests/torch_dist_worker.py PORT RANK
"""

import json
import sys

import numpy as np
import torch


def main():
    port, proc = sys.argv[1], int(sys.argv[2])
    from microscopiq_tpu_torch.parallel import (
        all_gather, broadcast_from_primary, global_batch, init_distributed,
        is_primary, make_hybrid_mesh, make_mesh, process_chunk, replicate,
        sync)

    idx, count = init_distributed(f"localhost:{port}", num_processes=2,
                                  process_id=proc, backend="gloo")
    assert (idx, count) == (proc, 2), (idx, count)
    assert init_distributed() == (proc, 2)          # idempotent

    mesh = make_hybrid_mesh()                        # (data=2, model=1)
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.coords() == {"data": proc, "model": 0}
    dm = mesh.device_mesh("cpu")                     # the same grid
    assert dm.mesh_dim_names == ("data", "model")
    assert dm.mesh.tolist() == [[0], [1]]

    # rank 0's weight everywhere (the checkpoint-load pattern)
    rng = np.random.default_rng(0 if proc == 0 else 99)
    W_host = broadcast_from_primary(rng.normal(size=(8, 16)).astype(
        np.float32))
    W = replicate(torch.from_numpy(rng.normal(size=(8, 16)).astype(
        np.float32)), mesh)
    W0 = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    np.testing.assert_array_equal(W_host, W0)
    assert W.shape == (8, 16)

    # each rank contributes its half of the global batch
    xs_all = np.arange(4 * 8, dtype=np.float32).reshape(4, 8) / 10.0
    x = global_batch(torch.from_numpy(xs_all[proc * 2:(proc + 1) * 2]), mesh)
    np.testing.assert_array_equal(x.numpy(), xs_all)

    # a column-parallel linear over the model axis of a (1, 2) mesh
    tp = make_mesh(2, data=1, model=2)
    r = tp.coords()["model"]
    Wt = torch.from_numpy(W_host)
    y_local = x @ Wt[:, r * 8:(r + 1) * 8]
    y = all_gather(y_local, tp.group("model"), dim=-1)
    want = xs_all @ W_host
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
    loss = float((y * y).sum())
    np.testing.assert_allclose(loss, float((want ** 2).sum()), rtol=1e-5)

    chunk = process_chunk(list(range(10)))
    sync("done")
    print(json.dumps({"proc": proc, "primary": is_primary(), "loss": loss,
                      "chunk": chunk}), flush=True)


if __name__ == "__main__":
    main()
