"""Worker process of tests/test_torch_parallel.py (one per rank).

Joins a gloo process group, then for each case of the input file (a
weight tree of the whole model, its config, the mesh shape and the
prompt) keeps this rank's shards (``shard_params``), builds the rank's
tensor-parallel Llama on the CPU, and runs the forward (and, where the case
asks, greedy decodes over the dense and the quantized cache) with the
batch split over the mesh's ``data`` axis; outputs are stitched back with
``global_batch``. Writes the results of rank ``rank`` with torch.save and
prints one JSON line.

Run: python tests/torch_tp_worker.py PORT RANK WORLD INPUT OUTPUT
"""

import json
import sys

import torch


def main():
    port, rank, world, inp, out = sys.argv[1:6]
    torch.set_num_threads(1)
    from microscopiq_tpu_torch.eval.generate import generate
    from microscopiq_tpu_torch.kv.cache import QuantKVConfig
    from microscopiq_tpu_torch.models import LlamaForCausalLM
    from microscopiq_tpu_torch.parallel import (Mesh, global_batch,
                                                init_distributed, is_primary,
                                                shard_params, sync)

    r, n = init_distributed(f"localhost:{port}", int(world), int(rank),
                            backend="gloo")
    assert (r, n) == (int(rank), int(world)), (r, n)
    cases = torch.load(inp, weights_only=False)
    res = {}
    for name, case in cases.items():
        mesh = Mesh(*case["mesh"])
        local = shard_params(case["tree"], mesh, cfg=case["cfg"])
        model = LlamaForCausalLM(case["cfg"], device="cpu",
                                 tp_group=mesh.group("model")
                                 ).load_params(local)
        ids = case["ids"]
        d, nd = mesh.coords()["data"], mesh.shape["data"]
        rows = ids.shape[0] // nd
        mine = ids[d * rows:(d + 1) * rows]
        got = {}
        with torch.inference_mode():
            got["logits"] = global_batch(model(torch.as_tensor(mine)), mesh)
        if case.get("decode"):
            got["tokens"] = global_batch(generate(model, mine, 4), mesh)
        if case.get("quant"):
            got["quant_tokens"] = global_batch(generate(
                model, mine, 4, cache_kind="quant",
                quant_cfg=QuantKVConfig(bits=4, gap=8)), mesh)
        got["kv_heads"] = model.kv_heads
        res[name] = got
    sync("done")
    torch.save(res, out)
    print(json.dumps({"rank": r, "primary": is_primary(),
                      "cases": sorted(res)}), flush=True)


if __name__ == "__main__":
    main()
