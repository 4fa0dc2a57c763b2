"""Experiment scripts of the port, each the counterpart of the script of the
same name under the repository's ``scripts/``:

    python -m microscopiq_tpu_torch.scripts.exp_prefill_floor [--out PATH]
    python -m microscopiq_tpu_torch.scripts.exp_prefill_tiles2
    python -m microscopiq_tpu_torch.scripts.exp_prefill_overlap
    python -m microscopiq_tpu_torch.scripts.exp_prefill_pipe
    python -m microscopiq_tpu_torch.scripts.exp_decode_variants
    python -m microscopiq_tpu_torch.scripts.exp_sad_tiles
    python -m microscopiq_tpu_torch.scripts.exp_nb_variants
    python -m microscopiq_tpu_torch.scripts.shipped_digests
    python -m microscopiq_tpu_torch.scripts.kv_accuracy --out PATH

Each runs on the CUDA card (raising without one unless ``main`` is given
``device="cpu"``, where it runs the plain versions and times nothing) and
prints one JSON line per arm; ``shipped_digests``, which has no TPU
counterpart, prints the shipped GEMV's and GEMM's output digests, to compare
two builds; ``kv_accuracy`` trains the copy probe and prints the copy
accuracy of ten KV-cache arms (``--device cpu`` on the CPU). ``_prefill``
holds their shared setup, timing and record; ``_gemv`` the setups of the
decode-GEMV scripts.
"""
