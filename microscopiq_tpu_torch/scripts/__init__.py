"""Experiment scripts of the port, each the counterpart of the script of the
same name under the repository's ``scripts/``:

    python -m microscopiq_tpu_torch.scripts.exp_prefill_floor [--out PATH]
    python -m microscopiq_tpu_torch.scripts.exp_prefill_tiles2
    python -m microscopiq_tpu_torch.scripts.exp_prefill_overlap
    python -m microscopiq_tpu_torch.scripts.exp_prefill_pipe

Each runs on the CUDA card (raising without one unless ``main`` is given
``device="cpu"``, where it runs the plain versions and times nothing) and
prints one JSON line per arm. ``_prefill`` holds their shared setup, timing
and record.
"""
