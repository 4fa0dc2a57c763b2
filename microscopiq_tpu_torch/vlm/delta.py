"""Delta-checkpoint CLI. LLaVA ships its weights as deltas over a base
LM; these commands reproduce the reference's utilities on this repo's
checkpoint directories (``utils/checkpoint.py``: npz + JSON trees, the
format the JAX package writes and reads):

  python -m microscopiq_tpu_torch.vlm.delta apply --base B --delta D --target T
      [--device cpu]
      target = base + delta (``vlm/llava/model/apply_delta.py:1-48``):
      delta-only keys (mm_projector, vision tower) pass through; grown
      embed_tokens/lm_head rows add base into the leading slab.
  python -m microscopiq_tpu_torch.vlm.delta make --base B --target T --delta D
      delta = target - base (``make_delta.py``).
  python -m microscopiq_tpu_torch.vlm.delta consolidate --src S --dst D
      load + move every tensor to host memory + save (``consolidate.py``).

Counterpart of ``microscopiq_tpu/vlm/delta.py``. Checkpoints load onto
``--device`` (default ``cuda``, which must exist; ``--device cpu`` for a
machine without a card) before the arithmetic; what is saved is moved to
host memory first.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_apply = sub.add_parser("apply")
    p_apply.add_argument("--base", required=True)
    p_apply.add_argument("--delta", required=True)
    p_apply.add_argument("--target", required=True)
    p_make = sub.add_parser("make")
    p_make.add_argument("--base", required=True)
    p_make.add_argument("--target", required=True)
    p_make.add_argument("--delta", required=True)
    p_con = sub.add_parser("consolidate")
    p_con.add_argument("--src", required=True)
    p_con.add_argument("--dst", required=True)
    for p in (p_apply, p_make, p_con):
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.checkpoint import (apply_delta, consolidate,
                                    load_checkpoint, make_delta,
                                    save_checkpoint)

    def load(path):
        return load_checkpoint(path, device=args.device)

    if args.cmd == "apply":
        save_checkpoint(args.target, consolidate(apply_delta(
            load(args.base), load(args.delta))))
        print(f"wrote {args.target}")
    elif args.cmd == "make":
        save_checkpoint(args.delta, consolidate(make_delta(
            load(args.base), load(args.target))))
        print(f"wrote {args.delta}")
    else:
        save_checkpoint(args.dst, consolidate(load(args.src)))
        print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
