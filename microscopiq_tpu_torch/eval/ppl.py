"""Perplexity over a token stream.

Counterpart of ``microscopiq_tpu/eval/ppl.py``: the test stream is cut into
``seqlen`` windows, each window goes through the model, and
``ppl = exp(sum of the shifted cross-entropy / (windows * (seqlen - 1)))``,
counting the tokens each window predicts (the reference divides by
``windows * seqlen``). The model is a callable ``ids -> logits (B, S, V)``
(the JAX function takes ``apply_fn(params, ids)``).
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def perplexity(model, test_ids: np.ndarray, seqlen: int = 2048,
               batch: int = 1, verbose: bool = False) -> float:
    """Perplexity of ``model`` (on ``model.device``) on ``test_ids``."""
    test_ids = np.asarray(test_ids)
    nsamples = len(test_ids) // seqlen
    if nsamples == 0:
        raise ValueError(f"test stream shorter than seqlen={seqlen}")
    dev = model.device
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for b0 in range(0, nsamples, batch):
        nb = min(batch, nsamples - b0)
        ids = torch.as_tensor(np.stack(
            [test_ids[(b0 + j) * seqlen:(b0 + j + 1) * seqlen]
             for j in range(nb)]).astype(np.int64), device=dev)
        logits = model(ids)
        logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, ids[:, 1:, None])[..., 0]
        total += nll.sum(dtype=torch.float32).to(torch.float64)
        if verbose:
            done = (b0 + nb) * (seqlen - 1)
            print(f"  {b0 + nb}/{nsamples} windows, running ppl "
                  f"{np.exp(float(total) / done):.4f}")
    return float(np.exp(float(total) / (nsamples * (seqlen - 1))))


def main(argv=None):
    """``python -m microscopiq_tpu_torch.eval.ppl --model tiny-opt``: the
    CLI driver (``cli/llm_cli.py``) with the model given as ``--model X``
    or positionally; ``opt-tiny``/``llama-tiny`` name ``tiny-*``."""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if "--model" in args:
        i = args.index("--model")
        args = args[:i] + args[i + 1:i + 2] + args[i + 2:]
    alias = {"opt-tiny": "tiny-opt", "llama-tiny": "tiny-llama"}
    args = [alias.get(a, a) for a in args]

    from ..cli.llm_cli import main as cli_main

    return cli_main(args)


if __name__ == "__main__":
    main()
