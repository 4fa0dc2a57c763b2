"""GSM8K-CoT generation evaluation.

Own copy of ``microscopiq_tpu/eval/gsm8k.py``: chain-of-thought prompting,
regex numeric answer extraction, accuracy, and json/jsonl outputs, over any
``generate_fn`` (prompts -> continuations); :func:`engine_generate_fn`
builds one over the port's ``BatchEngine``.

Offline data: a local GSM8K jsonl (``gsm8k.jsonl`` of {"question",
"answer"} rows in ``eval/data.py::data_dir()``, read when the eval runs)
or the built-in synthetic arithmetic set (pipeline testing only), whose
rows equal the JAX package's.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, List, Optional

import numpy as np

from .data import data_dir

ANS_RE = re.compile(r"#### (\-?[0-9\.\,]+)")
INVALID_ANS = "[invalid]"

COT_PROMPT = (
    "Question: Tom has 3 apples and buys 5 more. How many apples does he "
    "have?\nLet's think step by step. Tom starts with 3 apples. He buys 5 "
    "more, so 3 + 5 = 8. The answer is 8.\n\n"
)


def extract_answer_gt(completion: str) -> str:
    """Ground-truth '#### N' extraction (evaluation_gsm8k.py:63-74)."""
    m = ANS_RE.search(completion)
    if m:
        return m.group(1).strip().replace(",", "")
    return INVALID_ANS


def extract_answer_pred(text: str) -> str:
    """Prediction extraction: last number in the generation
    (evaluation_gsm8k.py:76-97)."""
    text = text.replace(",", "")
    nums = re.findall(r"-?\d+(?:\.\d+)?", text)
    return nums[-1] if nums else INVALID_ANS


def is_correct(pred: str, gt: str) -> bool:
    if pred == INVALID_ANS or gt == INVALID_ANS:
        return False
    try:
        return abs(float(pred) - float(gt)) < 1e-4
    except ValueError:
        return False


def load_gsm8k(limit: Optional[int] = None) -> List[dict]:
    path = os.path.join(data_dir(), "gsm8k.jsonl")
    if os.path.isfile(path):
        rows = [json.loads(line) for line in open(path)]
        return rows[:limit] if limit else rows
    # synthetic arithmetic problems (offline pipeline testing)
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(limit or 64):
        a, b = int(rng.integers(2, 60)), int(rng.integers(2, 60))
        rows.append({
            "question": f"Tom has {a} apples and buys {b} more. How many "
                        f"apples does he have?",
            "answer": f"Tom starts with {a}. He buys {b} more, so "
                      f"{a} + {b} = {a + b}. #### {a + b}",
        })
    return rows


def evaluate_gsm8k(generate_fn: Callable[[List[str]], List[str]],
                   limit: int = 64, batch_size: int = 8,
                   prompt: str = COT_PROMPT,
                   output_dir: Optional[str] = None) -> dict:
    """Run the CoT eval. generate_fn: list of prompt strings -> list of
    generated continuation strings."""
    rows = load_gsm8k(limit)
    n_correct = 0
    records = []
    t0 = time.time()
    for b0 in range(0, len(rows), batch_size):
        batch = rows[b0:b0 + batch_size]
        prompts = [prompt + "Question: " + r["question"] +
                   "\nLet's think step by step." for r in batch]
        outs = generate_fn(prompts)
        for r, out in zip(batch, outs):
            gt = extract_answer_gt(r["answer"])
            pred = extract_answer_pred(out)
            ok = is_correct(pred, gt)
            n_correct += ok
            records.append({"question": r["question"], "generation": out,
                            "pred": pred, "gt": gt, "correct": bool(ok)})
    acc = n_correct / len(rows)
    result = {"accuracy": acc, "n": len(rows),
              "seconds": time.time() - t0}
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "evaluation_gsm8k.json"),
                  "w") as f:
            json.dump(result, f, indent=2)
        with open(os.path.join(output_dir, "generations.jsonl"), "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return result


def engine_generate_fn(engine, tokenizer, max_new_tokens: int = 256,
                       eos_id: int = -1):
    """Build a generate_fn backed by the continuous-batching engine.

    Handles ragged prompt lengths natively (each prompt gets its own
    slot/bucket), unlike the equal-length-batch decode loop
    (eval/generate.py) — the throughput path for CoT evals where prompt
    lengths vary by hundreds of tokens.
    """

    def fn(prompts):
        ids = [np.asarray(tokenizer.encode(p), np.int32) for p in prompts]
        outs = engine.generate(ids, max_new_tokens=max_new_tokens,
                               eos_id=eos_id)
        return [tokenizer.decode(t) for t in outs]

    return fn
