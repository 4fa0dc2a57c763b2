"""CoT generation evaluators: BBH, MMLU(-CoT), AQuA.

Own copy of ``microscopiq_tpu/eval/cot_tasks.py``, with the shape of the
GSM8K harness: CoT prompt -> generate -> regex answer extraction ->
accuracy + json outputs.

Offline data: ``{bbh,mmlu,aqua}.jsonl`` rows of {"question", "answer"} in
``eval/data.py::data_dir()``, read when the eval runs (BBH/MMLU answers
are option letters or short strings; AQuA answers are option letters
A-E). Built-in synthetic rows, equal to the JAX package's, keep the
pipeline testable with no network.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, List, Optional

from .data import data_dir

# "the answer is (X)" patterns used by BBH/MMLU/AQuA CoT protocols
_CHOICE_RE = re.compile(
    r"(?:answer is|answer:)\s*\(?([A-Ea-e])\)?", re.IGNORECASE)
_FREEFORM_RE = re.compile(
    r"(?:answer is|answer:)\s*\(?([^\n\.()]+?)\)?\s*(?:\.|$)",
    re.IGNORECASE | re.MULTILINE)

BBH_PROMPT = (
    "Question: Is the following sentence plausible? \"The turtle outran "
    "the rabbit.\" Options: (A) yes (B) no\nLet's think step by step. "
    "Turtles are much slower than rabbits, so it is not plausible. The "
    "answer is (B).\n\n"
)
MMLU_PROMPT = (
    "Question: What is 2 + 2? Options: (A) 3 (B) 4 (C) 5 (D) 6\n"
    "Let's think step by step. Adding 2 and 2 gives 4, which is option "
    "B. The answer is (B).\n\n"
)
AQUA_PROMPT = (
    "Question: A train travels 60 km in 1 hour. How far in 3 hours? "
    "Options: (A) 60 km (B) 120 km (C) 180 km (D) 240 km (E) 300 km\n"
    "Let's think step by step. Speed is 60 km/h, so in 3 hours it "
    "travels 60 * 3 = 180 km, option C. The answer is (C).\n\n"
)

_TASKS = {
    "bbh": dict(prompt=BBH_PROMPT, choice=True, file="bbh.jsonl"),
    "mmlu": dict(prompt=MMLU_PROMPT, choice=True, file="mmlu.jsonl"),
    "aqua": dict(prompt=AQUA_PROMPT, choice=True, file="aqua.jsonl"),
}


def extract_choice(text: str) -> str:
    """Option-letter extraction ('the answer is (B)')."""
    matches = _CHOICE_RE.findall(text)
    if matches:
        return matches[-1].upper()
    m = _FREEFORM_RE.findall(text)
    if m:
        return m[-1].strip().upper()
    return "[invalid]"


def _synthetic_rows(task: str, n: int) -> List[dict]:
    rows = []
    for i in range(n):
        a, b = 2 + i % 7, 3 + i % 5
        opts = [a + b, a + b + 1, a + b - 1, a * b]
        letter = "ABCD"[i % 4]
        ordered = opts[-(i % 4):] + opts[:-(i % 4)]
        opt_s = " ".join(f"({c}) {v}" for c, v in zip("ABCD", ordered))
        rows.append({
            "question": f"What is {a} + {b}? Options: {opt_s}",
            "answer": "ABCD"[ordered.index(a + b)],
        })
        del letter
    return rows


def load_task(task: str, limit: Optional[int] = None) -> List[dict]:
    info = _TASKS[task]
    path = os.path.join(data_dir(), info["file"])
    if os.path.exists(path):
        rows = [json.loads(line) for line in open(path)]
    else:
        rows = _synthetic_rows(task, limit or 64)
    return rows[:limit] if limit else rows


def evaluate_cot_task(task: str,
                      generate_fn: Callable[[List[str]], List[str]],
                      limit: int = 64, batch_size: int = 8,
                      output_dir: Optional[str] = None) -> dict:
    """BBH/MMLU/AQuA CoT eval (same protocol as evaluate_gsm8k; the
    reference records this grid in kv_quant/new_test.sh:8-14)."""
    info = _TASKS[task]
    rows = load_task(task, limit)
    n_correct = 0
    records = []
    t0 = time.time()
    for b0 in range(0, len(rows), batch_size):
        batch = rows[b0:b0 + batch_size]
        prompts = [info["prompt"] + "Question: " + r["question"] +
                   "\nLet's think step by step." for r in batch]
        outs = generate_fn(prompts)
        for r, out in zip(batch, outs):
            pred = extract_choice(out)
            gt = str(r["answer"]).strip().upper()
            ok = pred == gt
            n_correct += ok
            records.append({"question": r["question"], "generation": out,
                            "pred": pred, "gt": gt, "correct": bool(ok)})
    acc = n_correct / max(len(rows), 1)
    result = {"task": task, "accuracy": acc, "n": len(rows),
              "seconds": time.time() - t0}
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir,
                               f"evaluation_{task}.json"), "w") as f:
            json.dump(result, f, indent=2)
        with open(os.path.join(output_dir,
                               f"generations_{task}.jsonl"), "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return result
