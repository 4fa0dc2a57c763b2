"""LLM-judge pairwise review pipeline + score summarizer.

Counterpart of ``microscopiq_tpu/vlm/gpt_review.py`` (host-side Python,
copied: the same names, prompts, schemas and summary math).

Parity targets: ``vlm/llava/eval/eval_gpt_review.py`` (content
assembly :96-101, ``parse_score`` :39-52, review jsonl schema
:98-120), ``eval_gpt_review_visual.py`` (the ``[Context]`` variant
with caption + bbox strings :85-99), and
``summarize_gpt_review.py`` (per-category means and the
relative-score table :98-119).

The reference calls the OpenAI API through ray workers; this
environment has zero egress, so the judge is a pluggable callable
``judge_fn(content, max_tokens) -> str`` — wire it to a local model,
a subprocess (``make_command_judge``), or any endpoint. Everything
around it (prompt assembly, rule files, score parsing, jsonl schema,
summary math) is reference-exact.
"""

from __future__ import annotations

import json
import os
import subprocess
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def build_review_content(question: Dict, answer1: Dict, answer2: Dict,
                         rule: Dict, context: Optional[Dict] = None
                         ) -> str:
    """The judge prompt (eval_gpt_review.py:96-101; with ``context``,
    the visual variant's ``[Context]`` header :95-99)."""
    prompt, role = rule["prompt"], rule["role"]
    head = ""
    if context is not None:
        cap_str = "\n".join(context.get("captions", []))
        box_str = "\n".join(
            f'{inst["category"]}: {inst["bbox"]}'
            for inst in context.get("instances", []))
        head = f"[Context]\n{cap_str}\n\n{box_str}\n\n"
    return (head
            + f'[Question]\n{question["text"]}\n\n'
            + f'[{role} 1]\n{answer1["text"]}\n\n[End of {role} 1]\n\n'
            + f'[{role} 2]\n{answer2["text"]}\n\n[End of {role} 2]\n\n'
            + f'[System]\n{prompt}\n\n')


def parse_score(review: str) -> List[float]:
    """First line 'x, y' → [x, y]; malformed → [-1, -1] (:39-52)."""
    try:
        pair = review.split("\n")[0].replace(",", " ").split()
        if len(pair) == 2:
            return [float(pair[0]), float(pair[1])]
        return [-1, -1]
    except Exception:
        return [-1, -1]


def pick_rule(rule_dict: Dict, category: str, strict: bool = False
              ) -> Dict:
    """Category rule with 'default' fallback (eval_gpt_review.py:88-92;
    the visual variant asserts instead — ``strict=True``)."""
    if category in rule_dict:
        return rule_dict[category]
    if strict:
        raise KeyError(
            f"Visual QA category not found in rule file: {category}")
    return rule_dict["default"]


def review_answers(questions: Sequence[Dict], answers1: Sequence[Dict],
                   answers2: Sequence[Dict], rule_dict: Dict,
                   judge_fn: Callable[[str, int], str],
                   contexts: Optional[Dict[str, Dict]] = None,
                   max_tokens: int = 1024) -> List[Dict]:
    """Zip the three streams, judge each triple, return review records
    in the reference's jsonl schema (id/question_id/answer?_id/category/
    content/tuple)."""
    out = []
    for idx, (q, a1, a2) in enumerate(zip(questions, answers1, answers2)):
        category = q.get("category", "default")
        ctx = (contexts[q["image"]] if contexts is not None else None)
        rule = pick_rule(rule_dict, category, strict=contexts is not None)
        content = build_review_content(q, a1, a2, rule, ctx)
        review = judge_fn(content, max_tokens)
        out.append({
            "id": idx + 1,
            "question_id": q.get("question_id"),
            "answer1_id": a1.get("answer_id", a1.get("answer1_id")),
            "answer2_id": a2.get("answer_id", a2.get("answer2_id")),
            "category": category,
            "content": review,
            "tuple": parse_score(review),
        })
    return out


def review_files(question_file: str, answer_files: Sequence[str],
                 rule_file: str, output: str,
                 judge_fn: Callable[[str, int], str],
                 context_file: Optional[str] = None,
                 max_tokens: int = 1024) -> List[Dict]:
    """File-mode driver (eval_gpt_review.py:55-120)."""
    def load_jsonl(p):
        with open(os.path.expanduser(p)) as f:
            return [json.loads(l) for l in f if l.strip()]

    questions = load_jsonl(question_file)
    ans1 = load_jsonl(answer_files[0])
    ans2 = load_jsonl(answer_files[1])
    with open(os.path.expanduser(rule_file)) as f:
        rule_dict = json.load(f)
    contexts = None
    if context_file is not None:
        ctx_list = load_jsonl(context_file)
        contexts = {c["image"]: c for c in ctx_list}
    reviews = review_answers(questions, ans1, ans2, rule_dict, judge_fn,
                             contexts, max_tokens)
    with open(output, "w") as f:
        for r in reviews:
            f.write(json.dumps(r) + "\n")
    return reviews


def make_command_judge(cmd: List[str]) -> Callable[[str, int], str]:
    """Judge that pipes the content to a subprocess's stdin and reads
    the review from stdout (local-model stand-in for the API judge)."""
    def judge(content: str, max_tokens: int) -> str:
        return subprocess.run(cmd, input=content, capture_output=True,
                              text=True, check=True).stdout

    return judge


def summarize_reviews(records: Sequence[Dict]) -> Dict[str, List[float]]:
    """Per-category [relative_pct, score1_x10, score2_x10] with the
    reference's rounding (summarize_gpt_review.py:98-119): scores are
    means of the tuples, relative = score2/score1 * 100."""
    scores = defaultdict(list)
    for review in records:
        if "category" in review:
            scores[review["category"]].append(review["tuple"])
            scores["all"].append(review["tuple"])
        elif "tuple" in review:
            scores["all"].append(review["tuple"])
        else:
            scores["all"].append(review["score"])
    out = {}
    for k, v in sorted(scores.items()):
        stats = [round(x, 3) for x in np.asarray(v).mean(0).tolist()]
        out[k] = [round(stats[1] / stats[0] * 100, 1),
                  round(stats[0] * 10, 1), round(stats[1] * 10, 1)]
    return out


def summarize_files(review_files_: Sequence[str],
                    ignore: Sequence = ()) -> Dict[str, Dict]:
    """Summarize each review jsonl (CLI: one table per file)."""
    ignore = set(ignore)
    out = {}
    for path in sorted(review_files_):
        with open(path) as f:
            recs = [json.loads(l) for l in f if l.strip()]
        recs = [r for r in recs if r.get("question_id") not in ignore]
        config = (os.path.basename(path)
                  .replace("gpt4_text_", "").replace(".jsonl", ""))
        out[config] = summarize_reviews(recs)
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="LLM-judge pairwise review (offline-pluggable)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rv = sub.add_parser("review")
    rv.add_argument("-q", "--question", required=True)
    rv.add_argument("-a", "--answer-list", nargs=2, required=True)
    rv.add_argument("-r", "--rule", required=True)
    rv.add_argument("-c", "--context", default=None)
    rv.add_argument("-o", "--output", required=True)
    rv.add_argument("--judge-cmd", nargs="+", required=True,
                    help="command reading content on stdin, writing the "
                         "review on stdout")
    rv.add_argument("--max-tokens", type=int, default=1024)

    sm = sub.add_parser("summarize")
    sm.add_argument("-f", "--files", nargs="+", required=True)
    sm.add_argument("-i", "--ignore", nargs="*", default=[])

    args = ap.parse_args(argv)
    if args.cmd == "review":
        review_files(args.question, args.answer_list, args.rule,
                     args.output, make_command_judge(args.judge_cmd),
                     args.context, args.max_tokens)
    else:
        for config, table in summarize_files(
                args.files, [int(x) for x in args.ignore]).items():
            print(config)
            for k, (rel, s1, s2) in table.items():
                print(k, rel, s1, s2)
            print("=" * 33)


if __name__ == "__main__":
    main()
