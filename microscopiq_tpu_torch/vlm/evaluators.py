"""POPE and ScienceQA answer evaluators, and the text-only QA harness.

Counterpart of ``microscopiq_tpu/vlm/evaluators.py`` (host-side Python,
copied: the same names, rules and output schemas).

Parity targets: ``vlm/llava/eval/eval_pope.py`` (yes/no normalization,
TP/FP/TN/FN, precision/recall/F1/accuracy/yes-ratio per POPE category)
and ``vlm/llava/eval/eval_science_qa.py`` (answer-letter parsing rules,
per-problem correctness split, IMG-subset accuracy, sqa_results schema).

Generation happens through :func:`.eval_vqa.eval_vqa` (answers
jsonl); these score the jsonl against annotations. Pure functions +
file-level CLIs mirroring the reference's flags.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Dict, List, Sequence


# ---------------------------------------------------------------------------
# POPE (eval_pope.py:5-62)
# ---------------------------------------------------------------------------
def normalize_pope_answer(text: str) -> str:
    """Reference rule (eval_pope.py:8-20): keep the first sentence, strip
    commas; 'no'/'No'/'not' anywhere → "no", else "yes"."""
    if text.find(".") != -1:
        text = text.split(".")[0]
    text = text.replace(",", "")
    words = text.split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) else "yes"


def eval_pope(answers: List[dict], labels: Sequence[str]) -> Dict[str, float]:
    """answers: [{'text': ...}, ...] aligned with labels ('yes'/'no').
    Returns the reference's printed metrics (eval_pope.py:22-61)."""
    preds = [0 if normalize_pope_answer(a["text"]) == "no" else 1
             for a in answers]
    labs = [0 if l == "no" else 1 for l in labels]
    TP = sum(1 for p, l in zip(preds, labs) if p == 1 and l == 1)
    FP = sum(1 for p, l in zip(preds, labs) if p == 1 and l == 0)
    TN = sum(1 for p, l in zip(preds, labs) if p == 0 and l == 0)
    FN = sum(1 for p, l in zip(preds, labs) if p == 0 and l == 1)
    precision = TP / (TP + FP) if TP + FP else 0.0
    recall = TP / (TP + FN) if TP + FN else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    acc = (TP + TN) / max(TP + TN + FP + FN, 1)
    yes_ratio = sum(preds) / max(len(preds), 1)
    return {"TP": TP, "FP": FP, "TN": TN, "FN": FN,
            "precision": precision, "recall": recall, "f1": f1,
            "accuracy": acc, "yes_ratio": yes_ratio}


def eval_pope_files(annotation_dir: str, question_file: str,
                    result_file: str) -> Dict[str, Dict[str, float]]:
    """Per-category scoring over coco_pope_<category>.json label files
    (eval_pope.py:64-80)."""
    questions = {q["question_id"]: q
                 for q in map(json.loads, open(question_file))}
    answers = [json.loads(l) for l in open(result_file)]
    out = {}
    for fname in sorted(os.listdir(annotation_dir)):
        if not (fname.startswith("coco_pope_") and fname.endswith(".json")):
            continue
        category = fname[len("coco_pope_"):-len(".json")]
        cur = [a for a in answers
               if questions[a["question_id"]]["category"] == category]
        labels = [json.loads(l)["label"]
                  for l in open(os.path.join(annotation_dir, fname))]
        out[category] = eval_pope(cur, labels)
    return out


# ---------------------------------------------------------------------------
# ScienceQA (eval_science_qa.py:28-121)
# ---------------------------------------------------------------------------
_ANSWER_RE = re.compile(r"The answer is ([A-Z]).")


def parse_sqa_answer(pred_text: str, options: Sequence[str]) -> str:
    """Reference parsing ladder (eval_science_qa.py:64-75): bare letter,
    'X. ...' prefix, or 'The answer is X.'; else FAILED."""
    if pred_text in options:
        return pred_text
    if (len(pred_text) >= 3 and pred_text[0] in options
            and pred_text[1:3] == ". "):
        return pred_text[0]
    res = _ANSWER_RE.findall(pred_text)
    return res[0] if len(res) == 1 else "FAILED"


def get_pred_idx(prediction: str, choices: Sequence,
                 options: Sequence[str]) -> int:
    """eval_science_qa.py:28-36 (deterministic branch: unparseable
    predictions count wrong rather than rolling the reference's
    unreachable random fallback)."""
    if prediction in options[:len(choices)]:
        return options.index(prediction)
    return -1


def eval_science_qa(predictions: Dict[str, dict], problems: Dict[str, dict],
                    split_indices: Sequence[str],
                    options: Sequence[str] = tuple("ABCDE")) -> dict:
    """predictions: question_id -> {'text', 'prompt'}; problems:
    question_id -> {'choices', 'answer'}. Returns (results, sqa_results)
    in the reference's output schemas (eval_science_qa.py:49-121)."""
    results = {"correct": [], "incorrect": []}
    sqa_results = {"acc": None, "correct": None, "count": None,
                   "results": {}, "outputs": {}}
    for prob_id in split_indices:
        prob = problems[prob_id]
        pred = predictions.get(prob_id, {"text": "FAILED",
                                         "prompt": "Unknown"})
        answer = parse_sqa_answer(pred["text"], list(options))
        pred_idx = get_pred_idx(answer, prob["choices"], list(options))
        analysis = {
            "question_id": prob_id,
            "parsed_ans": answer,
            "ground_truth": list(options)[prob["answer"]],
            "question": pred["prompt"],
            "pred": pred["text"],
            "is_multimodal": "<image>" in pred["prompt"],
        }
        sqa_results["results"][prob_id] = pred_idx
        sqa_results["outputs"][prob_id] = pred["text"]
        (results["correct"] if pred_idx == prob["answer"]
         else results["incorrect"]).append(analysis)

    correct = len(results["correct"])
    total = correct + len(results["incorrect"])
    mm_c = len([x for x in results["correct"] if x["is_multimodal"]])
    mm_i = len([x for x in results["incorrect"] if x["is_multimodal"]])
    sqa_results["acc"] = correct / max(total, 1) * 100
    sqa_results["correct"] = correct
    sqa_results["count"] = total
    sqa_results["img_acc"] = mm_c / max(mm_c + mm_i, 1) * 100
    return results, sqa_results


def eval_qa(questions, answer_fn, answers_file: str,
            model_id: str = "microscopiq-llm",
            conv_mode: str = "llava_v1"):
    """Text-only QA harness (model_qa.py:14-56): question jsonl
    ({question_id, text, category}) -> answers jsonl. ``answer_fn``
    maps the templated prompt to the model's reply (injectable; wire it
    to serve.cli.stream_generate or eval.generate for a real model)."""
    import json
    import os
    import uuid

    from .conversation import conv_templates

    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    results = []
    with open(answers_file, "w") as f:
        for q in questions:
            conv = conv_templates[conv_mode].copy()
            conv.append_message(conv.roles[0], q["text"])
            conv.append_message(conv.roles[1], None)
            text = answer_fn(conv.get_prompt()).strip()
            rec = {"question_id": q.get("question_id"),
                   "text": text,
                   "answer_id": uuid.uuid4().hex[:22],
                   "model_id": model_id,
                   "metadata": {}}
            f.write(json.dumps(rec) + "\n")
            results.append(rec)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("pope")
    pp.add_argument("--annotation-dir", required=True)
    pp.add_argument("--question-file", required=True)
    pp.add_argument("--result-file", required=True)
    ps = sub.add_parser("scienceqa")
    ps.add_argument("--base-dir", required=True)
    ps.add_argument("--result-file", required=True)
    ps.add_argument("--output-file", required=True)
    ps.add_argument("--output-result", required=True)
    ps.add_argument("--split", default="test")
    ps.add_argument("--options", nargs="+",
                    default=["A", "B", "C", "D", "E"])
    args = ap.parse_args(argv)

    if args.cmd == "pope":
        scores = eval_pope_files(args.annotation_dir, args.question_file,
                                 args.result_file)
        for cat, m in scores.items():
            print(f"Category: {cat}")
            print("TP\tFP\tTN\tFN\t")
            print(f"{m['TP']}\t{m['FP']}\t{m['TN']}\t{m['FN']}")
            print(f"Accuracy: {m['accuracy']}")
            print(f"Precision: {m['precision']}")
            print(f"Recall: {m['recall']}")
            print(f"F1 score: {m['f1']}")
            print(f"Yes ratio: {m['yes_ratio']}")
    else:
        split_indices = json.load(
            open(os.path.join(args.base_dir, "pid_splits.json")))[args.split]
        problems = json.load(
            open(os.path.join(args.base_dir, "problems.json")))
        predictions = {p["question_id"]: p for p in
                       map(json.loads, open(args.result_file))}
        results, sqa = eval_science_qa(
            predictions, problems, split_indices, args.options)
        print(f"Total: {sqa['count']}, Correct: {sqa['correct']}, "
              f"Accuracy: {sqa['acc']:.2f}%, "
              f"IMG-Accuracy: {sqa['img_acc']:.2f}%")
        with open(args.output_file, "w") as f:
            json.dump(results, f, indent=2)
        with open(args.output_result, "w") as f:
            json.dump(sqa, f, indent=2)


if __name__ == "__main__":
    main()

