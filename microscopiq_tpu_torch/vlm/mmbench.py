"""MMBench multiple-choice harness for LLaVA.

Counterpart of ``microscopiq_tpu/vlm/mmbench.py`` (the same names and
outputs).

Parity target: ``vlm/llava/eval/model_vqa_mmbench.py`` — TSV questions
with base64-encoded images, hint prepending, lettered options with
circular rotation (``all_rounds``), the single-pred prompt suffix
(en/cn), and the answers-jsonl schema
``{question_id, round_id, prompt, text, options, option_char,
answer_id, model_id, metadata}`` (model_vqa_mmbench.py:80-137).

The model path rides the port's generation loop, as the VQA harness does
(`eval_vqa.generate_mm`: an eager prefill with the pixels, then decode
steps replayed from CUDA graphs on the card); an injectable ``answer_fn``
lets the harness run without a model (tests, external workers).
"""

from __future__ import annotations

import base64
import csv
import io
import json
import math
import os
import uuid
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

ALL_OPTIONS = ["A", "B", "C", "D"]


def is_none(value) -> bool:
    """model_vqa_mmbench.py:33-42 — None / NaN / 'nan' / 'none' / ''."""
    if value is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    if isinstance(value, str) and value.lower() in ("nan", "none", ""):
        return True
    return False


def get_options(row: Dict, options: Sequence[str] = ALL_OPTIONS
                ) -> List[str]:
    """Collect option texts until the first missing one (:44-51)."""
    parsed = []
    for opt in options:
        val = row.get(opt)
        if is_none(val):
            break
        parsed.append(val)
    return parsed


def load_mmbench_table(path: str) -> List[Dict]:
    """MMBench question TSV → list of row dicts (index, question, hint,
    image, A..D, [answer, category, ...])."""
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def load_image_from_base64(data: str) -> np.ndarray:
    """base64 PNG/JPEG → (H, W, 3) uint8 (reference mm_utils helper)."""
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")
    return np.asarray(img)


CN_SUFFIX = "请直接回答选项字母。"
EN_SUFFIX = "Answer with the option's letter from the given choices directly."


def build_question(row: Dict, options: Sequence[str],
                   option_chars: Sequence[str],
                   single_pred_prompt: bool = True,
                   lang: str = "en") -> str:
    """Hint + question + lettered options (+ direct-answer suffix),
    exactly model_vqa_mmbench.py:81-99."""
    question = row["question"]
    hint = row.get("hint")
    if not is_none(hint):
        question = hint + "\n" + question
    for ch, opt in zip(option_chars, options):
        question = question + "\n" + ch + ". " + opt
    if single_pred_prompt:
        question = question + "\n" + (CN_SUFFIX if lang == "cn"
                                      else EN_SUFFIX)
    return question


def iter_rounds(row: Dict, all_rounds: bool = False):
    """Yield (round_idx, options, option_chars) with the circular
    rotation of :138-140 between rounds."""
    options = get_options(row)
    chars = list(ALL_OPTIONS[:len(options)])
    num_rounds = len(options) if all_rounds else 1
    for r in range(num_rounds):
        yield r, list(options), list(chars)
        options = options[1:] + options[:1]
        chars = chars[1:] + chars[:1]


def eval_mmbench(questions: List[Dict],
                 answer_fn: Callable[[str, Optional[np.ndarray]], str],
                 answers_file: str,
                 conv_mode: str = "llava_v1",
                 all_rounds: bool = False,
                 single_pred_prompt: bool = True,
                 lang: str = "en",
                 num_chunks: int = 1, chunk_idx: int = 0,
                 model_id: str = "microscopiq-llava") -> List[Dict]:
    """Run the benchmark loop; ``answer_fn(prompt_text, image)`` returns
    the model's reply (image is (H, W, 3) uint8 or None when the row has
    no image). Writes the reference's answers jsonl."""
    from .conversation import conv_templates
    from .mm_utils import get_chunk

    questions = get_chunk(questions, num_chunks, chunk_idx)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    results = []
    with open(answers_file, "w") as f:
        for row in questions:
            image = (load_image_from_base64(row["image"])
                     if not is_none(row.get("image")) else None)
            for r, options, chars in iter_rounds(row, all_rounds):
                cur_prompt = build_question(row, options, chars,
                                            single_pred_prompt, lang)
                conv = conv_templates[conv_mode].copy()
                conv.append_message(conv.roles[0],
                                    "<image>\n" + cur_prompt)
                conv.append_message(conv.roles[1], None)
                text = answer_fn(conv.get_prompt(), image).strip()
                rec = {"question_id": row["index"], "round_id": r,
                       "prompt": cur_prompt, "text": text,
                       "options": options, "option_char": chars,
                       "answer_id": uuid.uuid4().hex[:22],
                       "model_id": model_id, "metadata": {}}
                f.write(json.dumps(rec) + "\n")
                results.append(rec)
    return results


def make_model_answer_fn(model, tokenizer, max_new_tokens: int = 1024,
                         cache_kind: str = "dense", quant_cfg=None):
    """Adapt a LlavaForCausalLM (its weights installed) to eval_mmbench's
    answer_fn."""
    from .eval_vqa import generate_mm
    from .mm_utils import (expand_image_tokens, process_images,
                           tokenizer_image_token)

    vis = model.cfg.vision
    eos = getattr(tokenizer, "eos_token_id", None)

    def answer(prompt: str, image: Optional[np.ndarray]) -> str:
        ids = tokenizer_image_token(prompt, tokenizer)
        input_ids, img_mask = expand_image_tokens(
            ids, model.cfg.num_image_tokens)
        pix = process_images(
            [image if image is not None
             else np.zeros((vis.image_size, vis.image_size, 3),
                           np.uint8)], vis.image_size)
        out = generate_mm(model, input_ids[None], img_mask[None],
                          pix, max_new_tokens, eos_token_id=eos,
                          cache_kind=cache_kind, quant_cfg=quant_cfg)
        return tokenizer.decode([int(t) for t in out[0] if t != eos])

    return answer


def score_mmbench(answers: List[Dict], questions: List[Dict]
                  ) -> Dict[str, float]:
    """Accuracy against the TSV's ``answer`` column, honoring the
    per-round option rotation (a prediction is right when the predicted
    letter maps back to the ground-truth option text)."""
    truth = {str(q["index"]): q for q in questions}
    n = hit = 0
    for a in answers:
        q = truth.get(str(a["question_id"]))
        if q is None or is_none(q.get("answer")):
            continue
        gt_text = q.get(q["answer"])          # ground-truth option text
        pred = a["text"].strip().rstrip(".").upper()[:1]
        if pred not in a["option_char"]:
            n += 1
            continue
        pred_text = a["options"][a["option_char"].index(pred)]
        n += 1
        hit += int(pred_text == gt_text)
    return {"accuracy": hit / max(n, 1), "total": n, "correct": hit}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="MMBench harness (file mode)")
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--answers-file", required=True)
    ap.add_argument("--answers-in", default=None,
                    help="score an existing answers jsonl instead of "
                         "running a model")
    ap.add_argument("--all-rounds", action="store_true")
    ap.add_argument("--lang", default="en", choices=["en", "cn"])
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    args = ap.parse_args(argv)

    questions = load_mmbench_table(args.question_file)
    if args.answers_in:
        with open(args.answers_in) as f:
            answers = [json.loads(l) for l in f if l.strip()]
        print(json.dumps(score_mmbench(answers, questions)))
        return
    raise SystemExit(
        "file-mode model runs need a checkpoint; use eval_mmbench() with "
        "make_model_answer_fn from Python, or --answers-in to score")


if __name__ == "__main__":
    main()
