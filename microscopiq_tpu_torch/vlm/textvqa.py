"""TextVQA / ST-VQA evaluation metrics + file harness.

Counterpart of ``microscopiq_tpu/vlm/textvqa.py`` (host-side Python,
copied: the same names, normalization tables and outputs).

Parity targets: ``vlm/llava/eval/m4c_evaluator.py`` (the EvalAI answer
normalization pipeline — contractions, number words, punctuation and
article stripping — and the TextVQA 10-annotator soft accuracy, ST-VQA
exact match, and ANLS evaluators) and ``vlm/llava/eval/eval_textvqa.py``
(prompt→question recovery :17-32, annotation join + accuracy report
:35-51). The normalization tables are the standard public EvalAI / VQA-v2
constants. ANLS uses a self-contained Levenshtein (the reference pulls
the ``editdistance`` wheel)."""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Sequence

_CONTRACTION_BASES = [
    "aint", "arent", "cant", "couldve", "couldnt", "didnt", "doesnt",
    "dont", "hadnt", "hasnt", "havent", "hed", "hes", "howd", "howll",
    "hows", "Im", "Ive", "isnt", "itd", "itll", "lets", "maam",
    "mightnt", "mightve", "mustnt", "mustve", "neednt", "notve",
    "oclock", "oughtnt", "shant", "shouldve", "shouldnt", "somebodyll",
    "somebodys", "someonell", "someones", "somethingll", "thats",
    "therere", "theres", "theyll", "theyre", "theyve", "twas", "wasnt",
    "weve", "werent", "whatll", "whatre", "whats", "whatve", "whens",
    "whered", "wheres", "whereve", "wholl", "whos", "whove", "whyll",
    "whyre", "whys", "wont", "wouldve", "wouldnt", "yall", "youll",
    "youre", "youve",
]
_CONTRACTION_TARGETS = [
    "ain't", "aren't", "can't", "could've", "couldn't", "didn't",
    "doesn't", "don't", "hadn't", "hasn't", "haven't", "he'd", "he's",
    "how'd", "how'll", "how's", "I'm", "I've", "isn't", "it'd", "it'll",
    "let's", "ma'am", "mightn't", "might've", "mustn't", "must've",
    "needn't", "not've", "o'clock", "oughtn't", "shan't", "should've",
    "shouldn't", "somebody'll", "somebody's", "someone'll", "someone's",
    "something'll", "that's", "there're", "there's", "they'll",
    "they're", "they've", "'twas", "wasn't", "we've", "weren't",
    "what'll", "what're", "what's", "what've", "when's", "where'd",
    "where's", "where've", "who'll", "who's", "who've", "why'll",
    "why're", "why's", "won't", "would've", "wouldn't", "y'all",
    "you'll", "you're", "you've",
]
CONTRACTIONS = dict(zip(_CONTRACTION_BASES, _CONTRACTION_TARGETS))
# compound forms (base'd've etc.) from the reference table
CONTRACTIONS.update({
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hed've": "he'd've", "he'dve": "he'd've",
    "Id've": "I'd've", "I'dve": "I'd've",
    "itd've": "it'd've", "it'dve": "it'd've",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shed've": "she'd've", "she'dve": "she'd've", "she's": "she's",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've",
    "someoned": "someone'd", "someoned've": "someone'd've",
    "someone'dve": "someone'd've",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've",
    "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "wed've": "we'd've", "we'dve": "we'd've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've",
    "youd": "you'd", "youd've": "you'd've", "you'dve": "you'd've",
})

NUMBER_MAP = {"none": "0", "zero": "0", "one": "1", "two": "2",
              "three": "3", "four": "4", "five": "5", "six": "6",
              "seven": "7", "eight": "8", "nine": "9", "ten": "10"}
ARTICLES = ["a", "an", "the"]
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
PUNCTUATIONS = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+",
                "\\", "_", "-", ">", "<", "@", "`", ",", "?", "!"]


class EvalAIAnswerProcessor:
    """m4c_evaluator.py:7-218 normalization pipeline."""

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, in_text: str) -> str:
        out_text = in_text
        for p in PUNCTUATIONS:
            if (p + " " in in_text or " " + p in in_text) or (
                    re.search(COMMA_STRIP, in_text) is not None):
                out_text = out_text.replace(p, "")
            else:
                out_text = out_text.replace(p, " ")
        return PERIOD_STRIP.sub("", out_text, re.UNICODE)

    def process_digit_article(self, in_text: str) -> str:
        out = []
        for word in in_text.lower().split():
            word = NUMBER_MAP.get(word, word)
            if word not in ARTICLES:
                out.append(word)
        for i, word in enumerate(out):
            if word in CONTRACTIONS:
                out[i] = CONTRACTIONS[word]
        return " ".join(out)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


class TextVQAAccuracyEvaluator:
    """10-annotator soft accuracy: score(a) = avg over leave-one-out
    min(1, matches/3) (m4c_evaluator.py:224-258)."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def _compute_answer_scores(self, raw_answers: Sequence[str]):
        answers = [self.answer_processor(a) for a in raw_answers]
        assert len(answers) == 10
        gt_answers = list(enumerate(answers))
        scores = {}
        for unique_answer in set(answers):
            accs = []
            for gt_answer in gt_answers:
                others = [it for it in gt_answers if it != gt_answer]
                matching = [it for it in others if it[1] == unique_answer]
                accs.append(min(1, float(len(matching)) / 3))
            scores[unique_answer] = sum(accs) / len(accs)
        return scores

    def eval_pred_list(self, pred_list: List[Dict]) -> float:
        pred_scores = []
        for entry in pred_list:
            pred = self.answer_processor(entry["pred_answer"])
            scores = self._compute_answer_scores(entry["gt_answers"])
            pred_scores.append(scores.get(pred, 0.0))
        return sum(pred_scores) / len(pred_scores)


class STVQAAccuracyEvaluator:
    """Exact match after normalization (m4c_evaluator.py:261-274)."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list: List[Dict]) -> float:
        scores = []
        for entry in pred_list:
            pred = self.answer_processor(entry["pred_answer"])
            gts = [self.answer_processor(a) for a in entry["gt_answers"]]
            scores.append(1.0 if pred in gts else 0.0)
        return sum(scores) / len(scores)


def _levenshtein(a: str, b: str) -> int:
    """Edit distance (self-contained; the reference imports the
    ``editdistance`` wheel, absent here)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class STVQAANLSEvaluator:
    """ANLS: 1 - NL edit distance, zeroed under 0.5
    (m4c_evaluator.py:277-295)."""

    def get_anls(self, s1: str, s2: str) -> float:
        s1, s2 = s1.lower().strip(), s2.lower().strip()
        iou = 1 - _levenshtein(s1, s2) / max(len(s1), len(s2))
        return iou if iou >= 0.5 else 0.0

    def eval_pred_list(self, pred_list: List[Dict]) -> float:
        scores = [max(self.get_anls(e["pred_answer"], gt)
                      for gt in e["gt_answers"]) for e in pred_list]
        return sum(scores) / len(scores)


def prompt_processor(prompt: str) -> str:
    """Recover the raw question from the TextVQA prompt variants
    (eval_textvqa.py:17-32)."""
    if prompt.startswith("OCR tokens: "):
        match = re.search(r"Question: (.*?) Short answer:", prompt,
                          re.DOTALL)
        question = match.group(1)
    elif "Reference OCR token: " in prompt and len(prompt.split("\n")) == 3:
        if prompt.startswith("Reference OCR token:"):
            question = prompt.split("\n")[1]
        else:
            question = prompt.split("\n")[0]
    elif len(prompt.split("\n")) == 2:
        question = prompt.split("\n")[0]
    else:
        raise AssertionError(f"unrecognized TextVQA prompt: {prompt!r}")
    return question.lower()


def eval_textvqa_files(annotation_file: str, result_file: str) -> Dict:
    """Join predictions to annotations on (question_id, question) and
    report 10-annotator soft accuracy (eval_textvqa.py:35-51)."""
    with open(os.path.expanduser(annotation_file)) as f:
        annotations = json.load(f)["data"]
    annotations = {(a["image_id"], a["question"].lower()): a
                   for a in annotations}
    with open(os.path.expanduser(result_file)) as f:
        results = [json.loads(l) for l in f if l.strip()]

    pred_list = []
    for result in results:
        ann = annotations[(result["question_id"],
                           prompt_processor(result["prompt"]))]
        pred_list.append({"pred_answer": result["text"],
                          "gt_answers": ann["answers"]})
    acc = TextVQAAccuracyEvaluator().eval_pred_list(pred_list)
    return {"samples": len(pred_list), "accuracy": acc}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="TextVQA accuracy")
    ap.add_argument("--annotation-file", required=True)
    ap.add_argument("--result-file", required=True)
    args = ap.parse_args(argv)
    out = eval_textvqa_files(args.annotation_file, args.result_file)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
