"""The port's VLM generation, calibration, evaluators, delta CLI and probe
against the JAX package's, on the CPU (tiny configs; the helpers and the
shared JAX init come from tests/test_torch_vlm.py).

Tolerances:
- greedy tokens equal: generate_mm over the dense and the 4-bit caches,
  and the answers jsonl of eval_vqa (chunked, merged);
- llava_sequential: >= 95% of each quantized kernel's entries equal to
  JAX's, the share tests/test_torch_gptq.py holds GPTQ to (the two
  Cholesky factorizations round differently); the tower, projector,
  embedding, norms and lm_head bit-unchanged;
- the host-side evaluators (POPE, ScienceQA, TextVQA, MMBench, the LLM-judge
  review): outputs equal, fed the fixtures of tests/test_vlm.py (the random
  ``answer_id`` of a record apart);
- the delta CLI: checkpoints the JAX package writes, the port's CLI
  combines with ``--device cpu``, the JAX package reads: equal to JAX's
  own delta arithmetic (float32 sums of the same operands).
"""

import base64
import csv
import importlib.util
import io
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu import vlm as jvlm
from microscopiq_tpu.kv.cache import QuantKVConfig as JQuantKVConfig
from microscopiq_tpu_torch import vlm
from microscopiq_tpu_torch.kv.cache import QuantKVConfig
from test_torch_vlm import _t, jax_to_numpy, leaves, pair, prompt, to_port

REPO = pathlib.Path(__file__).resolve().parents[1]


class FakeTokenizer:
    """tests/test_vlm.py's stand-in tokenizer."""
    bos_token_id = 1
    eos_token_id = 2

    def encode(self, s):
        return [1] + [3 + (ord(c) % 50) for c in s]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.mark.parametrize("kind", ["dense", "quant"])
def test_generate_mm_tokens_match_jax(kind):
    jm, params, tm, cfg = pair("tiny")
    ids, mask, pix = prompt(cfg, seed=11)
    jq = JQuantKVConfig(bits=4, gap=8) if kind == "quant" else None
    tq = QuantKVConfig(bits=4, gap=8) if kind == "quant" else None
    want = jvlm.generate_mm(jm, params, ids, mask, pix, max_new_tokens=12,
                            cache_kind=kind, quant_cfg=jq)
    got = vlm.generate_mm(tm, ids, mask, pix, max_new_tokens=12,
                          cache_kind=kind, quant_cfg=tq)
    assert got.dtype == np.int32 and got.shape == (1, 12)
    np.testing.assert_array_equal(got, want)
    # the EOS stop: a step whose token is EOS ends the decode, kept
    eos = int(want[0, 4])
    first = int(np.argmax(want[0] == eos))
    got = vlm.generate_mm(tm, ids, mask, pix, 12, eos_token_id=eos,
                          cache_kind=kind, quant_cfg=tq)
    np.testing.assert_array_equal(got, jvlm.generate_mm(
        jm, params, ids, mask, pix, 12, eos_token_id=eos, cache_kind=kind,
        quant_cfg=jq))
    assert got.shape == (1, first + 1) and got[0, -1] == eos


def test_llava_sequential_matches_jax_and_leaves_the_tower():
    jm, params, tm, cfg = pair("tiny")
    ids, mask, pix = prompt(cfg, B=2, seed=13)
    jq = jvlm.llava_sequential(jm, params, jnp.asarray(ids),
                               jnp.asarray(mask), jnp.asarray(pix),
                               nsamples_batch=2, verbose=False)
    before = to_port(params)
    tq = vlm.llava_sequential(tm, before, ids, mask, pix, nsamples_batch=2,
                              verbose=False)
    jl = dict(leaves(jax_to_numpy(jq["params"])))
    t0 = dict(leaves(before["params"] if "params" in before else before))
    changed = 0
    for path, t in leaves(tq["params"]):
        if path[0] == "model" and path[1].startswith("layers_") and \
                path[-1] == "kernel":
            same = np.mean(t.numpy() == jl[path])
            assert same >= 0.95, (path, same)
            changed += not torch.equal(t, t0[path])
        else:                 # tower, projector, embedding, norms, lm_head
            assert torch.equal(t, t0[path]), path
            np.testing.assert_array_equal(t.numpy(), jl[path])
    assert changed == 2 * 7
    with torch.no_grad():
        logits = vlm.LlavaForCausalLM(cfg, device="cpu").load_params(tq)(
            _t(ids).long(), pixel_values=_t(pix), image_token_mask=_t(mask))
    assert torch.isfinite(logits).all()


def _loader(name):
    rng = np.random.default_rng(int(name[2:]))
    return rng.uniform(0, 255, (18 + int(name[2:]), 18, 3))


@pytest.mark.parametrize("chunks", [1, 2])
def test_eval_vqa_answers_equal_jax(tmp_path, chunks):
    jm, params, tm, cfg = pair("tiny")
    qs = [{"question_id": i, "image": f"im{i}", "text": f"what is {i}?"}
          for i in range(3)]
    tok = FakeTokenizer()
    files = {}
    for pkg in ("jax", "port"):
        parts = []
        for k in range(chunks):
            f = str(tmp_path / f"{pkg}_{k}.jsonl")
            if pkg == "jax":
                jvlm.eval_vqa(jm, params, tok, qs, _loader, f,
                              max_new_tokens=6, num_chunks=chunks,
                              chunk_idx=k)
            else:
                vlm.eval_vqa(tm, tok, qs, _loader, f, max_new_tokens=6,
                             num_chunks=chunks, chunk_idx=k)
            parts.append(f)
        files[pkg] = str(tmp_path / f"{pkg}.jsonl")
        (jvlm if pkg == "jax" else vlm).merge_answer_chunks(parts,
                                                            files[pkg])
    got = pathlib.Path(files["port"]).read_text()
    assert got == pathlib.Path(files["jax"]).read_text()
    recs = [json.loads(line) for line in got.splitlines()]
    assert [r["question_id"] for r in recs] == [0, 1, 2]
    assert set(recs[0]) == {"question_id", "prompt", "text", "model_id",
                            "metadata"}


def test_mmbench_model_answer_fn_equals_jax():
    from microscopiq_tpu.vlm.mmbench import make_model_answer_fn as j_fn
    from microscopiq_tpu_torch.vlm.mmbench import make_model_answer_fn

    jm, params, tm, cfg = pair("tiny")
    tok = FakeTokenizer()
    conv = vlm.conv_templates["llava_v1"].copy()
    conv.append_message(conv.roles[0], "<image>\nWhich? A. x B. y")
    conv.append_message(conv.roles[1], None)
    p = conv.get_prompt()
    img = np.random.default_rng(4).integers(0, 255, (20, 14, 3),
                                            dtype=np.uint8)
    for image in (img, None):
        assert make_model_answer_fn(tm, tok, 5)(p, image) == \
            j_fn(jm, params, tok, 5)(p, image)


def _b64_png(rng, size=8):
    from PIL import Image

    arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode(), arr


def _strip_ids(recs):
    return [{k: v for k, v in r.items() if k != "answer_id"} for r in recs]


def test_mmbench_harness_equals_jax(tmp_path):
    from microscopiq_tpu.vlm import mmbench as jmb
    from microscopiq_tpu_torch.vlm import mmbench as tmb

    rng = np.random.default_rng(0)
    b64, arr = _b64_png(rng)
    rows = [
        {"index": "1", "question": "What color?", "hint": "Look closely.",
         "image": b64, "A": "red", "B": "blue", "C": "green", "D": "",
         "answer": "B", "category": "color"},
        {"index": "2", "question": "How many?", "hint": "nan",
         "image": b64, "A": "one", "B": "two", "C": "", "D": "",
         "answer": "A", "category": "count"},
    ]
    tsv = tmp_path / "q.tsv"
    with open(tsv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    assert tmb.load_mmbench_table(str(tsv)) == jmb.load_mmbench_table(
        str(tsv))
    questions = tmb.load_mmbench_table(str(tsv))
    np.testing.assert_array_equal(tmb.load_image_from_base64(b64), arr)
    for q in questions:
        assert tmb.get_options(q) == jmb.get_options(q)
        for rot in (False, True):
            assert list(tmb.iter_rounds(q, rot)) == list(
                jmb.iter_rounds(q, rot))
    seen = {"jax": [], "port": []}
    out = {}
    for pkg, mod in (("jax", jmb), ("port", tmb)):
        def answer(prompt, image, pkg=pkg):
            seen[pkg].append((prompt, image))
            return "B." if len(seen[pkg]) % 2 else "A"
        for lang in ("en", "cn"):
            f = tmp_path / f"{pkg}_{lang}.jsonl"
            recs = mod.eval_mmbench(questions, answer, str(f),
                                    all_rounds=True, lang=lang)
            out[(pkg, lang)] = (_strip_ids(recs), _strip_ids(
                [json.loads(line) for line in f.read_text().splitlines()]),
                mod.score_mmbench(recs, questions))
    for lang in ("en", "cn"):
        assert out[("port", lang)] == out[("jax", lang)]
    assert [p for p, _ in seen["port"]] == [p for p, _ in seen["jax"]]
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    assert tmb.is_none(float("nan")) and not tmb.is_none("B")


def test_pope_and_scienceqa_equal_jax(tmp_path, capsys):
    from microscopiq_tpu.vlm import evaluators as jev
    from microscopiq_tpu_torch.vlm import evaluators as tev

    texts = ["Yes, there is a dog. It is red.", "No.",
             "It is not there, sorry.", "there is no dog", "Yes it is."]
    for t in texts:
        assert tev.normalize_pope_answer(t) == jev.normalize_pope_answer(t)
    answers = [{"text": t} for t in
               ("Yes.", "No.", "Yes.", "not really", "Yes it is.")]
    labels = ["yes", "no", "no", "no", "yes"]
    assert tev.eval_pope(answers, labels) == jev.eval_pope(answers, labels)
    ann = tmp_path / "ann"
    ann.mkdir()
    for cat, labs in (("popular", labels), ("random", labels[::-1])):
        with open(ann / f"coco_pope_{cat}.json", "w") as f:
            for lab in labs:
                f.write(json.dumps({"label": lab}) + "\n")
    with open(tmp_path / "questions.jsonl", "w") as f:
        for i in range(10):
            f.write(json.dumps({"question_id": i, "category":
                                "popular" if i < 5 else "random"}) + "\n")
    with open(tmp_path / "answers.jsonl", "w") as f:
        for i, a in enumerate(answers + answers):
            f.write(json.dumps({"question_id": i, **a}) + "\n")
    args = [str(ann), str(tmp_path / "questions.jsonl"),
            str(tmp_path / "answers.jsonl")]
    assert tev.eval_pope_files(*args) == jev.eval_pope_files(*args)

    opts = ["A", "B", "C", "D", "E"]
    for t in ("B", "C. because physics", "I think The answer is D.",
              "no idea", "The answer is A. The answer is B."):
        assert tev.parse_sqa_answer(t, opts) == jev.parse_sqa_answer(t, opts)
    problems = {"p1": {"choices": ["x", "y"], "answer": 1},
                "p2": {"choices": ["x", "y", "z"], "answer": 0},
                "p3": {"choices": ["x", "y"], "answer": 0}}
    preds = {"p1": {"text": "B", "prompt": "<image>\nwhich?"},
             "p2": {"text": "The answer is C.", "prompt": "which?"}}
    assert tev.eval_science_qa(preds, problems, ["p1", "p2", "p3"], opts) \
        == jev.eval_science_qa(preds, problems, ["p1", "p2", "p3"], opts)
    # the CLIs print the same report and write the same files
    base = tmp_path / "sqa"
    base.mkdir()
    json.dump({"test": ["p1", "p2", "p3"]}, open(base / "pid_splits.json",
                                                 "w"))
    json.dump(problems, open(base / "problems.json", "w"))
    with open(tmp_path / "sqa.jsonl", "w") as f:
        for k, v in preds.items():
            f.write(json.dumps({"question_id": k, **v}) + "\n")
    printed, written = {}, {}
    for pkg, mod in (("jax", jev), ("port", tev)):
        mod.main(["pope", "--annotation-dir", str(ann), "--question-file",
                  args[1], "--result-file", args[2]])
        mod.main(["scienceqa", "--base-dir", str(base), "--result-file",
                  str(tmp_path / "sqa.jsonl"), "--output-file",
                  str(tmp_path / f"{pkg}_o.json"), "--output-result",
                  str(tmp_path / f"{pkg}_r.json")])
        printed[pkg] = capsys.readouterr().out
        written[pkg] = [(tmp_path / f"{pkg}_{x}.json").read_text()
                        for x in ("o", "r")]
    assert printed["port"] == printed["jax"] and "F1 score" in printed["jax"]
    assert written["port"] == written["jax"]


def test_eval_qa_equals_jax(tmp_path):
    from microscopiq_tpu.vlm.evaluators import eval_qa as j_qa
    from microscopiq_tpu_torch.vlm.evaluators import eval_qa

    questions = [{"question_id": i, "text": f"q{i}", "category": "misc"}
                 for i in range(3)]
    got = {}
    for pkg, fn in (("jax", j_qa), ("port", eval_qa)):
        seen = []

        def fake(prompt, seen=seen):
            seen.append(prompt)
            return f" answer to {len(seen)} "
        recs = fn(questions, fake, str(tmp_path / f"{pkg}.jsonl"))
        got[pkg] = (seen, _strip_ids(recs))
        assert all(len(r["answer_id"]) == 22 for r in recs)
    assert got["port"] == got["jax"]


def test_textvqa_equals_jax(tmp_path):
    from microscopiq_tpu.vlm import textvqa as jtv
    from microscopiq_tpu_torch.vlm import textvqa as ttv

    jp, tp = jtv.EvalAIAnswerProcessor(), ttv.EvalAIAnswerProcessor()
    for s in ("The Cat, isn't here?", "one hundred, two", "youd think so",
              "1,000 dollars", "(yes) [no]; \"maybe\"", "3.5 meters",
              "Im  an\tA   dog's", "ten; two-three / x"):
        assert tp(s) == jp(s)
    entries = [{"pred_answer": "cat",
                "gt_answers": ["cat", "cat", "cat"] + ["dog"] * 7},
               {"pred_answer": "A dog.", "gt_answers": ["dog"] * 10},
               {"pred_answer": "bird", "gt_answers": ["cat"] * 10}]
    for tcls, jcls in ((ttv.TextVQAAccuracyEvaluator,
                        jtv.TextVQAAccuracyEvaluator),
                       (ttv.STVQAAccuracyEvaluator,
                        jtv.STVQAAccuracyEvaluator),
                       (ttv.STVQAANLSEvaluator, jtv.STVQAANLSEvaluator)):
        assert tcls().eval_pred_list(entries) == \
            jcls().eval_pred_list(entries)
    for p in ("OCR tokens: a b Question: What is it? Short answer:",
              "What?\nReference OCR token: x\nanswer",
              "Reference OCR token: x\nWhy?\nanswer",
              "What color?\nShort answer:"):
        assert ttv.prompt_processor(p) == jtv.prompt_processor(p)
    ann = {"data": [{"image_id": "q1", "question": "What color?",
                     "answers": ["red"] * 10},
                    {"image_id": "q2", "question": "Which?",
                     "answers": ["a"] * 4 + ["b"] * 6}]}
    with open(tmp_path / "ann.json", "w") as f:
        json.dump(ann, f)
    with open(tmp_path / "res.jsonl", "w") as f:
        for qid, q, t in (("q1", "What color?", "Red."), ("q2", "Which?",
                                                         "a")):
            f.write(json.dumps({"question_id": qid,
                                "prompt": f"{q}\nShort answer:",
                                "text": t}) + "\n")
    args = (str(tmp_path / "ann.json"), str(tmp_path / "res.jsonl"))
    assert ttv.eval_textvqa_files(*args) == jtv.eval_textvqa_files(*args)


def test_gpt_review_equals_jax(tmp_path, capsys):
    from microscopiq_tpu.vlm import gpt_review as jgr
    from microscopiq_tpu_torch.vlm import gpt_review as tgr

    for s in ("8 6\nGood detail.", "7, 9\nok", "no scores here at all",
              "", "1 2 3"):
        assert tgr.parse_score(s) == jgr.parse_score(s)
    rule = {"role": "Assistant", "prompt": "Rate both answers."}
    ctx = {"captions": ["a cat"],
           "instances": [{"category": "cat", "bbox": [1, 2, 3, 4]}]}
    for c in (None, ctx):
        assert tgr.build_review_content(
            {"text": "Q?"}, {"text": "A1"}, {"text": "A2"}, rule, c) == \
            jgr.build_review_content(
                {"text": "Q?"}, {"text": "A1"}, {"text": "A2"}, rule, c)

    def write_jsonl(path, recs):
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")

    write_jsonl(tmp_path / "q.jsonl",
                [{"question_id": i, "text": f"q{i}", "image": f"im{i % 2}",
                  "category": ("conv", "detail")[i % 2]} for i in range(4)])
    write_jsonl(tmp_path / "a1.jsonl",
                [{"question_id": i, "answer_id": f"x{i}", "text": "one"}
                 for i in range(4)])
    write_jsonl(tmp_path / "a2.jsonl",
                [{"question_id": i, "answer_id": f"y{i}", "text": "two"}
                 for i in range(4)])
    write_jsonl(tmp_path / "ctx.jsonl",
                [{"image": f"im{i}", **ctx} for i in range(2)])
    with open(tmp_path / "rule.json", "w") as f:
        json.dump({"conv": rule, "detail": rule, "default": rule}, f)

    def judge(content, max_tokens):
        n = len(content)
        return f"{n % 7 + 1} {n % 5 + 2}\nok"

    out = {}
    for pkg, mod in (("jax", jgr), ("port", tgr)):
        revs = []
        for ctx_file in (None, str(tmp_path / "ctx.jsonl")):
            revs.append(mod.review_files(
                str(tmp_path / "q.jsonl"),
                [str(tmp_path / "a1.jsonl"), str(tmp_path / "a2.jsonl")],
                str(tmp_path / "rule.json"),
                str(tmp_path / f"{pkg}_out.jsonl"), judge_fn=judge,
                context_file=ctx_file))
        f = str(tmp_path / f"gpt4_text_{pkg}.jsonl")
        write_jsonl(f, revs[0])
        out[pkg] = (revs, mod.summarize_reviews(revs[0] + revs[1]),
                    list(mod.summarize_files([f]).values()))
        mod.main(["summarize", "-f", f])
        out[pkg] += (capsys.readouterr().out.replace(pkg, ""),)
    assert out["port"] == out["jax"]
    # the command judge pipes the content through a subprocess
    import sys
    echo = tgr.make_command_judge(
        [sys.executable, "-c", "import sys; print('3 4'); "
         "sys.stdin.read()"])
    assert tgr.parse_score(echo("content", 16)) == [3.0, 4.0]


def _jax_checkpoint(tmp_path):
    from microscopiq_tpu.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(0)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    base = {"model": {"embed_tokens": r(10, 4),
                      "layers_0": {"mlp": {"kernel": r(4, 4)}}},
            "lm_head": {"kernel": r(4, 10)}}
    target = {"model": {"embed_tokens": r(12, 4),        # vocab grown
                        "layers_0": {"mlp": {"kernel": r(4, 4)}},
                        "mm_projector": {"kernel": r(4, 4)}},
              "lm_head": {"kernel": r(4, 12)}}
    for name, tree in (("base", base), ("target", target)):
        save_checkpoint(str(tmp_path / name),
                        {k: jnp.asarray(v) if not isinstance(v, dict)
                         else v for k, v in tree.items()})
    return base, target


def test_delta_cli_roundtrips_jax_checkpoints(tmp_path):
    """JAX saves, the port's CLI makes and applies on the CPU, JAX loads:
    equal to JAX's own make_delta / apply_delta (vocabulary growth and
    delta-only keys included)."""
    from microscopiq_tpu.utils.checkpoint import (apply_delta,
                                                  load_checkpoint,
                                                  make_delta)
    from microscopiq_tpu_torch.vlm.delta import main as delta_main

    base, target = _jax_checkpoint(tmp_path)
    d = str(tmp_path)
    delta_main(["make", "--device", "cpu", "--base", d + "/base",
                "--target", d + "/target", "--delta", d + "/delta"])
    want = make_delta(load_checkpoint(d + "/base"),
                      load_checkpoint(d + "/target"))
    got = load_checkpoint(d + "/delta")
    assert [p for p, _ in leaves(got)] == [p for p, _ in leaves(want)]
    for (p, a), (_, b) in zip(leaves(got), leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    delta_main(["apply", "--device", "cpu", "--base", d + "/base",
                "--delta", d + "/delta", "--target", d + "/target2"])
    back = load_checkpoint(d + "/target2")
    want = apply_delta(load_checkpoint(d + "/base"),
                       load_checkpoint(d + "/delta"))
    for (p, a), (_, b) in zip(leaves(back), leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(np.asarray(back["model"]["embed_tokens"]),
                               target["model"]["embed_tokens"], atol=1e-6)
    delta_main(["consolidate", "--device", "cpu", "--src", d + "/target2",
                "--dst", d + "/target3"])
    for (p, a), (_, b) in zip(leaves(load_checkpoint(d + "/target3")),
                              leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jax_probe_script():
    spec = importlib.util.spec_from_file_location(
        "jax_vlm_probe", REPO / "scripts" / "vlm_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vlm_probe_runs_on_the_cpu_with_the_jax_script_s_task():
    from microscopiq_tpu_torch.scripts import vlm_probe

    j = _jax_probe_script()
    for a, b in zip(j.build_batch(np.random.default_rng(3), j.TASK_VOCAB,
                                  4, 8),
                    vlm_probe.build_batch(np.random.default_rng(3),
                                          vlm_probe.TASK_VOCAB, 4, 8)):
        np.testing.assert_array_equal(a, b)
    assert (j.VOCAB, j.TASK_VOCAB, j.NCELL) == (
        vlm_probe.VOCAB, vlm_probe.TASK_VOCAB, vlm_probe.NCELL)
    rec = vlm_probe.main(device="cpu", steps=3)
    assert set(rec["results"]) == {
        "dense", "packed_fp6_weights", "KIVI-4bit", "KIVI-2bit",
        "GEARL-2bit-r4", "packed_fp6+KIVI-4bit"}
    assert set(rec["ordering_checks"]) == {
        "dense_learned", "fp6_weights_lossless", "4bit_beats_2bit",
        "gear_corrects_2bit", "separation"}
    assert rec["train_steps"] == 3 and np.isfinite(rec["final_loss"])
    assert all(0 <= r["accuracy"] <= 1 for r in rec["results"].values())


def test_mm_utils_are_bit_exact_with_jax():
    """The port's copy of the host utilities gives JAX's arrays bit for
    bit: process_images (expand2square, the bilinear resize, the CLIP
    normalization), tokenizer_image_token, expand_image_tokens (left pad,
    ValueError past pad_to), split_list, get_chunk and
    get_model_name_from_path."""
    from microscopiq_tpu.vlm import mm_utils as jmm
    from microscopiq_tpu_torch.serve.stack import Crc32Tok
    from microscopiq_tpu_torch.vlm import mm_utils as tmm

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (20, 12, 3), dtype=np.uint8),
              rng.integers(0, 256, (9, 31, 3), dtype=np.uint8),
              rng.uniform(0, 1, (16, 16, 3)).astype(np.float32),
              rng.uniform(0, 255, (48, 40, 3))]
    for aspect in ("pad", "resize"):
        for size in (16, 33):
            got = tmm.process_images(images, size, aspect)
            want = jmm.process_images(images, size, aspect)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tmm.expand2square(images[1], tmm.CLIP_MEAN),
        jmm.expand2square(images[1], jmm.CLIP_MEAN))
    prompt = "hi <image> there <image>\nagain"
    for tok in (FakeTokenizer(), Crc32Tok(300)):
        ids = tmm.tokenizer_image_token(prompt, tok)
        assert ids == jmm.tokenizer_image_token(prompt, tok)
        assert ids.count(vlm.IMAGE_TOKEN_INDEX) == 2
        for pad in (None, len(ids) + 9):
            for a, b in zip(tmm.expand_image_tokens(ids, 4, pad, pad_id=7),
                            jmm.expand_image_tokens(ids, 4, pad, pad_id=7)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="pad_to"):
            tmm.expand_image_tokens(ids, 4, pad_to=3)
    lst = list(range(11))
    for n in (1, 2, 3, 4, 11):
        assert tmm.split_list(lst, n) == jmm.split_list(lst, n)
        for k in range(len(jmm.split_list(lst, n))):
            assert tmm.get_chunk(lst, n, k) == jmm.get_chunk(lst, n, k)
    for path in ("liuhaotian/llava-v1.5-7b", "/ckpt/run/checkpoint-200/",
                 "model"):
        assert tmm.get_model_name_from_path(path) == \
            jmm.get_model_name_from_path(path)
