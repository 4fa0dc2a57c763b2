"""The port's generation evals (``eval/gsm8k.py``, ``eval/cot_tasks.py``):
every test of tests/test_gsm8k.py against the port; the synthetic rows
equal to JAX's; and both packages' ``evaluate_gsm8k`` and
``evaluate_cot_task``, each over its own engine on the same tiny weights
and the same local ``gsm8k.jsonl``/``bbh.jsonl``, giving equal records
(the ``seconds`` excepted)."""

import numpy as np
import pytest
import torch

from microscopiq_tpu_torch.eval.gsm8k import (
    evaluate_gsm8k,
    extract_answer_gt,
    extract_answer_pred,
    is_correct,
    load_gsm8k,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread a core makes the workers' training and
    matmuls contend for the cores (a 10x slowdown inside the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_extract_gt():
    assert extract_answer_gt("blah blah #### 42") == "42"
    assert extract_answer_gt("#### 1,234") == "1234"
    assert extract_answer_gt("no answer") == "[invalid]"


def test_extract_pred():
    assert extract_answer_pred("so 3 + 5 = 8. The answer is 8.") == "8"
    assert extract_answer_pred("costs $1,250 total") == "1250"
    assert extract_answer_pred("nothing numeric") == "[invalid]"


def test_is_correct():
    assert is_correct("8", "8")
    assert is_correct("8.0", "8")
    assert not is_correct("7", "8")
    assert not is_correct("[invalid]", "8")


def test_evaluate_with_oracle(tmp_path):
    rows = load_gsm8k(16)

    def oracle(prompts):
        outs = []
        for p in prompts:
            q = p.split("Question: ")[-1]
            row = next(r for r in rows if r["question"] in q)
            outs.append(row["answer"].split("####")[0] +
                        "The answer is " +
                        extract_answer_gt(row["answer"]) + ".")
        return outs

    res = evaluate_gsm8k(oracle, limit=16, batch_size=4,
                         output_dir=str(tmp_path))
    assert res["accuracy"] == 1.0
    assert (tmp_path / "evaluation_gsm8k.json").exists()
    assert (tmp_path / "generations.jsonl").exists()


def test_evaluate_with_bad_generator():
    res = evaluate_gsm8k(lambda ps: ["i do not know"] * len(ps), limit=8)
    assert res["accuracy"] == 0.0


# ---------------------------------------------------------------------------
# BBH / MMLU / AQuA CoT evaluators (absent from the reference's repo —
# its scripts reference them; we supply working ones, eval/cot_tasks.py)
# ---------------------------------------------------------------------------
def test_cot_task_extract_choice():
    from microscopiq_tpu_torch.eval.cot_tasks import extract_choice
    assert extract_choice("blah. The answer is (B).") == "B"
    assert extract_choice("answer: C") == "C"
    assert extract_choice("The answer is (a)") == "A"
    assert extract_choice("no answer here") == "[invalid]"
    # last answer wins (CoT often restates)
    assert extract_choice("The answer is (A). Wait, the answer is (D).") \
        == "D"


def test_cot_task_eval_oracle(tmp_path):
    """An oracle generator that reads the right option scores 100%."""
    import re as _re

    from microscopiq_tpu_torch.eval.cot_tasks import (evaluate_cot_task,
                                                load_task)

    for task in ("bbh", "mmlu", "aqua"):
        rows = load_task(task, limit=8)
        lookup = {r["question"]: r["answer"] for r in rows}

        def oracle(prompts):
            outs = []
            for p in prompts:
                q = p.split("Question: ")[-1].split(
                    "\nLet's think")[0]
                outs.append(f"The answer is ({lookup[q]}).")
            return outs

        res = evaluate_cot_task(task, oracle, limit=8,
                                output_dir=str(tmp_path))
        assert res["accuracy"] == 1.0, (task, res)
        assert (tmp_path / f"evaluation_{task}.json").exists()


def test_cot_task_eval_wrong_answers():
    from microscopiq_tpu_torch.eval.cot_tasks import evaluate_cot_task
    res = evaluate_cot_task("mmlu", lambda ps: ["The answer is (E)."
                                                for _ in ps], limit=8)
    assert res["accuracy"] == 0.0


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------
def test_synthetic_rows_equal_jax():
    from microscopiq_tpu.eval import cot_tasks as jcot
    from microscopiq_tpu.eval import gsm8k as jg
    from microscopiq_tpu_torch.eval import cot_tasks as tcot
    from microscopiq_tpu_torch.eval import gsm8k as tg

    assert tg.load_gsm8k(40) == jg.load_gsm8k(40)
    assert tg.COT_PROMPT == jg.COT_PROMPT
    for task in ("bbh", "mmlu", "aqua"):
        assert tcot.load_task(task, 12) == jcot.load_task(task, 12)
        assert tcot._TASKS[task] == jcot._TASKS[task]


def _engines():
    """(JAX engine, port engine) on the same N(0, 1/K) tiny Llama."""
    import jax.numpy as jnp

    from microscopiq_tpu.models import LlamaConfig as JConfig
    from microscopiq_tpu.models import LlamaForCausalLM as JModel
    from microscopiq_tpu.serve.engine import BatchEngine as JEngine
    from microscopiq_tpu_torch.convert import params_from_jax
    from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from microscopiq_tpu_torch.serve.engine import BatchEngine

    rng = np.random.default_rng(0)
    cfg = JConfig.tiny()
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def k(shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])
                ).astype(np.float32)

    m = {"embed_tokens": rng.standard_normal((V, D)).astype(np.float32),
         "norm": {"scale": np.ones(D, np.float32)}}
    for i in range(cfg.num_hidden_layers):
        m[f"layers_{i}"] = {
            "self_attn": {n: {"kernel": k((D, w))} for n, w in
                          (("q_proj", H * hd), ("k_proj", KVH * hd),
                           ("v_proj", KVH * hd))},
            "mlp": {"gate_proj": {"kernel": k((D, I))},
                    "up_proj": {"kernel": k((D, I))},
                    "down_proj": {"kernel": k((I, D))}},
            "input_layernorm": {"scale": np.ones(D, np.float32)},
            "post_attention_layernorm": {"scale": np.ones(D, np.float32)}}
        m[f"layers_{i}"]["self_attn"]["o_proj"] = {"kernel": k((H * hd, D))}
    tree = {"model": m, "lm_head": {"kernel": k((D, V))}}

    def jtree(t):
        return ({a: jtree(b) for a, b in t.items()} if isinstance(t, dict)
                else jnp.asarray(t))

    kw = dict(n_slots=4, max_len=256, prompt_buckets=(64, 128, 192))
    je = JEngine(JModel(cfg, use_pallas=False), {"params": jtree(tree)},
                 **kw)
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").load_params(
        params_from_jax(tree, device="cpu"))
    return je, BatchEngine(tm, device="cpu", **kw)


class _Tok:
    """Byte-level stand-in tokenizer over a 256-token vocabulary."""

    def encode(self, s):
        return list(s.encode())[-150:]

    def decode(self, ids):
        return bytes(int(i) for i in ids).decode("latin-1")


def test_evals_over_both_engines_give_equal_records(tmp_path, monkeypatch):
    import json

    from microscopiq_tpu.eval import cot_tasks as jcot
    from microscopiq_tpu.eval import gsm8k as jg
    from microscopiq_tpu_torch.eval import cot_tasks as tcot
    from microscopiq_tpu_torch.eval import gsm8k as tg

    rows = [{"question": f"Sam has {a} pens and gets {b}. How many?",
             "answer": f"{a} + {b} = {a + b}. #### {a + b}"}
            for a, b in ((3, 4), (10, 7), (21, 5), (8, 8), (2, 9))]
    with open(tmp_path / "gsm8k.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    with open(tmp_path / "bbh.jsonl", "w") as f:
        for i in range(3):
            f.write(json.dumps({"question": f"Is {i} even? Options: (A) yes"
                                " (B) no", "answer": "AB"[i % 2]}) + "\n")
    # the JAX modules bind DATA_DIR at import; the port reads the variable
    # when the eval runs
    monkeypatch.setattr(jg, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jcot, "DATA_DIR", str(tmp_path))
    monkeypatch.setenv("MICROSCOPIQ_DATA_DIR", str(tmp_path))
    assert tg.load_gsm8k() == jg.load_gsm8k() == rows

    je, te = _engines()
    out = []
    for g, cot, eng in ((jg, jcot, je), (tg, tcot, te)):
        fn = g.engine_generate_fn(eng, _Tok(), max_new_tokens=12)
        res = {}
        for name, run in (("gsm8k", lambda d: g.evaluate_gsm8k(
                fn, limit=5, batch_size=3, output_dir=d)),
                ("bbh", lambda d: cot.evaluate_cot_task(
                    "bbh", fn, limit=3, output_dir=d)),
                ("mmlu", lambda d: cot.evaluate_cot_task(
                    "mmlu", fn, limit=4, output_dir=d))):
            d = tmp_path / f"{g.__name__.split('.')[0]}_{name}"
            r = run(str(d))
            r.pop("seconds")
            gen = "generations.jsonl" if name == "gsm8k" else \
                f"generations_{name}.jsonl"
            res[name] = (r, (d / gen).read_text())
        out.append(res)
    assert out[0] == out[1]
    assert out[1]["bbh"][0]["n"] == 3 and out[1]["mmlu"][0]["n"] == 4
