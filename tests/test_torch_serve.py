"""The port's serving stack (``microscopiq_tpu_torch/serve``): every test
of tests/test_serve.py against the port's controller, workers, client
utilities, web server and OpenAI gateway over real loopback HTTP; the
lottery dispatch against JAX's under one numpy seed; then both packages'
full stacks, each over its own engine (and its own decode loop) on the
same converted tiny weights, answering the same requests with the same
texts (ids and timestamps excepted)."""

import json
import threading
import time
import urllib.request

import pytest
import torch

from microscopiq_tpu_torch.serve.controller import serve_controller
from microscopiq_tpu_torch.serve.worker import ModelWorker, serve_worker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread a core makes the workers' training and
    matmuls contend for the cores (a 10x slowdown inside the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _post(url, payload, timeout=5):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def stack():
    ctrl_srv = serve_controller("127.0.0.1", 0)
    ctrl_port = ctrl_srv.server_address[1]
    threading.Thread(target=ctrl_srv.serve_forever, daemon=True).start()
    ctrl = f"http://127.0.0.1:{ctrl_port}"

    def gen(prompt, max_new_tokens, temperature):
        for i in range(3):
            yield f"{prompt}|tok{i}"

    workers = []
    for _ in range(2):
        w_srv = serve_worker(
            ModelWorker(ctrl, "PENDING", ["test-model"], gen,
                        register=False), "127.0.0.1", 0)
        port = w_srv.server_address[1]
        w_srv.worker.worker_addr = f"http://127.0.0.1:{port}"
        threading.Thread(target=w_srv.serve_forever, daemon=True).start()
        w_srv.worker.register_to_controller()
        workers.append(w_srv)
    yield ctrl, workers
    ctrl_srv.shutdown()
    for w in workers:
        w.shutdown()


def test_register_and_list(stack):
    ctrl, _ = stack
    models = _post(ctrl + "/list_models", {})["models"]
    assert models == ["test-model"]


def test_dispatch_and_generate(stack):
    ctrl, workers = stack
    addr = _post(ctrl + "/get_worker_address", {"model": "test-model"})
    assert addr["address"].startswith("http://127.0.0.1:")
    req = urllib.request.Request(
        addr["address"] + "/worker_generate_stream",
        data=json.dumps({"prompt": "hi", "max_new_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        chunks = [json.loads(c) for c in r.read().split(b"\0") if c]
    assert chunks[-1]["text"] == "hi|tok2"
    assert all(c["error_code"] == 0 for c in chunks)


def test_shortest_queue_balances(stack):
    ctrl, _ = stack
    addrs = {_post(ctrl + "/get_worker_address",
                   {"model": "test-model"})["address"] for _ in range(6)}
    assert len(addrs) == 2  # both workers get traffic


def test_heartbeat(stack):
    ctrl, workers = stack
    w = workers[0].worker
    r = _post(ctrl + "/receive_heart_beat",
              {"worker_name": w.worker_addr, "queue_length": 3})
    assert r["exist"]
    r = _post(ctrl + "/receive_heart_beat",
              {"worker_name": "http://nope", "queue_length": 0})
    assert not r["exist"]


def test_unknown_model(stack):
    ctrl, _ = stack
    addr = _post(ctrl + "/get_worker_address", {"model": "missing"})
    assert addr["address"] == ""


# ---------------------------------------------------------------------------
# Client utilities (serve/cli.py): register / test_message / chat loop
# ---------------------------------------------------------------------------
def test_cli_register_and_list(stack):
    from microscopiq_tpu_torch.serve import cli

    ctrl, workers = stack
    addr = workers[0].worker.worker_addr
    assert cli.register_worker(ctrl, addr)["success"] is True
    assert cli.list_models(ctrl) == ["test-model"]
    assert cli.get_worker(ctrl, "test-model").startswith("http://")


def test_cli_test_message(stack):
    import io

    from microscopiq_tpu_torch.serve import cli

    ctrl, _ = stack
    out = io.StringIO()
    text = cli.test_message(ctrl, message="hi", max_new_tokens=8, out=out)
    assert text == "hi|tok2"            # fixture streams 3 chunks
    assert "hi|tok0" in out.getvalue()


def test_cli_chat_loop_streams(stack):
    import io

    from microscopiq_tpu_torch.serve import cli

    ctrl, _ = stack
    out = io.StringIO()
    cli.chat_loop(ctrl, model="test-model", max_new_tokens=4,
                  stdin=io.StringIO("hello\n"), stdout=out)
    assert "hello|tok2" in out.getvalue()


# ---------------------------------------------------------------------------
# Web chat front-end (serve/web_server.py, gradio_web_server.py parity)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def web(stack, tmp_path_factory):
    from microscopiq_tpu_torch.serve.web_server import serve_web

    ctrl, _ = stack
    log_dir = tmp_path_factory.mktemp("convlog")
    srv = serve_web(ctrl, "127.0.0.1", 0, str(log_dir))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv.app
    srv.shutdown()


def test_web_page_and_models(web):
    url, app = web
    with urllib.request.urlopen(url + "/", timeout=5) as r:
        page = r.read().decode()
    assert "microscopiq_tpu chat" in page and "/api/chat" in page
    models = _post(url + "/api/models", {})["models"]
    assert models == ["test-model"]


def test_web_chat_streams_and_logs(web):
    url, app = web
    req = urllib.request.Request(
        url + "/api/chat",
        data=json.dumps({"model": "test-model",
                         "messages": [{"role": "user",
                                       "content": "hello"}],
                         "max_new_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        lines = [json.loads(l) for l in r.read().splitlines() if l]
    # cumulative texts; prompt was built through the conv template
    assert len(lines) == 3
    assert lines[-1]["text"].endswith("|tok2")
    assert "USER: hello" in lines[-1]["text"]
    # conv log written (vote_last_response / chat logging parity)
    with open(app.conv_log_filename()) as f:
        recs = [json.loads(l) for l in f]
    assert recs[-1]["type"] == "chat" and recs[-1]["model"] == "test-model"


def test_web_vote_logged(web):
    url, app = web
    r = _post(url + "/api/vote", {"type": "upvote", "model": "test-model",
                                  "state": [{"role": "user",
                                             "content": "x"}]})
    assert r["ok"]
    with open(app.conv_log_filename()) as f:
        recs = [json.loads(l) for l in f]
    assert recs[-1]["type"] == "upvote" and "tstamp" in recs[-1]


def test_web_unknown_model_yields_error(web):
    url, _ = web
    req = urllib.request.Request(
        url + "/api/chat",
        data=json.dumps({"model": "missing",
                         "messages": [{"role": "user",
                                       "content": "x"}]}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        lines = [json.loads(l) for l in r.read().splitlines() if l]
    assert "error" in lines[0]


# ---------------------------------------------------------------------------
# OpenAI-compatible gateway (serve/openai_api.py, sglang_worker parity)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def oai(stack):
    from microscopiq_tpu_torch.serve.openai_api import serve_openai

    ctrl, _ = stack

    # a worker whose stream is truly cumulative (append-only), like the
    # real engine's generate_stream_fn
    def cum_gen(prompt, max_new_tokens, temperature):
        text = ""
        for i in range(3):
            text += f" w{i}"
            yield text

    w_srv = serve_worker(ModelWorker(ctrl, "PENDING", ["cum-model"],
                                     cum_gen, register=False),
                         "127.0.0.1", 0)
    w_srv.worker.worker_addr = \
        f"http://127.0.0.1:{w_srv.server_address[1]}"
    threading.Thread(target=w_srv.serve_forever, daemon=True).start()
    w_srv.worker.register_to_controller()

    srv = serve_openai(ctrl, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    w_srv.shutdown()


def test_openai_models(oai):
    with urllib.request.urlopen(oai + "/v1/models", timeout=5) as r:
        body = json.loads(r.read())
    assert body["object"] == "list"
    assert [m["id"] for m in body["data"]] == ["cum-model", "test-model"]


def test_openai_chat_completion(oai):
    body = _post(oai + "/v1/chat/completions",
                 {"model": "test-model", "max_tokens": 8,
                  "messages": [{"role": "system", "content": "Be nice."},
                               {"role": "user", "content": "hi"}]})
    assert body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert msg["role"] == "assistant"
    # the echo worker returns the prompt: system + template + user turn
    assert "Be nice." in msg["content"] and "USER: hi" in msg["content"]
    assert body["usage"]["total_tokens"] == (
        body["usage"]["prompt_tokens"] + body["usage"]["completion_tokens"])


def test_openai_text_completion(oai):
    body = _post(oai + "/v1/completions",
                 {"model": "test-model", "prompt": "raw prompt",
                  "max_tokens": 4})
    assert body["object"] == "text_completion"
    assert body["choices"][0]["text"] == "raw prompt|tok2"


def test_openai_streaming_sse(oai):
    req = urllib.request.Request(
        oai + "/v1/chat/completions",
        data=json.dumps({"model": "cum-model", "stream": True,
                         "messages": [{"role": "user",
                                       "content": "go"}]}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        raw = r.read().decode()
    events = [l[6:] for l in raw.splitlines() if l.startswith("data: ")]
    assert events[-1] == "[DONE]"
    parsed = [json.loads(e) for e in events[:-1]]
    assert parsed[0]["choices"][0]["delta"] == {"role": "assistant"}
    # deltas reassemble the cumulative worker stream
    text = "".join(p["choices"][0]["delta"].get("content", "")
                   for p in parsed)
    assert text == " w0 w1 w2"
    assert parsed[-1]["choices"][0]["finish_reason"] == "stop"


def test_openai_missing_model_404(oai):
    req = urllib.request.Request(
        oai + "/v1/chat/completions",
        data=json.dumps({"model": "missing",
                         "messages": [{"role": "user",
                                       "content": "x"}]}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        urllib.request.urlopen(req, timeout=10)
        assert False, "expected 404"
    except urllib.error.HTTPError as e:
        assert e.code == 404
        assert json.loads(e.read())["error"]["type"] == "model_not_found"


# ---------------------------------------------------------------------------
# Lottery dispatch: numpy's global state, as in JAX
# ---------------------------------------------------------------------------
def test_lottery_dispatch_picks_jax_workers_under_one_seed():
    import numpy as np

    from microscopiq_tpu.serve.controller import Controller as JController
    from microscopiq_tpu_torch.serve.controller import Controller

    picks = []
    for cls in (JController, Controller):
        c = cls("lottery")
        for i, speed in enumerate((1, 2, 3, 0.5)):
            c.register_worker(f"http://w{i}", False,
                              {"model_names": ["m"], "speed": speed})
        np.random.seed(17)
        picks.append([c.get_worker_address("m") for _ in range(40)])
        assert c.get_worker_address("none") == ""
        c.shutdown()
    assert picks[0] == picks[1]
    assert len(set(picks[1])) == 4


# ---------------------------------------------------------------------------
# Both packages' stacks over their engines on the same weights
# ---------------------------------------------------------------------------
def _numpy_tree(cfg, seed=0):
    """Unfused flax-named weights; kernels N(0, 1/K) so greedy logits are
    well separated."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KVH, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def k(shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])
                ).astype(np.float32)

    m = {"embed_tokens": rng.standard_normal((cfg.vocab_size, D)
                                             ).astype(np.float32)}
    for i in range(cfg.num_hidden_layers):
        m[f"layers_{i}"] = {
            "self_attn": {"q_proj": {"kernel": k((D, H * hd))},
                          "k_proj": {"kernel": k((D, KVH * hd))},
                          "v_proj": {"kernel": k((D, KVH * hd))},
                          "o_proj": {"kernel": k((H * hd, D))}},
            "mlp": {"gate_proj": {"kernel": k((D, I))},
                    "up_proj": {"kernel": k((D, I))},
                    "down_proj": {"kernel": k((I, D))}},
            "input_layernorm": {"scale": np.ones(D, np.float32)},
            "post_attention_layernorm": {"scale": np.ones(D, np.float32)}}
    m["norm"] = {"scale": np.ones(D, np.float32)}
    return {"model": m, "lm_head": {"kernel": k((D, cfg.vocab_size))}}


ENGINE = dict(n_slots=4, max_len=256, prompt_buckets=(32, 64, 128))


@pytest.fixture(scope="module")
def both_stacks(tmp_path_factory):
    """(JAX stack urls, port stack urls): controller, an engine-backed
    worker ("tiny") and a decode-loop worker ("tiny-loop"), web server and
    OpenAI gateway each, on the same tiny Llama weights."""
    import jax.numpy as jnp

    from microscopiq_tpu.models import LlamaConfig as JConfig
    from microscopiq_tpu.models import LlamaForCausalLM as JModel
    from microscopiq_tpu.serve import engine as jeng
    from microscopiq_tpu.serve import openai_api as joai
    from microscopiq_tpu.serve import web_server as jweb
    from microscopiq_tpu.serve import worker as jwork
    from microscopiq_tpu.serve.controller import serve_controller as jctrl
    from microscopiq_tpu_torch.convert import params_from_jax
    from microscopiq_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from microscopiq_tpu_torch.serve import stack
    from microscopiq_tpu_torch.serve.worker import torch_generate_stream_fn

    tree = _numpy_tree(JConfig.tiny())
    tok = stack.Crc32Tok(256)
    servers = []

    def up(srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}"

    def add_worker(ctrl, name, fn, mod):
        w = mod.serve_worker(mod.ModelWorker(ctrl, "PENDING", [name], fn,
                                             register=False), "127.0.0.1", 0)
        w.worker.worker_addr = up(w)
        w.worker.register_to_controller()

    # JAX
    jm = JModel(JConfig.tiny(), use_pallas=False)
    jp = {"params": {k: v for k, v in _jnp_tree(tree, jnp).items()}}
    jctrl_url = up(jctrl("127.0.0.1", 0))
    add_worker(jctrl_url, "tiny", jeng.engine_generate_stream_fn(
        jeng.BatchEngine(jm, jp, **ENGINE), tok), jwork)
    add_worker(jctrl_url, "tiny-loop", jwork.jax_generate_stream_fn(
        jm, jp, tok, cache_kind="dense"), jwork)
    log_dir = str(tmp_path_factory.mktemp("convlog"))
    j_urls = {"web": up(jweb.serve_web(jctrl_url, "127.0.0.1", 0, log_dir)),
              "openai": up(joai.serve_openai(jctrl_url, "127.0.0.1", 0)),
              "controller": jctrl_url}
    # the port
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").load_params(
        params_from_jax(tree, device="cpu"))
    st = stack.start_stack(tm, tok, "tiny", log_dir=log_dir, **ENGINE)
    from microscopiq_tpu_torch.serve import worker as twork
    add_worker(st["urls"]["controller"], "tiny-loop",
               torch_generate_stream_fn(tm, tok, cache_kind="dense"), twork)
    yield j_urls, st["urls"]
    stack.stop_stack(st)
    for srv in servers:
        srv.shutdown()


def _jnp_tree(tree, jnp):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v, jnp) for k, v in tree.items()}
    return jnp.asarray(tree)


def _sse_text(url, body):
    req = urllib.request.Request(
        url + "/v1/chat/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    events = [json.loads(l[6:]) for l in raw.splitlines()
              if l.startswith("data: ") and l != "data: [DONE]"]
    return "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events)


def _web_text(url, body):
    req = urllib.request.Request(
        url + "/api/chat", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return [json.loads(l) for l in r.read().splitlines() if l][-1]


@pytest.mark.parametrize("model", ["tiny", "tiny-loop"])
def test_both_stacks_answer_the_same_texts(both_stacks, model):
    import io

    from microscopiq_tpu.serve import cli as jcli
    from microscopiq_tpu_torch.serve import cli as tcli

    j_urls, t_urls = both_stacks
    chat = {"model": model, "max_tokens": 8, "temperature": 0.0,
            "messages": [{"role": "system", "content": "Be nice."},
                         {"role": "user", "content": "count from one to "
                          "ten in words please"}]}
    text = {"model": model, "prompt": "1 2 3 4 5 6", "max_tokens": 6,
            "temperature": 0.0}
    web = {"model": model, "temperature": 0.0, "max_new_tokens": 5,
           "messages": [{"role": "user", "content": "hello there"}]}
    got = []
    # the first requests compile the JAX stack's steps: the same 120 s
    # deadline as the streamed requests below
    for urls, cli in ((j_urls, jcli), (t_urls, tcli)):
        c = _post(urls["openai"] + "/v1/chat/completions", chat, 120)
        t = _post(urls["openai"] + "/v1/completions", text, 120)
        got.append({
            "chat": c["choices"][0]["message"]["content"],
            "chat_usage": c["usage"], "chat_object": c["object"],
            "text": t["choices"][0]["text"], "text_usage": t["usage"],
            "sse": _sse_text(urls["openai"], chat),
            "web": _web_text(urls["web"], web),
            "cli": cli.test_message(urls["controller"], model,
                                    "tell me a story", 7,
                                    out=io.StringIO())})
    assert got[0] == got[1]
    assert got[1]["chat"].count("<") == 8          # 8 tokens, decoded
    assert got[1]["sse"] == got[1]["chat"]
