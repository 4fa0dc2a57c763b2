"""One-command serving stack: controller + engine-backed worker + web chat
UI + OpenAI-compatible API, on a tiny model with seeded random weights.

Counterpart of ``examples/serve_stack.py``:

    controller (registry/heartbeat/dispatch)
      └─ worker (continuous-batching engine, streams NUL-delimited JSON)
           ├─ web UI      http://127.0.0.1:7860
           └─ OpenAI API  http://127.0.0.1:8000/v1

Run: python -m microscopiq_tpu_torch.serve.stack [--packed] [--device cpu]
Then:  curl http://127.0.0.1:8000/v1/models
       curl -X POST http://127.0.0.1:8000/v1/completions \\
            -d '{"model": "tiny-llama", "prompt": "1 2 3", "max_tokens": 8}'

The stand-in tokenizer maps a word to ``zlib.crc32`` of its bytes, so that
two processes give a word the same id (Python's ``hash`` of a string is
salted per process).
"""

from __future__ import annotations

import argparse
import threading
import zlib


class Crc32Tok:
    """Stand-in tokenizer (real runs pass a HF tokenizer): id 2 opens a
    prompt, a word is ``2 + crc32(word) % (vocab - 3)``, ids decode to
    ``<id>`` words."""

    eos_token_id = 1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, s):
        return [2] + [2 + zlib.crc32(w.encode()) % (self.vocab_size - 3)
                      for w in s.split()]

    def decode(self, ids):
        return " ".join(f"<{i}>" for i in ids)


def start_stack(model, tokenizer, model_name: str = "tiny-llama",
                host: str = "127.0.0.1", ports=(0, 0, 0, 0),
                n_slots: int = 4, max_len: int = 256, log_dir: str = ".",
                **engine_kw):
    """Start the controller, an engine-backed worker serving
    ``model_name``, the web server and the OpenAI gateway, each on a daemon
    thread (port 0: any free port). Returns a dict of the four servers,
    ``"urls"`` and ``"engine"``; :func:`stop_stack` ends them."""
    from .controller import serve_controller
    from .engine import BatchEngine, engine_generate_stream_fn
    from .openai_api import serve_openai
    from .web_server import serve_web
    from .worker import ModelWorker, serve_worker

    engine = BatchEngine(model, n_slots=n_slots, max_len=max_len,
                         device=model.device, **engine_kw)
    gen = engine_generate_stream_fn(engine, tokenizer)
    ctrl_srv = serve_controller(host, ports[0])
    threading.Thread(target=ctrl_srv.serve_forever, daemon=True).start()
    ctrl = f"http://{host}:{ctrl_srv.server_address[1]}"
    w_srv = serve_worker(ModelWorker(ctrl, "PENDING", [model_name], gen,
                                     register=False), host, ports[1])
    w_srv.worker.worker_addr = f"http://{host}:{w_srv.server_address[1]}"
    threading.Thread(target=w_srv.serve_forever, daemon=True).start()
    w_srv.worker.register_to_controller()
    web = serve_web(ctrl, host, ports[2], log_dir=log_dir)
    threading.Thread(target=web.serve_forever, daemon=True).start()
    oai = serve_openai(ctrl, host, ports[3])
    threading.Thread(target=oai.serve_forever, daemon=True).start()
    return {"controller": ctrl_srv, "worker": w_srv, "web": web,
            "openai": oai, "engine": engine,
            "urls": {"controller": ctrl, "worker": w_srv.worker.worker_addr,
                     "web": f"http://{host}:{web.server_address[1]}",
                     "openai": f"http://{host}:{oai.server_address[1]}"}}


def stop_stack(stack) -> None:
    """Shut down and close every server of :func:`start_stack`."""
    for key in ("openai", "web", "worker", "controller"):
        srv = stack[key]
        srv.shutdown()
        srv.server_close()
    stack["worker"].worker.shutdown()
    stack["controller"].controller.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--packed", action="store_true",
                    help="serve MX-FP6 packed weights through the kernels")
    ap.add_argument("--port-base", type=int, default=21001)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..models import LlamaConfig, LlamaForCausalLM, build_params

    cfg = LlamaConfig.tiny()
    params = build_params(cfg, seed=0, device=args.device)
    if args.packed:
        from ..nn import pack_params
        from ..specs import finalize_mx_specs

        specs = finalize_mx_specs({"w_elem_format": "fp6_e3m2",
                                   "scale_bits": 8, "block_size": 32})
        params = {"params": pack_params(params["params"], specs)}
    model = LlamaForCausalLM(cfg, device=args.device).load_params(params)
    base = args.port_base
    stack = start_stack(model, Crc32Tok(cfg.vocab_size),
                        ports=(base, base + 1, 7860, 8000))
    urls = stack["urls"]
    print(f"controller  {urls['controller']}\n"
          f"worker      {urls['worker']}\n"
          f"web UI      {urls['web']}\n"
          f"openai API  {urls['openai']}/v1  (Ctrl-C to stop)", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        stop_stack(stack)


if __name__ == "__main__":
    main()
