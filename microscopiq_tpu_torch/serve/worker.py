"""Model worker: registers with the controller, heartbeats, and serves
semaphore-limited streaming generation.

Own copy of ``microscopiq_tpu/serve/worker.py`` (standard library only):
register on start, heartbeat thread with re-register on miss,
``/worker_get_status``, ``/worker_generate_stream`` (a stream of
NUL-delimited JSON frames), concurrency limited by a semaphore. Its
generate hook over the port's decode loop is :func:`torch_generate_stream_fn`
(the JAX package's ``jax_generate_stream_fn``); the engine's is
``serve/engine.py::engine_generate_stream_fn``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

WORKER_HEART_BEAT_INTERVAL = 15

logger = logging.getLogger("microscopiq.worker")


class ModelWorker:
    """Wraps a generate function behind the worker protocol.

    generate_stream_fn(prompt, max_new_tokens, temperature) must yield
    partial text strings.
    """

    def __init__(self, controller_addr: str, worker_addr: str,
                 model_names: List[str],
                 generate_stream_fn: Callable,
                 limit_concurrency: int = 5,
                 register: bool = True):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = str(uuid.uuid4())[:6]
        self.model_names = model_names
        self.generate_stream_fn = generate_stream_fn
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.queue_length = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        if register:
            self.register_to_controller()
            self._hb = threading.Thread(target=self._heartbeat_loop,
                                        daemon=True)
            self._hb.start()

    # ---- controller protocol (model_worker.py:87-122) -------------------
    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.controller_addr + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            return json.loads(r.read())

    def register_to_controller(self):
        self._post("/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status()})

    def _heartbeat_loop(self):
        while not self._stop.wait(WORKER_HEART_BEAT_INTERVAL):
            try:
                r = self._post("/receive_heart_beat", {
                    "worker_name": self.worker_addr,
                    "queue_length": self.queue_length})
                if not r.get("exist"):
                    self.register_to_controller()
            except Exception as e:
                logger.warning("heartbeat failed: %s", e)

    def get_status(self) -> dict:
        return {"model_names": self.model_names, "speed": 1,
                "queue_length": self.queue_length}

    # ---- generation (model_worker.py:123-194) ---------------------------
    def generate_stream_gate(self, params: dict):
        with self._lock:
            self.queue_length += 1
        acquired = self.semaphore.acquire(timeout=60)
        try:
            if not acquired:
                yield {"text": "", "error_code": 1,
                       "text_error": "concurrency limit"}
                return
            for text in self.generate_stream_fn(
                    params["prompt"],
                    int(params.get("max_new_tokens", 64)),
                    float(params.get("temperature", 0.0))):
                yield {"text": text, "error_code": 0}
        finally:
            if acquired:
                self.semaphore.release()
            with self._lock:
                self.queue_length -= 1

    def shutdown(self):
        self._stop.set()


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            data = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/worker_get_status":
                self._json(worker.get_status())
            elif self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                for chunk in worker.generate_stream_gate(data):
                    self.wfile.write(json.dumps(chunk).encode() + b"\0")
                    self.wfile.flush()
            elif self.path == "/worker_generate":
                text = ""
                for chunk in worker.generate_stream_gate(data):
                    text = chunk.get("text", text)
                self._json({"text": text})
            else:
                self._json({"error": "unknown endpoint"}, 404)

    return Handler


def serve_worker(worker: ModelWorker, host: str = "127.0.0.1",
                 port: int = 21002) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    server.worker = worker
    return server


def torch_generate_stream_fn(model, tokenizer, cache_kind: str = "quant",
                             quant_cfg=None):
    """Build a generate_stream_fn backed by the port's decode loop
    (``eval/generate.py::generate``; the model holds its weights). The
    whole reply is generated, then streamed in word chunks, as the JAX
    package's ``jax_generate_stream_fn`` streams it. ``generate`` holds the
    process's device lock, so request threads and an engine on the same
    card take turns."""
    import numpy as np
    from ..eval.generate import generate

    def fn(prompt: str, max_new_tokens: int, temperature: float):
        ids = np.asarray([tokenizer.encode(prompt)])
        out = generate(model, ids, max_new_tokens, cache_kind=cache_kind,
                       quant_cfg=quant_cfg, temperature=temperature)
        text = tokenizer.decode(out[0].tolist())
        # stream in word chunks
        words = text.split(" ")
        for i in range(1, len(words) + 1):
            yield " ".join(words[:i])

    return fn
