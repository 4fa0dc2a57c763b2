"""Serving client utilities: interactive CLI, worker registration, smoke
message.

Own copy of ``microscopiq_tpu/serve/cli.py`` (standard library only):
``chat_loop`` (an interactive chat over the controller/worker HTTP
protocol), ``register_worker`` (re-register a live worker with the
controller), ``test_message`` (one message through controller dispatch,
the streamed reply printed).

    python -m microscopiq_tpu_torch.serve.cli test --controller URL
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Iterator, Optional


def _post(url: str, payload: dict, timeout: float = 10.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def register_worker(controller: str, worker: str,
                    check_heart_beat: bool = True) -> dict:
    """Re-register a live worker (register_worker.py semantics: the
    controller pulls /worker_get_status from the worker itself)."""
    return _post(controller + "/register_worker", {
        "worker_name": worker, "check_heart_beat": check_heart_beat,
        "worker_status": None})


def list_models(controller: str) -> list:
    return _post(controller + "/list_models", {})["models"]


def get_worker(controller: str, model: str) -> str:
    addr = _post(controller + "/get_worker_address",
                 {"model": model})["address"]
    if not addr:
        raise RuntimeError(f"no live worker for model {model!r}")
    return addr


def stream_generate(worker: str, prompt: str, max_new_tokens: int = 128,
                    temperature: float = 0.0,
                    timeout: float = 300.0) -> Iterator[dict]:
    """Yield the worker's chunked JSON stream (NUL-delimited frames)."""
    req = urllib.request.Request(
        worker + "/worker_generate_stream",
        data=json.dumps({"prompt": prompt,
                         "max_new_tokens": max_new_tokens,
                         "temperature": temperature}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        buf = b""
        while True:
            chunk = r.read(4096)
            if not chunk:
                break
            buf += chunk
            while b"\0" in buf:
                frame, buf = buf.split(b"\0", 1)
                if frame:
                    yield json.loads(frame)


def test_message(controller: str, model: Optional[str] = None,
                 message: str = "Tell me a story with more than "
                 "1000 words.", max_new_tokens: int = 32,
                 out=sys.stdout) -> str:
    """One message through controller dispatch; returns the final text."""
    if model is None:
        models = list_models(controller)
        if not models:
            raise RuntimeError("no models registered")
        model = models[0]
    worker = get_worker(controller, model)
    text = ""
    for frame in stream_generate(worker, message, max_new_tokens):
        if frame.get("error_code"):
            raise RuntimeError(frame.get("text_error", "worker error"))
        text = frame["text"]
        print(text, file=out)
    return text


def chat_loop(controller: str, model: Optional[str] = None,
              max_new_tokens: int = 128, temperature: float = 0.0,
              stdin=sys.stdin, stdout=sys.stdout):
    """Interactive chat: each turn is dispatched to the least-loaded
    worker; replies stream token-by-token."""
    if model is None:
        model = list_models(controller)[0]
    print(f"model: {model} (ctrl-d to exit)", file=stdout)
    for line in stdin:
        prompt = line.strip()
        if not prompt:
            continue
        worker = get_worker(controller, model)
        last = ""
        for frame in stream_generate(worker, prompt, max_new_tokens,
                                     temperature):
            text = frame.get("text", "")
            # workers stream the full text so far; print the delta when
            # frames are cumulative, else re-print the frame
            delta = text[len(last):] if text.startswith(last) else \
                "\r" + text
            print(delta, end="", file=stdout, flush=True)
            last = text
        print(file=stdout)


def main(argv=None):
    ap = argparse.ArgumentParser(description="serving client")
    ap.add_argument("command", choices=["chat", "register", "test"],
                    help="chat: interactive; register: re-register a "
                    "worker; test: one smoke message")
    ap.add_argument("--controller", default="http://127.0.0.1:21001")
    ap.add_argument("--worker", default=None,
                    help="worker address (register)")
    ap.add_argument("--model", default=None)
    ap.add_argument("--message", default="Hello")
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)
    if args.command == "register":
        if not args.worker:
            ap.error("--worker required for register")
        print(register_worker(args.controller, args.worker))
    elif args.command == "test":
        test_message(args.controller, args.model, args.message,
                     args.max_new_tokens)
    else:
        chat_loop(args.controller, args.model, args.max_new_tokens,
                  args.temperature)


if __name__ == "__main__":
    main()
