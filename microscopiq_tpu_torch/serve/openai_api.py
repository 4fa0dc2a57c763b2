"""OpenAI-compatible API gateway over the controller/worker stack.

Own copy of ``microscopiq_tpu/serve/openai_api.py`` (standard library
only): ``/v1/models``, ``/v1/completions`` and ``/v1/chat/completions``
(with SSE streaming), translated onto the controller's dispatch and the
workers' NUL-delimited stream.

Token counts in ``usage`` are whitespace-token approximations: the
gateway is model-agnostic and holds no tokenizer.
"""

from __future__ import annotations

import json
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..vlm.conversation import conv_templates


def _post(url: str, payload: dict, timeout: float = 10) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class OpenAIGateway:
    def __init__(self, controller_url: str, conv_mode: str = "llava_v1",
                 stream_timeout: float = 120.0):
        self.controller_url = controller_url
        self.conv_mode = conv_mode
        self.stream_timeout = stream_timeout

    def list_models(self):
        _post(self.controller_url + "/refresh_all_workers", {})
        models = _post(self.controller_url + "/list_models", {})["models"]
        return {"object": "list",
                "data": [{"id": m, "object": "model",
                          "owned_by": "microscopiq_tpu"}
                         for m in sorted(models)]}

    def chat_prompt(self, messages) -> str:
        conv = conv_templates[self.conv_mode].copy()
        system = [m for m in messages if m["role"] == "system"]
        if system:
            conv.system = system[-1]["content"]
        for m in messages:
            if m["role"] == "system":
                continue
            conv.append_message(
                conv.roles[0 if m["role"] == "user" else 1],
                m["content"])
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def _worker_stream(self, model: str, prompt: str, temperature: float,
                       max_tokens: int, stop):
        addr = _post(self.controller_url + "/get_worker_address",
                     {"model": model})["address"]
        if not addr:
            raise LookupError(f"no worker serves model {model!r}")
        payload = {"model": model, "prompt": prompt,
                   "temperature": temperature,
                   "max_new_tokens": max_tokens}
        if stop:
            payload["stop"] = stop
        req = urllib.request.Request(
            addr + "/worker_generate_stream",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req,
                                    timeout=self.stream_timeout) as r:
            buf = b""
            while True:
                b = r.read(1)
                if not b:
                    break
                if b == b"\0":
                    if buf:
                        chunk = json.loads(buf)
                        if chunk.get("error_code", 0) != 0:
                            raise RuntimeError(
                                chunk.get("text_error", "worker error"))
                        yield chunk["text"]
                    buf = b""
                else:
                    buf += b

    def completion(self, body: dict, chat: bool):
        """Non-streaming completion → one OpenAI-schema response."""
        model = body["model"]
        prompt = (self.chat_prompt(body["messages"]) if chat
                  else body["prompt"])
        text = ""
        for text in self._worker_stream(
                model, prompt, float(body.get("temperature", 1.0)),
                int(body.get("max_tokens", 256)), body.get("stop")):
            pass
        pt, ct = len(prompt.split()), len(text.split())
        base = {"id": ("chatcmpl-" if chat else "cmpl-")
                + uuid.uuid4().hex[:24],
                "object": ("chat.completion" if chat
                           else "text_completion"),
                "created": int(time.time()), "model": model,
                "usage": {"prompt_tokens": pt, "completion_tokens": ct,
                          "total_tokens": pt + ct}}
        if chat:
            base["choices"] = [{"index": 0, "finish_reason": "stop",
                                "message": {"role": "assistant",
                                            "content": text}}]
        else:
            base["choices"] = [{"index": 0, "finish_reason": "stop",
                                "text": text}]
        return base

    def stream_events(self, body: dict, chat: bool):
        """SSE event strings for stream=true requests (cumulative worker
        texts → per-event deltas)."""
        model = body["model"]
        prompt = (self.chat_prompt(body["messages"]) if chat
                  else body["prompt"])
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        sent = ""
        if chat:
            first = {"id": rid, "object": "chat.completion.chunk",
                     "created": int(time.time()), "model": model,
                     "choices": [{"index": 0, "finish_reason": None,
                                  "delta": {"role": "assistant"}}]}
            yield f"data: {json.dumps(first)}\n\n"
        for text in self._worker_stream(
                model, prompt, float(body.get("temperature", 1.0)),
                int(body.get("max_tokens", 256)), body.get("stop")):
            # worker streams cumulative text; engine streams only
            # append, but guard against a rewritten tail (emit from the
            # first divergent char)
            if text.startswith(sent):
                delta = text[len(sent):]
            else:
                i = next((j for j, (a, b) in enumerate(zip(sent, text))
                          if a != b), min(len(sent), len(text)))
                delta = text[i:]
            sent = text
            if not delta:
                continue
            ev = {"id": rid,
                  "object": ("chat.completion.chunk" if chat
                             else "text_completion"),
                  "created": int(time.time()), "model": model}
            if chat:
                ev["choices"] = [{"index": 0, "finish_reason": None,
                                  "delta": {"content": delta}}]
            else:
                ev["choices"] = [{"index": 0, "finish_reason": None,
                                  "text": delta}]
            yield f"data: {json.dumps(ev)}\n\n"
        last = {"id": rid,
                "object": ("chat.completion.chunk" if chat
                           else "text_completion"),
                "created": int(time.time()), "model": model,
                "choices": [{"index": 0, "finish_reason": "stop",
                             **({"delta": {}} if chat
                                else {"text": ""})}]}
        yield f"data: {json.dumps(last)}\n\n"
        yield "data: [DONE]\n\n"


def make_handler(gw: OpenAIGateway):
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

        def _err(self, msg, code=400, kind="invalid_request_error"):
            self._json({"error": {"message": msg, "type": kind}}, code)

        def do_GET(self):
            if self.path == "/v1/models":
                self._json(gw.list_models())
            else:
                self._err("not found", 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            chat = self.path == "/v1/chat/completions"
            if self.path not in ("/v1/chat/completions",
                                 "/v1/completions"):
                self._err("not found", 404)
                return
            try:
                if body.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    for ev in gw.stream_events(body, chat):
                        self.wfile.write(ev.encode())
                        self.wfile.flush()
                else:
                    self._json(gw.completion(body, chat))
            except LookupError as e:
                self._err(str(e), 404, "model_not_found")
            except KeyError as e:
                self._err(f"missing field {e}", 400)

    return Handler


def serve_openai(controller_url: str, host: str = "127.0.0.1",
                 port: int = 8000,
                 conv_mode: str = "llava_v1") -> ThreadingHTTPServer:
    gw = OpenAIGateway(controller_url, conv_mode)
    server = ThreadingHTTPServer((host, port), make_handler(gw))
    server.gateway = gw
    return server


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="OpenAI-compatible API gateway")
    ap.add_argument("--controller-url", default="http://127.0.0.1:21001")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--conv-mode", default="llava_v1")
    args = ap.parse_args(argv)
    srv = serve_openai(args.controller_url, args.host, args.port,
                       args.conv_mode)
    print(f"openai api on http://{args.host}:{args.port}/v1")
    srv.serve_forever()


if __name__ == "__main__":
    main()
