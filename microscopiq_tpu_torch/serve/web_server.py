"""Browser chat front-end over the controller/worker stack.

Own copy of ``microscopiq_tpu/serve/web_server.py`` (standard library
only): GET / returns one chat page whose script streams NDJSON deltas from
``/api/chat``; the server refreshes the model list, builds the prompt from
the conversation template, streams the worker's chunks, and logs chats and
votes to a dated conversation-log file.
"""

from __future__ import annotations

import datetime
import json
import os
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..vlm.conversation import conv_templates

server_error_msg = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE "
                    "REGENERATE OR REFRESH THIS PAGE.**")


def _post(url: str, payload: dict, timeout: float = 10) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class WebServer:
    """Controller-backed chat app state (log dir, template choice)."""

    def __init__(self, controller_url: str, log_dir: str = ".",
                 conv_mode: str = "llava_v1",
                 stream_timeout: float = 120.0):
        self.controller_url = controller_url
        self.log_dir = log_dir
        self.conv_mode = conv_mode
        self.stream_timeout = stream_timeout

    # -- model list (gradio_web_server.py:38-45) --
    def get_model_list(self):
        _post(self.controller_url + "/refresh_all_workers", {})
        models = _post(self.controller_url + "/list_models", {})["models"]
        return sorted(models)

    # -- conv log (gradio_web_server.py:32-35, 82-110) --
    def conv_log_filename(self) -> str:
        t = datetime.datetime.now()
        return os.path.join(
            self.log_dir, f"{t.year}-{t.month:02d}-{t.day:02d}-conv.json")

    def log_event(self, record: dict) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        with open(self.conv_log_filename(), "a") as f:
            f.write(json.dumps({"tstamp": round(time.time(), 4),
                                **record}) + "\n")

    # -- prompt build + worker streaming (http_bot :154-250) --
    def build_prompt(self, messages, has_image: bool = False) -> str:
        conv = conv_templates[self.conv_mode].copy()
        for i, m in enumerate(messages):
            text = m["content"]
            if i == 0 and has_image and "<image>" not in text:
                text = "<image>\n" + text
            conv.append_message(
                conv.roles[0 if m["role"] == "user" else 1], text)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def stream_chat(self, model: str, messages, temperature: float = 0.2,
                    top_p: float = 0.7, max_new_tokens: int = 512,
                    image_b64: Optional[str] = None):
        """Yield cumulative reply texts (the reference accumulates
        ``data['text']`` the same way)."""
        addr = _post(self.controller_url + "/get_worker_address",
                     {"model": model})["address"]
        if not addr:
            yield {"error": server_error_msg}
            return
        conv = conv_templates[self.conv_mode]
        prompt = self.build_prompt(messages,
                                   has_image=image_b64 is not None)
        payload = {"model": model, "prompt": prompt,
                   "temperature": temperature, "top_p": top_p,
                   "max_new_tokens": max_new_tokens,
                   "stop": conv.sep2 or conv.sep}
        if image_b64 is not None:
            payload["images"] = [image_b64]
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
                            yield {"error": chunk.get("text_error",
                                                      server_error_msg)}
                            return
                        yield {"text": chunk["text"]}
                    buf = b""
                else:
                    buf += b


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>microscopiq chat</title><style>
body{font-family:system-ui,sans-serif;max-width:780px;margin:2rem auto;
padding:0 1rem;background:#fafafa}
#log{border:1px solid #ddd;background:#fff;border-radius:8px;
padding:1rem;min-height:320px;margin-bottom:.75rem;white-space:pre-wrap}
.u{color:#234;font-weight:600}.a{color:#051}
.row{display:flex;gap:.5rem;align-items:center;flex-wrap:wrap}
input[type=text]{flex:1;padding:.5rem}select,button{padding:.4rem}
label{font-size:.85rem;color:#555}</style></head><body>
<h2>microscopiq_tpu chat</h2>
<div class="row">
 <select id="model"></select>
 <label>temp <input id="temp" type="number" step="0.1" value="0.2"
  style="width:4rem"></label>
 <label>top_p <input id="topp" type="number" step="0.05" value="0.7"
  style="width:4rem"></label>
 <label>max <input id="maxtok" type="number" value="512"
  style="width:5rem"></label>
 <input id="img" type="file" accept="image/*">
</div>
<div id="log"></div>
<div class="row">
 <input id="msg" type="text" placeholder="message...">
 <button id="send">send</button><button id="regen">regenerate</button>
 <button id="clear">clear</button>
 <button id="up">&#128077;</button><button id="down">&#128078;</button>
</div>
<script>
let hist=[];let imgB64=null;
const log=document.getElementById('log');
function render(){log.textContent='';for(const m of hist){
 const d=document.createElement('div');
 d.className=m.role==='user'?'u':'a';
 d.textContent=(m.role==='user'?'you: ':'model: ')+m.content;
 log.appendChild(d);}log.scrollTop=log.scrollHeight;}
async function loadModels(){
 const r=await fetch('/api/models',{method:'POST'});
 const ms=(await r.json()).models;const sel=document.getElementById('model');
 sel.innerHTML='';for(const m of ms){const o=document.createElement('option');
 o.textContent=m;sel.appendChild(o);}}
document.getElementById('img').onchange=e=>{
 const f=e.target.files[0];if(!f)return;const rd=new FileReader();
 rd.onload=()=>{imgB64=rd.result.split(',')[1];};rd.readAsDataURL(f);};
async function chat(){
 const body={model:document.getElementById('model').value,
  messages:hist,temperature:+document.getElementById('temp').value,
  top_p:+document.getElementById('topp').value,
  max_new_tokens:+document.getElementById('maxtok').value};
 if(imgB64)body.image=imgB64;
 hist.push({role:'assistant',content:'...'});render();
 const r=await fetch('/api/chat',{method:'POST',
  headers:{'Content-Type':'application/json'},
  body:JSON.stringify(body)});
 const rd=r.body.getReader();const dec=new TextDecoder();let buf='';
 while(true){const{done,value}=await rd.read();if(done)break;
  buf+=dec.decode(value,{stream:true});
  const lines=buf.split('\\n');buf=lines.pop();
  for(const ln of lines){if(!ln.trim())continue;
   const c=JSON.parse(ln);
   hist[hist.length-1].content=c.error?('[error] '+c.error):c.text;
   render();}}}
document.getElementById('send').onclick=async()=>{
 const t=document.getElementById('msg').value.trim();if(!t)return;
 document.getElementById('msg').value='';
 hist.push({role:'user',content:t});render();await chat();};
document.getElementById('regen').onclick=async()=>{
 if(hist.length&&hist[hist.length-1].role==='assistant')hist.pop();
 render();await chat();};
document.getElementById('clear').onclick=()=>{hist=[];imgB64=null;render();};
async function vote(t){await fetch('/api/vote',{method:'POST',
 headers:{'Content-Type':'application/json'},
 body:JSON.stringify({type:t,model:document.getElementById('model').value,
  state:hist})});}
document.getElementById('up').onclick=()=>vote('upvote');
document.getElementById('down').onclick=()=>vote('downvote');
document.getElementById('msg').addEventListener('keydown',
 e=>{if(e.key==='Enter')document.getElementById('send').click();});
loadModels();
</script></body></html>"""


def make_handler(app: WebServer):
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

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            data = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/api/models":
                self._json({"models": app.get_model_list()})
            elif self.path == "/api/chat":
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                try:
                    for chunk in app.stream_chat(
                            data["model"], data["messages"],
                            float(data.get("temperature", 0.2)),
                            float(data.get("top_p", 0.7)),
                            int(data.get("max_new_tokens", 512)),
                            data.get("image")):
                        self.wfile.write(
                            json.dumps(chunk).encode() + b"\n")
                        self.wfile.flush()
                except Exception:
                    self.wfile.write(json.dumps(
                        {"error": server_error_msg}).encode() + b"\n")
                app.log_event({"type": "chat",
                               "model": data.get("model"),
                               "state": data.get("messages")})
            elif self.path == "/api/vote":
                app.log_event({"type": data.get("type", "vote"),
                               "model": data.get("model"),
                               "state": data.get("state")})
                self._json({"ok": True})
            else:
                self._json({"error": "unknown endpoint"}, 404)

    return Handler


def serve_web(controller_url: str, host: str = "127.0.0.1",
              port: int = 7860, log_dir: str = ".",
              conv_mode: str = "llava_v1") -> ThreadingHTTPServer:
    app = WebServer(controller_url, log_dir, conv_mode)
    server = ThreadingHTTPServer((host, port), make_handler(app))
    server.app = app
    return server


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="stdlib web chat server")
    ap.add_argument("--controller-url", default="http://127.0.0.1:21001")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--log-dir", default=".")
    ap.add_argument("--conv-mode", default="llava_v1")
    args = ap.parse_args(argv)
    srv = serve_web(args.controller_url, args.host, args.port,
                    args.log_dir, args.conv_mode)
    print(f"web server on http://{args.host}:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
