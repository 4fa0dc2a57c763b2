"""Probe: can a process on this machine bind a loopback TCP port and reach
it? Starts a stdlib HTTP server on 127.0.0.1, port 0 (any free port),
requests one page from it and prints one JSON line. Touches no other host.

    python _dev/loopback_probe.py
"""

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Echo(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        body = b"ok"
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def main():
    rec = {"probe": "loopback"}
    try:
        srv = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
        rec["port"] = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rec['port']}/", timeout=5) as r:
            rec["reply"] = r.read().decode()
        srv.shutdown()
        srv.server_close()
        rec["ok"] = rec["reply"] == "ok"
    except Exception as e:                       # report, do not hide
        rec.update(ok=False, error=f"{type(e).__name__}: {e}")
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
