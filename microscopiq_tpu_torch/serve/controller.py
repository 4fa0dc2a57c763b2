"""Serving controller: worker registry, heartbeats, dispatch.

Own copy of ``microscopiq_tpu/serve/controller.py`` (standard library and
numpy only): HTTP API with ``/register_worker``, ``/receive_heart_beat``,
``/refresh_all_workers``, ``/list_models``, ``/get_worker_address``
(dispatch by lottery or shortest queue) and a heartbeat-expiration sweep
thread. The lottery draws from numpy's global random state, as the JAX
package's does, so that the same ``np.random.seed`` picks the same worker.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

CONTROLLER_HEART_BEAT_EXPIRATION = 90  # llava/constants.py value

logger = logging.getLogger("microscopiq.controller")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in ("lottery", "shortest_queue")
        self.dispatch_method = dispatch_method
        self.worker_info: Dict[str, WorkerInfo] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sweeper = threading.Thread(target=self._sweep_loop,
                                         daemon=True)
        self._sweeper.start()

    # ---- registry (controller.py:57-119) -------------------------------
    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: Optional[dict]) -> bool:
        if worker_status is None:
            worker_status = self._get_worker_status(worker_name)
        if worker_status is None:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                worker_status["model_names"], worker_status.get("speed", 1),
                worker_status.get("queue_length", 0), check_heart_beat,
                time.time())
        logger.info("register worker %s", worker_name)
        return True

    def _get_worker_status(self, worker_name: str) -> Optional[dict]:
        try:
            req = urllib.request.Request(worker_name + "/worker_get_status",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=5) as r:
                return json.loads(r.read())
        except Exception as e:
            logger.warning("get status failed %s: %s", worker_name, e)
            return None

    def refresh_all_workers(self) -> None:
        with self._lock:
            old = dict(self.worker_info)
            self.worker_info = {}
        for name, info in old.items():
            if not self.register_worker(name, info.check_heart_beat, None):
                logger.info("remove stale worker %s", name)

    def list_models(self) -> List[str]:
        models = set()
        with self._lock:
            for info in self.worker_info.values():
                models.update(info.model_names)
        return sorted(models)

    # ---- dispatch (controller.py:120-172) -------------------------------
    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            if self.dispatch_method == "lottery":
                names, speeds = [], []
                for name, info in self.worker_info.items():
                    if model_name in info.model_names:
                        names.append(name)
                        speeds.append(info.speed)
                if not names:
                    return ""
                probs = np.asarray(speeds, np.float32)
                probs = probs / probs.sum()
                return str(np.random.choice(names, p=probs))
            # shortest queue, normalized by speed
            names, qlens = [], []
            for name, info in self.worker_info.items():
                if model_name in info.model_names:
                    names.append(name)
                    qlens.append(info.queue_length / max(info.speed, 1e-6))
            if not names:
                return ""
            i = int(np.argmin(qlens))
            self.worker_info[names[i]].queue_length += 1
            return names[i]

    # ---- heartbeats (controller.py:173-192) -----------------------------
    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.worker_info:
                return False
            info = self.worker_info[worker_name]
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
            return True

    def _sweep_loop(self):
        while not self._stop.wait(CONTROLLER_HEART_BEAT_EXPIRATION // 3):
            self.remove_stale_workers_by_expiration()

    def remove_stale_workers_by_expiration(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self._lock:
            dead = [name for name, info in self.worker_info.items()
                    if info.check_heart_beat and
                    info.last_heart_beat < expire]
            for name in dead:
                logger.info("expire worker %s", name)
                del self.worker_info[name]

    def shutdown(self):
        self._stop.set()


def make_handler(controller: Controller):
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
            if self.path == "/register_worker":
                ok = controller.register_worker(
                    data["worker_name"], data.get("check_heart_beat", True),
                    data.get("worker_status"))
                self._json({"success": ok})
            elif self.path == "/refresh_all_workers":
                controller.refresh_all_workers()
                self._json({})
            elif self.path == "/list_models":
                self._json({"models": controller.list_models()})
            elif self.path == "/get_worker_address":
                self._json({"address":
                            controller.get_worker_address(data["model"])})
            elif self.path == "/receive_heart_beat":
                ok = controller.receive_heart_beat(
                    data["worker_name"], data.get("queue_length", 0))
                self._json({"exist": ok})
            else:
                self._json({"error": "unknown endpoint"}, 404)

    return Handler


def serve_controller(host: str = "127.0.0.1", port: int = 21001,
                     dispatch_method: str = "shortest_queue"
                     ) -> ThreadingHTTPServer:
    controller = Controller(dispatch_method)
    server = ThreadingHTTPServer((host, port), make_handler(controller))
    server.controller = controller
    return server


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=21001)
    ap.add_argument("--dispatch-method", default="shortest_queue",
                    choices=["lottery", "shortest_queue"])
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    srv = serve_controller(args.host, args.port, args.dispatch_method)
    print(f"controller listening on {args.host}:{args.port}")
    srv.serve_forever()
