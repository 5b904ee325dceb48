"""Stdlib-HTTP front end over ``ClusterEngine``: the JAX package's
``repro.serve.server``, with its routes and error codes.

Tiny by intent: JSON in, JSON out, no dependencies beyond the standard
library, and every route drives the *same* engine loop the in-process API
and benchmarks use (one lock serializes engine access — the engine itself
is single-threaded; batching across concurrent clients still happens
because requests queue behind the lock and coalesce in ``drain``).

Routes:

  POST /v1/predict    {"model": name, "rows": [[...], ...]} → {"labels": [...]}
  POST /v1/transform  {"model": name, "rows": [[...], ...]} → {"embedding": ...}
  POST /v1/models     {"name": name, "path": npz}           → load / hot-swap
  GET  /v1/stats                                            → engine stats
                        (incl. latency_*_p50_ms/p99_ms from the engine's
                        request-latency histograms)
  GET  /metrics       Prometheus text exposition (engine registry + the
                        process-global repro_torch.obs registry) — point a
                        Prometheus scrape job at this

Usage::

    engine = ClusterEngine()                     # device="cuda"
    engine.load_model("blobs", "model.npz")
    with ClusterServer(engine, port=0) as srv:   # port 0 → ephemeral
        print(srv.url)                           # http://127.0.0.1:<port>
        ...
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.serve.cluster_engine import ClusterEngine


def _make_handler(engine: ClusterEngine, lock: threading.Lock):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):       # tests/benches: keep stderr quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                with lock:
                    body = engine.metrics_text().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path != "/v1/stats":
                return self._reply(404, {"error": f"no route {self.path}"})
            with lock:
                return self._reply(200, engine.stats())

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad JSON body: {e}"})
            try:
                if self.path == "/v1/models":
                    with lock:
                        mdl = engine.load_model(req["name"], req["path"])
                    return self._reply(200, {"loaded": req["name"],
                                             "data_dim": mdl.data_dim,
                                             "nbytes": mdl.nbytes})
                if self.path in ("/v1/predict", "/v1/transform"):
                    rows = np.asarray(req["rows"], np.float32)
                    if rows.ndim == 1:      # single point convenience
                        rows = rows[None, :]
                    with lock:
                        if self.path == "/v1/predict":
                            out = engine.predict(req["model"], rows)
                            return self._reply(200,
                                               {"labels": out.tolist()})
                        out = engine.transform(req["model"], rows)
                        return self._reply(200, {"embedding": out.tolist()})
                return self._reply(404, {"error": f"no route {self.path}"})
            except KeyError as e:
                return self._reply(400, {"error": f"missing/unknown: {e}"})
            except ValueError as e:
                return self._reply(400, {"error": str(e)})

    return Handler


class ClusterServer:
    """Threaded HTTP server wrapping one engine; context-manager friendly."""

    def __init__(self, engine: ClusterEngine, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer(
            (host, port), _make_handler(engine, self._lock))
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._httpd.server_address[0]}:{self.port}"

    def start(self) -> "ClusterServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "ClusterServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
