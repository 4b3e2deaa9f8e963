"""Threaded HTTP/JSON frontend over the serving engine. Stdlib only.

The score and generate paths of ``paddle_tpu/serving/server.py``, with the
same wire:

- ``POST /v1/score`` — ``{"sample": [...slot values...], "deadline_ms":
  50}`` answers ``{"outputs": {layer: row_values}}``; ``{"rows": [[...],
  ...]}`` makes each row one engine request (the batcher coalesces them)
  and answers ``{"results": [...]}``, 207 when any row failed (its slot
  carries the typed error body).
- ``POST /v1/generate`` — the same bodies (plus optional ``beam_size`` /
  ``max_length``, which must be the warmed pair) over a generating config;
  each answer is ``{"sequences": [{"tokens": [...], "score": s}, ...]}``,
  the beams best first.
- ``GET /healthz`` — readiness: 200 only when warmed, not draining and the
  worker alive; the body is ``ServingEngine.health()`` (with the precision
  tier's ``quant`` block and the kernel launch counts).
- ``GET /livez`` — liveness: 200 while the worker has not died, draining
  and warming included.
- ``GET /metrics`` — the engine's metrics as Prometheus text;
  ``/metrics?format=json`` for the JSON snapshot.
- ``POST /admin/drain`` — admission closes, queued and in-flight work
  completes, the process stays up.

Errors are typed (``serving/errors.py``): 400 bad_request, 429
overloaded/shutting_down with a ``Retry-After`` header, 504
deadline_exceeded. SIGTERM closes admission, lets queued work finish,
then stops the listener.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from paddle_tpu_torch.serving.batcher import ServingEngine
from paddle_tpu_torch.serving.errors import (BadRequest, DeadlineExceeded,
                                             ServingError)

logger = logging.getLogger("paddle_tpu_torch.serving.http")


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of connections while the worker holds the interpreter (a
    # dropped SYN is retried after a second), so it matches the engine's
    # default queue bound
    request_queue_size = 128

    def __init__(self, addr, engine: ServingEngine):
        super().__init__(addr, _Handler)
        self.engine = engine


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _send(self, status: int, body, retry_after_ms: Optional[float] = None,
              content_type: str = "application/json"):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        if retry_after_ms is not None:
            self.send_header("Retry-After",
                             str(max(1, round(retry_after_ms / 1e3))))
        self.end_headers()
        self.wfile.write(data)

    def _send_error(self, e: ServingError):
        self._send(e.status, e.to_wire(), retry_after_ms=e.retry_after_ms)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as e:
            raise BadRequest(f"request body is not JSON: {e}") from e
        if not isinstance(body, dict):
            raise BadRequest("request body must be a JSON object")
        return body

    def _not_found(self):
        self._send(404, {"error": {"code": "not_found",
                                   "message": self.path}})

    def do_GET(self):
        engine = self.server.engine
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            h = engine.health()
            self._send(200 if h["ready"] else 503, h)
        elif path == "/livez":
            h = engine.health()
            self._send(200 if h["live"] else 503, h)
        elif path == "/metrics":
            if "format=json" in self.path:
                self._send(200, engine.metrics.snapshot())
            else:
                self._send(200, engine.metrics.to_prometheus().encode(),
                           content_type="text/plain; version=0.0.4")
        else:
            self._not_found()

    def do_POST(self):
        engine = self.server.engine
        path = self.path.split("?", 1)[0]
        if path == "/admin/drain":
            engine.begin_drain()
            self._send(200, engine.health())
            return
        kind = {"/v1/score": "score", "/v1/generate": "generate"}.get(path)
        if kind is None:
            self._not_found()
            return
        try:
            body = self._body()
            deadline_ms = body.get("deadline_ms")
            gen_opts = {}
            if kind == "generate":
                gen_opts = {"beam_size": body.get("beam_size"),
                            "max_length": body.get("max_length")}
            if "rows" in body:
                if not isinstance(body["rows"], list) or not body["rows"]:
                    raise BadRequest("\"rows\" must be a non-empty list")
                self._rows(engine, body["rows"], kind, deadline_ms,
                           gen_opts)
                return
            if "sample" not in body:
                raise BadRequest("need \"sample\" (one request) or "
                                 "\"rows\" (a list)")
            result = engine.infer(body["sample"], kind=kind,
                                  deadline_ms=deadline_ms, **gen_opts)
            self._send(200, result)
        except ServingError as e:
            self._send_error(e)
        except Exception as e:  # noqa: BLE001 — the only 500 source
            logger.error("unhandled serving error: %r", e)
            self._send_error(ServingError(repr(e)))

    def _rows(self, engine, rows, kind, deadline_ms, gen_opts):
        """One engine request per row; a row's admission failure is
        carried in its own slot and does not abort its siblings."""
        reqs = []
        for row in rows:
            try:
                reqs.append(engine.submit(row, kind=kind,
                                          deadline_ms=deadline_ms,
                                          **gen_opts))
            except ServingError as e:
                reqs.append(e)
        results = []
        any_err = False
        for r in reqs:
            if isinstance(r, ServingError):
                results.append(r.to_wire())
                any_err = True
                continue
            if not r.event.wait(120.0):  # never block a handler forever
                r.error = DeadlineExceeded(
                    "no answer within the server wait bound")
            any_err = any_err or r.error is not None
            results.append(r.error.to_wire() if r.error else r.result)
        self._send(207 if any_err else 200, {"results": results})


def make_server(engine: ServingEngine, host: str = "127.0.0.1",
                port: int = 0) -> ServingHTTPServer:
    """Bind (port 0 = ephemeral) without serving yet; the bound port is
    ``server.server_address[1]``."""
    return ServingHTTPServer((host, port), engine)


def install_signal_handlers(engine: ServingEngine,
                            server: Optional[ServingHTTPServer] = None):
    """SIGTERM/SIGINT -> drain: close admission, finish queued work, then
    stop the HTTP listener. Returns the previous handlers."""

    def _drain(signum, frame):
        logger.info("signal %d: draining", signum)
        engine.begin_drain()

        def _finish():
            engine.shutdown(drain=True)
            if server is not None:
                server.shutdown()

        threading.Thread(target=_finish, daemon=True,
                         name="serving-drain").start()

    return {sig: signal.signal(sig, _drain)
            for sig in (signal.SIGTERM, signal.SIGINT)}


def serve_forever(engine: ServingEngine, host: str = "127.0.0.1",
                  port: int = 8000) -> int:
    """CLI entry: warm up, bind, install drain handlers, print the ready
    line (with the bound port), serve until a signal drains us."""
    engine.start(warmup=True)
    server = make_server(engine, host, port)
    install_signal_handlers(engine, server)
    print(f"serving on http://{host}:{server.server_address[1]} "
          f"(device={engine.predictor.device}, "
          f"buckets batch={engine.predictor.batch_buckets}, "
          f"length={engine.predictor.length_buckets}; "
          f"max_batch={engine.max_batch}, "
          f"batch_timeout={engine.batch_timeout_ms}ms, "
          f"queue_depth={engine.queue_depth})", flush=True)
    try:
        server.serve_forever(poll_interval=0.2)
    finally:
        server.server_close()
        engine.shutdown(drain=True)
    return 0
