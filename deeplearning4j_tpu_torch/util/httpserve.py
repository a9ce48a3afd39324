"""Stdlib HTTP serving scaffold: a daemon-threaded ThreadingHTTPServer
owner mixin plus a JSON-speaking request handler base.

Copied from ``deeplearning4j_tpu/util/httpserve.py``. Every server built
on it gets

* ``GET /healthz`` — 200 {"status": "ok"} while the owner is started
  and ready, 503 otherwise (503 until an optional warmup hook returns,
  with the hook's error in the body if it raised);
* an optional per-request deadline: ``_serve(..., requestDeadline=s)``
  runs each handler on a watched worker thread and answers 503
  {"error": "deadline exceeded"} instead of letting a stuck handler hang
  the client. The late handler's own write is suppressed (one response
  lock), so the two can never interleave on the socket.

Handlers subclass JsonHandler and implement ``handle_GET`` /
``handle_POST`` (the base owns do_GET/do_POST).
"""

from __future__ import annotations

import http.server
import json
import threading
import time

from deeplearning4j_tpu_torch.runtime import telemetry

__all__ = ["HttpError", "JsonHandler", "HttpServerOwner"]

#: serializes HttpServerOwner start/stop across threads (two concurrent
#: start() calls must not each bind a server)
_LIFECYCLE_LOCK = threading.Lock()


class HttpError(Exception):
    """Typed HTTP failure a handler raises to answer a specific status
    code with a JSON error body, instead of the generic 500."""

    def __init__(self, code, message):
        super().__init__(message)
        self.code = int(code)
        self.message = str(message)


class JsonHandler(http.server.BaseHTTPRequestHandler):
    """Request handler base: silenced per-request logging, JSON/body
    writers with correct Content-Length, strict JSON-object body
    parsing, and the /healthz + request-deadline dispatch."""

    # per-request response state (instances are per-request)
    _responded = False
    _suppressed = False
    _resp_lock = None
    _t0 = None
    _metric_done = False

    @classmethod
    def metric_route(cls, path):
        """Bounded-cardinality route label for the per-route latency /
        status-code instruments, or None to stay uninstrumented."""
        return None

    def _record_metrics(self, code):
        if self._metric_done or self._t0 is None:
            return
        route = self.metric_route(self.path.split("?", 1)[0])
        if route is None:
            return
        self._metric_done = True
        reg = telemetry.get_registry()
        reg.counter("dl4j_http_requests_total",
                    "HTTP responses by route and status code",
                    labels=("route", "code")).labels(
            route=route, code=int(code)).inc()
        reg.histogram("dl4j_http_latency_seconds",
                      "request receipt to response write, per route",
                      labels=("route",)).labels(route=route).observe(
            time.perf_counter() - self._t0)

    def log_message(self, *a):
        pass

    def _send(self, code, body, ctype, _force=False):
        data = body.encode() if isinstance(body, str) else body
        lock = self._resp_lock
        if lock is not None:
            with lock:
                if self._suppressed and not _force:
                    return  # the deadline already answered 503
                self._responded = True
        else:
            self._responded = True  # thread-ok[THR01]: no-deadline mode: this request runs on exactly one handler thread; the lock (and its writers) only exist in deadline mode
        self._record_metrics(code)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, obj, code=200, _force=False):
        self._send(code, json.dumps(obj), "application/json", _force=_force)

    def _read_json_object(self):
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n) or b"{}")
        if not isinstance(body, dict):
            raise ValueError(
                f"JSON object body required, got {type(body).__name__}")
        return body

    # ----- dispatch ----------------------------------------------------
    def _owner(self):
        return getattr(self.server, "owner", None)

    def do_GET(self):
        self._t0 = time.perf_counter()
        if self.path.split("?", 1)[0] == "/healthz":
            owner = self._owner()
            ready = owner.ready if owner is not None else True
            body = {"status": "ok" if ready else "unready"}
            err = getattr(owner, "_warmup_error", None)
            if not ready and err is not None:
                # "still warming" and "warmup crashed" must be told apart
                body["warmupError"] = err
            return self._json(body, 200 if ready else 503)
        self._dispatch("GET")

    def do_POST(self):
        self._t0 = time.perf_counter()
        self._dispatch("POST")

    def _dispatch(self, method):
        impl = getattr(self, f"handle_{method}", None)
        if impl is None:
            return self._json({"error": f"{method} not supported"}, 501)
        owner = self._owner()
        deadline = getattr(owner, "requestDeadline", None)
        if not deadline:
            # a handler exception reaches the client as a status code,
            # not a dropped connection — unless a response is already
            # mid-flight, where a second write would interleave
            try:
                return impl()
            except HttpError as e:
                if not self._responded:  # thread-ok[THR01]: no-deadline mode: one handler thread per request
                    self._json({"error": e.message}, e.code)
            except Exception as e:
                if not self._responded:  # thread-ok[THR01]: no-deadline mode: one handler thread per request
                    self._json({"error": f"{type(e).__name__}: {e}"}, 500)
            return None
        # deadline mode: the handler runs on a watched daemon thread; if
        # it overruns, THIS thread answers 503 and the worker's eventual
        # write is dropped by the response lock (the worker is abandoned,
        # not killed; the client is released)
        self._resp_lock = threading.Lock()
        done = threading.Event()

        def run():  # fault-ok[FLT02]: deadline-mode dispatch wrapper: impl() is the concrete handler, which owns the request seam (serving/server.py fires server.request before routing)
            try:
                impl()
            except HttpError as e:
                try:
                    self._json({"error": e.message}, e.code)
                except OSError:
                    pass  # the client hung up mid-error-reply
            except Exception as e:
                try:
                    self._json({"error": f"{type(e).__name__}: {e}"}, 500)
                except OSError:
                    pass  # the connection is gone
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        if not done.wait(float(deadline)):
            with self._resp_lock:
                overrun = not self._responded
                if overrun:
                    self._suppressed = True
            if overrun:
                self._json({"error": "deadline exceeded",
                            "deadlineSec": float(deadline)}, 503,
                           _force=True)
                self.close_connection = True
            elif not done.wait(5.0):
                # response mid-write: give it a grace period, then drop
                # the connection rather than interleave a later response
                self.close_connection = True


class HttpServerOwner:
    """start/stop/port for a class that owns one loopback HTTP server,
    plus the readiness flag /healthz reports and the per-request
    deadline JsonHandler enforces."""

    _httpd = None
    _thread = None
    _ready = True
    _warmup_error = None    # last warmup failure, surfaced on /healthz
    requestDeadline = None  # seconds; None/0 disables

    @property
    def port(self):
        """Bound port once started (pass port=0 for an ephemeral one)."""
        httpd = self._httpd  # thread-ok[THR01]: atomic reference read; a probe racing stop() sees the old server or None, both valid answers
        return httpd.server_address[1] if httpd else None

    @property
    def ready(self) -> bool:
        """What /healthz answers: started and warmed."""
        return self._httpd is not None and self._ready  # thread-ok[THR01]: atomic reads; readiness is advisory and a stale answer is a probe a moment earlier

    def _serve(self, handler_cls, port, requestDeadline=None,
               warmup=None):
        """Start serving on 127.0.0.1. `warmup` (optional callable) runs
        on a background thread; /healthz answers 503 until it returns,
        and stays 503 with the error if it raises."""
        with _LIFECYCLE_LOCK:
            if self._httpd is not None:
                return self
            if requestDeadline is not None:
                self.requestDeadline = float(requestDeadline) or None
            self._warmup_error = None
            self._ready = warmup is None
            self._httpd = http.server.ThreadingHTTPServer(
                ("127.0.0.1", port), handler_cls)
            self._httpd.owner = self
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
            # a warmup outliving stop()/restart must not mark a NEWER
            # server ready: publish only if its server is still live
            httpd = self._httpd
        if warmup is not None:
            def _warm():  # fault-ok[FLT02]: warmup runs a user callable whose own boundaries carry the seams; its failure is classified into _warmup_error and surfaced on /healthz
                try:
                    warmup()
                except Exception as e:
                    with _LIFECYCLE_LOCK:
                        if self._httpd is httpd:
                            self._warmup_error = \
                                f"{type(e).__name__}: {e}"[:500]
                    return
                with _LIFECYCLE_LOCK:
                    if self._httpd is httpd:
                        self._ready = True

            threading.Thread(target=_warm, daemon=True).start()
        return self

    def stop(self):
        with _LIFECYCLE_LOCK:
            httpd = self._httpd
            if httpd is not None:
                # close before publishing None, so a racing restart
                # never binds while the old socket still listens
                httpd.shutdown()
                httpd.server_close()
                self._httpd = None
                self._thread = None
