"""HTTP front for the model host.

The counterpart of ``deeplearning4j_tpu/serving/server.py``:
``InferenceServer`` puts a ``ModelHost`` behind the stdlib serving
scaffold (``util/httpserve``); each connection's handler thread blocks
on its own request while the micro-batcher coalesces them into
dispatches (``:predict``) or a scheduler batches them per step
(``:generate``).

Routes:

* ``GET /healthz`` — readiness: 503 until the warmup hook
  (``ModelHost.warm_all`` by default: every batch bucket and slot
  bucket run once, kernels built) returns.
* ``GET /metrics`` — Prometheus text exposition of the registry.
* ``GET /v1/models`` — the model policy table.
* ``GET /v1/models/<name>`` — one model's policy row (404).
* ``POST /v1/models/<name>:predict`` — one-shot inference through the
  model's micro-batcher: ``{"instances": [...], "deadlineMs":
  optional}`` -> ``{"predictions": [...], "model": ..., "version":
  ..., "rows": n}``. Each in-flight request blocks its handler thread
  on its slice of a coalesced dispatch.
* ``POST /v1/models/<name>:generate`` — a token prompt for a paged LM,
  ``{"tokens": [...], "maxNewTokens": optional, "deadlineMs":
  optional}`` -> ``{"tokens": [...], "model": ..., "version": ...,
  "steps": n}``; or per-step features for a recurrent network,
  ``{"steps": [[...], ...], "extraSteps": optional, "deadlineMs":
  optional}`` -> ``{"outputs": [[...], ...], "model": ..., "version":
  ..., "steps": n}`` through the carry-slot scheduler.

Status contract: queue full or KV pool full -> 429, deadline exceeded
-> 504, draining/closed -> 503, unknown model -> 404, malformed request
-> 400. Every failure mode has a status code and the client is always
released.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.runtime import telemetry
from deeplearning4j_tpu_torch.runtime.chaos import fault_point
from deeplearning4j_tpu_torch.serving.kvcache import KVCacheFullError
from deeplearning4j_tpu_torch.serving.queue import (
    DeadlineExceededError, QueueFullError, ServingClosedError,
)
from deeplearning4j_tpu_torch.util.httpserve import (
    HttpError, HttpServerOwner, JsonHandler,
)

__all__ = ["InferenceServer"]


class _InferenceHandler(JsonHandler):
    @classmethod
    def metric_route(cls, path):
        """Bounded route labels for the dl4j_http_* instruments (model
        names collapse into one label, so requests cannot grow the
        registry)."""
        path = path.rstrip("/") or "/"
        if path == "/healthz":
            return "healthz"
        if path == "/metrics":
            return "metrics"
        if path == "/v1/models":
            return "models"
        if path.endswith(":predict"):
            return "predict"
        if path.endswith(":generate"):
            return "generate"
        if path.startswith("/v1/models/"):
            return "model"
        return "other"

    def handle_GET(self):
        fault_point("server.request")
        host = self._owner().host
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/metrics":
            return self._send(
                200, telemetry.get_registry().prometheus(),
                "text/plain; version=0.0.4; charset=utf-8")
        if path == "/v1/models":
            return self._json({"models": host.describe()})
        if path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):]
            resolve = host.sequence_model \
                if host.kind(name) == "sequence" else host.model
            try:
                return self._json(resolve(name).policy())
            except KeyError as e:
                raise HttpError(404, str(e))
        raise HttpError(404, f"no route {path}")

    def handle_POST(self):
        fault_point("server.request")
        host = self._owner().host
        path = self.path.split("?", 1)[0]
        if path.startswith("/v1/models/") and path.endswith(":generate"):
            return self._handle_generate(
                host, path[len("/v1/models/"):-len(":generate")])
        if path.startswith("/v1/models/") and path.endswith(":predict"):
            return self._handle_predict(
                host, path[len("/v1/models/"):-len(":predict")])
        raise HttpError(404, f"no route {path}")

    def _handle_predict(self, host, name):
        """POST :predict: one request through the model's micro-batcher;
        the deadline bounds queue wait and dispatch together."""
        try:
            body = self._read_json_object()
        except ValueError as e:
            raise HttpError(400, str(e))
        instances = body.get("instances")
        if instances is None:
            raise HttpError(400, 'body must carry "instances": [...]')
        try:
            feats = np.asarray(instances, dtype=np.float32)
            deadline_ms = body.get("deadlineMs")
            deadline_s = None if deadline_ms is None \
                else float(deadline_ms) / 1000.0
        except (TypeError, ValueError) as e:
            raise HttpError(400, f"instances/deadlineMs malformed: {e}")
        try:
            # a request that loses the race against a rolling swap is
            # re-routed to the new version, which then answers it
            sm, out = host._routed(host.model, name, lambda sm: (
                sm, sm.submit(feats, deadline_s=deadline_s)))
        except KeyError as e:
            raise HttpError(404, str(e))
        except ValueError as e:       # the shape/rows contract
            raise HttpError(400, str(e))
        except QueueFullError as e:   # backpressure, never a hang
            raise HttpError(429, str(e))
        except DeadlineExceededError as e:
            raise HttpError(504, str(e))
        except ServingClosedError as e:
            raise HttpError(503, str(e))
        preds = [np.asarray(o).tolist() for o in out] \
            if isinstance(out, list) else np.asarray(out).tolist()
        return self._json({"predictions": preds, "model": sm.name,
                           "version": sm.version, "rows": len(feats)})

    def _handle_generate(self, host, name):
        """POST :generate: a "tokens" prompt through the paged scheduler
        or "steps" features through the carry-slot one; the deadline is
        honored per step."""
        try:
            body = self._read_json_object()
        except ValueError as e:
            raise HttpError(400, str(e))
        steps = body.get("steps")
        tokens = body.get("tokens")
        if steps is None and tokens is None:
            raise HttpError(
                400, 'body must carry "steps": [[...], ...] (feature '
                'sequence) or "tokens": [...] (paged token prompt)')
        try:
            deadline_ms = body.get("deadlineMs")
            deadline_s = None if deadline_ms is None \
                else float(deadline_ms) / 1000.0
            max_new = int(body.get("maxNewTokens", 1))
            extra = int(body.get("extraSteps", 0))
            if tokens is not None:
                toks = np.asarray(tokens, dtype=np.int64)
            else:
                feats = np.asarray(steps, dtype=np.float32)
        except (TypeError, ValueError, OverflowError) as e:
            raise HttpError(
                400, "tokens/steps/deadlineMs/maxNewTokens/extraSteps "
                f"malformed: {e}")
        try:
            if tokens is not None:
                out = host.generate(name, toks, deadline_s=deadline_s,
                                    max_new_tokens=max_new)
            else:
                out = host.submit_sequence(name, feats,
                                           deadline_s=deadline_s,
                                           extra_steps=extra)
            sm = host.sequence_model(name)  # post-submit: live version
        except KeyError as e:
            raise HttpError(404, str(e))
        except ValueError as e:
            raise HttpError(400, str(e))
        except (KVCacheFullError, QueueFullError) as e:
            raise HttpError(429, str(e))   # backpressure, never a hang
        except DeadlineExceededError as e:
            raise HttpError(504, str(e))
        except ServingClosedError as e:
            raise HttpError(503, str(e))
        out = np.asarray(out)
        if tokens is None:
            return self._json({"outputs": out.tolist(), "model": sm.name,
                               "version": sm.version,
                               "steps": int(out.shape[0])})
        return self._json({"tokens": [int(t) for t in out],
                           "model": sm.name, "version": sm.version,
                           "steps": int(out.shape[0])})


class InferenceServer(HttpServerOwner):
    """Loopback HTTP server over a ModelHost (module docstring)."""

    def __init__(self, host):
        self.host = host

    def start(self, port=0, requestDeadline=None, warmup=True):
        """Bind and serve. warmup=True gates /healthz on
        ``host.warm_all()``; pass a callable for a custom hook, or
        None/False to report ready immediately."""
        w = self.host.warm_all if warmup is True else (warmup or None)
        return self._serve(_InferenceHandler, port,
                           requestDeadline=requestDeadline, warmup=w)

    def stop(self, close_host=False):
        """Stop the listener; close_host=True also drains the host."""
        super().stop()
        if close_host:
            self.host.close(drain=True)
