"""HTTP model serving (the reference's ``ParallelInference`` deployments /
libnd4j ``GraphServer`` role), one model or a multi-tenant platform.

Counterpart of the JAX package's ``parallel/serving.py``: a stdlib
``ThreadingHTTPServer`` whose concurrent ``/predict`` callers are coalesced
into shared device launches by an
:class:`~deeplearning4j_tpu_torch.parallel.batcher.InferenceEngine`
(``batching=None`` serializes one request at a time instead). Endpoints:

- ``POST /predict``  body ``{"inputs": [...]}`` (nested lists, one array
  per network input, NHWC for images) -> ``{"outputs": [...]}``; 400 on a
  malformed body or input, 503 when the queue is full, the deadline
  expired, the breaker is open or the launch watchdog fired
- ``GET  /model``    model summary + input/output metadata
- ``GET  /healthz``  liveness (+ queue depth and breaker state)
- ``GET  /metrics``  Prometheus scrape of the telemetry registry

Integer-valued image inputs in [0, 255] ride as uint8 and are scaled by
1/255 on the device, as the JAX package's ``nn/io.py`` defines.

Multi-tenant mode: construct with a
:class:`~deeplearning4j_tpu_torch.parallel.platform.ModelPlatform` instead
of a model and the server grows per-model routes —

- ``POST /predict/<model>`` (alias ``/models/<model>/predict``) routes
  through the platform's canary-aware router. An unknown model (or a bare
  ``/predict``) is a NAMED 404 listing the deployed models — never a
  ``KeyError`` 500. Every 503 body carries ``model`` / ``scope`` /
  ``breaker`` fields so a client can tell "this model is shedding"
  (``scope="model"``) from "host overloaded" (``scope="host"``).
- ``GET /models``     per-tenant platform stats (versions, canary,
  breakers, warmup budgets)
- ``GET /healthz``    per-model breaker/queue block; ``status`` becomes
  ``"shedding"`` when ANY tenant's breaker is open
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.parallel.batcher import (
    BadRequestError,
    BatchingConfig,
    CircuitOpenError,
    DeadlineExpiredError,
    InferenceEngine,
    LaunchTimeoutError,
    ServerOverloadedError,
)
from deeplearning4j_tpu_torch.parallel.platform import (
    HostOverloadedError,
    ModelPlatform,
    UnknownModelError,
)
from deeplearning4j_tpu_torch.telemetry import tracing


class InferenceServer:
    """Serve a ``ComputationGraph`` or a ``MultiLayerNetwork`` (an int8
    artifact of ``nn.inference_opt.quantize_for_inference`` included), or
    every tenant of a ``ModelPlatform``.

    Usage::

        server = InferenceServer(net).start(port=0, warmup=True)
        # POST http://127.0.0.1:{server.port}/predict {"inputs": [[...]]}
        server.stop()

    ``batching``: a :class:`BatchingConfig` (or the default one) routes
    concurrent ``/predict`` requests through the shared-launch engine;
    ``None`` serializes forwards under one lock. ``graph_opt``/``bf16``
    forward to the engine's inference-graph pass (all three are ignored in
    platform mode: each tenant brings its own engine).
    """

    def __init__(self, model, dtype=np.float32,
                 batching: Union[BatchingConfig, None] = ...,
                 graph_opt: bool = True, bf16: bool = False):
        self.platform: Optional[ModelPlatform] = (
            model if isinstance(model, ModelPlatform) else None)
        self.model = None if self.platform is not None else model
        self.dtype = dtype
        self._httpd = None
        self._thread = None
        self.port: Optional[int] = None
        self._lock = threading.Lock()  # batching=None: one forward at a time
        if batching is ...:
            batching = BatchingConfig()
        self.engine: Optional[InferenceEngine] = None
        self._uint8_cache: dict = {}  # platform mode: per-tenant flags
        if self.platform is not None:
            # platform mode: the server is pure routing + error surfaces
            self._uint8_inputs = ()
            return
        if batching is not None:
            self.engine = InferenceEngine(model, batching,
                                          graph_opt=graph_opt, bf16=bf16)
        # uint8 eligibility per input index is static: walk the conf once
        # here, not per request in the /predict hot path
        self._uint8_inputs = tuple(
            self._uint8_input(i) for i in range(self._expected_inputs()))

    # --- inference ----------------------------------------------------------
    def _expected_inputs(self, model=None) -> int:
        net = self.model if model is None else model
        conf = getattr(net, "conf", None)
        if conf is not None and hasattr(conf, "network_inputs"):
            return len(conf.network_inputs)
        return 1

    def _uint8_input(self, idx: int, model=None) -> bool:
        """Whether input ``idx`` is an image-typed feature the model
        dequantizes on the device."""
        from deeplearning4j_tpu_torch.nn import io as nn_io

        net = self.model if model is None else model
        conf = getattr(net, "conf", None)
        if conf is None:
            return False
        if hasattr(conf, "network_inputs"):
            types = list(getattr(conf, "input_types", ()) or ())
            t = types[idx] if idx < len(types) else None
        else:  # MultiLayerNetwork: one input
            t = getattr(conf, "input_type", None)
        return t is not None and nn_io.image_input(t)

    def _parse_inputs(self, inputs):
        """Client-error surface: arity + array conversion problems raise
        ValueError (mapped to 400), never reach the model as a 500.
        Integer-valued image inputs ride as uint8 instead of being up-cast
        to float."""
        expected = self._expected_inputs()
        if len(inputs) != expected:
            raise ValueError(
                f"model takes {expected} input array(s), got {len(inputs)}")
        out = []
        for i, a in enumerate(inputs):
            try:
                arr = np.asarray(a)
                if arr.dtype == object:
                    raise ValueError("ragged nested lists")
                if (np.issubdtype(arr.dtype, np.integer)
                        and self._uint8_inputs[i] and arr.size
                        and 0 <= arr.min() and arr.max() <= 255):
                    arr = arr.astype(np.uint8)
                elif arr.dtype != np.dtype(self.dtype):
                    arr = arr.astype(self.dtype)
            except (ValueError, TypeError) as e:
                raise ValueError(f"malformed input array: {e}")
            out.append(arr)
        return out

    def _predict(self, xs, traceparent=None):
        """-> (outputs, trace-or-None); the trace rides back so the handler
        can echo its ``traceparent`` on the response."""
        if self.engine is not None:
            out, trace = self.engine.predict_traced(
                *xs, traceparent=traceparent)
        else:
            trace = tracing.start_trace("predict", traceparent=traceparent)
            try:
                with self._lock:
                    out = self.model.output(*xs)
            except BaseException:
                tracing.finish_trace(trace, "error")
                raise
            tracing.finish_trace(trace, "ok")
        outs = out if isinstance(out, list) else [out]
        return [np.asarray(o).tolist() for o in outs], trace

    # --- platform (multi-tenant) routing ------------------------------------
    def _resolve_predict_path(self, path: str):
        """-> (model_name_or_None, error_payload_or_None). Single-model
        mode accepts exactly ``/predict``; platform mode requires a model
        segment and 404s BY NAME (listing the deployed models) instead of
        letting a missing tenant surface as a 500."""
        if self.platform is None:
            if path == "/predict":
                return None, None
            return None, {"error": "not found"}
        name = None
        if path.startswith("/predict/"):
            name = path[len("/predict/"):]
        elif path.startswith("/models/") and path.endswith("/predict"):
            name = path[len("/models/"):-len("/predict")]
        if not name:
            return None, {
                "error": "no model in path; POST /predict/<model>",
                "models": self.platform.models()}
        if "/" in name:
            return None, {"error": "not found"}
        return name, None

    def _platform_uint8_flags(self, engine) -> tuple:
        """Per-tenant uint8 eligibility, cached per tenant and validated
        against the LIVE model by identity (a weakref, not a bare ``id()``
        — after a hot swap frees the old model, CPython may reuse its
        address for the new one, and stale flags would route a non-image
        input down the uint8 path)."""
        import weakref

        model = engine.model
        with self._lock:
            entry = self._uint8_cache.get(engine.name)
            if entry is not None and entry[0]() is model:
                return entry[1]
            flags = tuple(
                self._uint8_input(i, model)
                for i in range(self._expected_inputs(model)))
            try:
                ref = weakref.ref(model)
            except TypeError:  # unweakrefable model type: never cache
                return flags
            self._uint8_cache[engine.name] = (ref, flags)
        return flags

    def _predict_platform(self, name: str, inputs, traceparent=None):
        """Parse + route one multi-tenant request: generic JSON→array
        conversion (arity / shape / dtype validation lives in the tenant's
        engine, mapped to 400); integer image payloads ride as uint8
        exactly like the single-model path."""
        xs = []
        flags = None
        for i, a in enumerate(inputs):
            try:
                arr = np.asarray(a)
                if arr.dtype == object:
                    raise ValueError("ragged nested lists")
            except (ValueError, TypeError) as e:
                # numpy raises on inhomogeneous nesting (or yields an
                # object array): the sender's 400, not a host 500
                raise BadRequestError(f"malformed input array: {e}")
            if np.issubdtype(arr.dtype, np.integer) and arr.size \
                    and 0 <= arr.min() and arr.max() <= 255:
                if flags is None:
                    flags = self._platform_uint8_flags(
                        self.platform.engine(name))
                if i < len(flags) and flags[i]:
                    arr = arr.astype(np.uint8)
            xs.append(arr)
        out, trace = self.platform.predict_traced(
            name, *xs, traceparent=traceparent)
        outs = out if isinstance(out, list) else [out]
        return [np.asarray(o).tolist() for o in outs], trace

    def _shed_payload(self, e: Exception, name: Optional[str]) -> dict:
        """The 503 body: which scope is shedding (this model vs the whole
        host) and the model's breaker state, so a client can back off per
        model instead of abandoning the host."""
        payload = {"error": str(e)}
        if isinstance(e, HostOverloadedError):
            payload["scope"] = "host"
            return payload
        payload["scope"] = "model"
        if name is not None:
            payload["model"] = name
        breaker = None
        if self.platform is not None and name is not None:
            try:
                breaker = self.platform.engine(name).breaker
            except UnknownModelError:
                breaker = None
        elif self.engine is not None:
            breaker = self.engine.breaker
        if breaker is not None:
            payload["breaker"] = breaker.state
        return payload

    def _platform_health(self) -> dict:
        """Per-model readiness: any open breaker flips the host status to
        "shedding" and names the models doing it."""
        stats = self.platform.stats()
        payload = {"status": "ok", "models": {}}
        shedding = []
        for name, row in stats.items():
            entry = {k: row[k] for k in ("version", "queue_depth",
                                         "breaker") if k in row}
            if "canary" in row:
                entry["canary"] = {
                    k: row["canary"][k]
                    for k in ("version", "fraction", "breaker")}
            if "generation" in row:
                entry["generation"] = {
                    k: row["generation"][k]
                    for k in ("version", "queue_depth", "breaker")}
            states = [entry.get("breaker"),
                      entry.get("canary", {}).get("breaker"),
                      row.get("generation", {}).get("breaker")]
            if "open" in states:
                shedding.append(name)
            payload["models"][name] = entry
        if shedding:
            payload["status"] = "shedding"
            payload["shedding_models"] = shedding
        return payload

    def warmup(self, **kw) -> dict:
        """Run every padding bucket once (engine ``warmup``); a no-op dict
        under ``batching=None``."""
        if self.engine is None:
            return {"buckets": [], "forwards": 0}
        return self.engine.warmup(**kw)

    def _model_info(self) -> dict:
        net = self.model
        info = {"type": type(net).__name__}
        conf = getattr(net, "conf", None)
        if conf is not None and hasattr(conf, "network_inputs"):
            info["inputs"] = list(conf.network_inputs)
            info["outputs"] = list(conf.network_outputs)
        if hasattr(net, "num_params"):
            info["num_params"] = int(net.num_params())
        if hasattr(net, "device"):
            info["device"] = str(net.device)
        if self.engine is not None:
            info["batching"] = dataclasses.asdict(self.engine.config)
            info["buckets"] = self.engine.buckets()
        return info

    # --- lifecycle ----------------------------------------------------------
    def start(self, port: int = 0, host: str = "127.0.0.1",
              max_body_bytes: int = 64 * 1024 * 1024,
              warmup: bool = False):
        import http.server

        if self._httpd is not None:
            return self
        if self.engine is not None and self.engine._stop:
            # restart after stop(): re-arm the dispatcher on the already
            # optimized serving model (no second graph_opt pass)
            self.engine = InferenceEngine(self.engine.model,
                                          self.engine.config,
                                          graph_opt=False,
                                          breaker=self.engine.breaker,
                                          retry=self.engine.retry)
        if warmup:
            self.warmup()
        srv = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code: int, payload: dict,
                      traceparent: Optional[str] = None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if traceparent:
                    self.send_header("traceparent", traceparent)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    if srv.platform is not None:
                        self._send(200, srv._platform_health())
                        return
                    payload = {"status": "ok"}
                    if srv.engine is not None:
                        payload["queue_depth"] = srv.engine.queue_depth()
                        if srv.engine.breaker is not None:
                            st = srv.engine.breaker.state
                            payload["circuit"] = st
                            if st == "open":
                                # shedding on purpose: readiness probes
                                # should route traffic elsewhere
                                payload["status"] = "shedding"
                    self._send(200, payload)
                elif self.path == "/models" and srv.platform is not None:
                    self._send(200, {"models": srv.platform.stats()})
                elif self.path == "/model":
                    if srv.platform is not None:
                        self._send(404, {
                            "error": "multi-model host; GET /models",
                            "models": srv.platform.models()})
                        return
                    self._send(200, srv._model_info())
                elif self.path == "/metrics":
                    from deeplearning4j_tpu_torch import telemetry

                    body = telemetry.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                # W3C trace-context propagation: error responses echo the
                # caller's header so failed requests still correlate
                tp_in = self.headers.get("traceparent")
                name, notfound = srv._resolve_predict_path(self.path)
                if notfound is not None:
                    self._send(404, notfound, traceparent=tp_in)
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length < 0 or length > max_body_bytes:
                    # reject before reading: an oversized request must not
                    # exhaust the serving process's memory
                    self._send(413, {"error": "request body too large"},
                               traceparent=tp_in)
                    return
                try:
                    req = json.loads(self.rfile.read(length))
                    inputs = req["inputs"]
                    if not isinstance(inputs, list) or not inputs:
                        raise ValueError("inputs must be a non-empty list")
                    if name is None:
                        xs = srv._parse_inputs(inputs)
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, {"error": str(e)}, traceparent=tp_in)
                    return
                try:
                    outs, trace = (
                        srv._predict(xs, traceparent=tp_in)
                        if name is None
                        else srv._predict_platform(name, inputs,
                                                   traceparent=tp_in))
                except UnknownModelError as e:
                    # a missing tenant is the CLIENT's addressing error: a
                    # named 404 listing what IS deployed
                    self._send(404, {"error": str(e),
                                     "models": srv.platform.models()},
                               traceparent=tp_in)
                    return
                except BadRequestError as e:
                    self._send(400, {"error": str(e)}, traceparent=tp_in)
                    return
                except (ServerOverloadedError, DeadlineExpiredError,
                        CircuitOpenError, LaunchTimeoutError) as e:
                    self._send(503, srv._shed_payload(e, name),
                               traceparent=tp_in)
                    return
                except Exception as e:  # model/runtime failure -> 500 JSON
                    self._send(500, {"error": f"{type(e).__name__}: {e}"},
                               traceparent=tp_in)
                    return
                self._send(200, {"outputs": outs},
                           traceparent=(trace.traceparent()
                                        if trace is not None else tp_in))

            def log_message(self, *args):
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self.port = None
        if self.engine is not None:
            self.engine.close()
        return self
