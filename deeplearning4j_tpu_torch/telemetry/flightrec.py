"""Flight recorder: the last steps of a run and crash bundles.

Counterpart of the JAX package's ``telemetry/flightrec.py``. A crashed or
halted run leaves a self-contained bundle behind: what the last steps
looked like (score, guard vector, rate, seed, batch shapes), what the
telemetry counters said and where the time went.

- :class:`FlightRecorder` keeps a bounded ring of step records. Scores and
  guard vectors are kept as device tensors and reach the host only when a
  bundle is written, so recording a step is a dict append (no
  synchronization).
- :meth:`FlightRecorder.dump_bundle` writes::

      <dir>/
        manifest.json   # reason, health report, config digest, env, versions
        records.jsonl   # one step record a line, oldest first
        trace.json      # Chrome trace of the span ring
        traces.json     # the retained request traces (telemetry.tracing)
        metrics.json    # the registry snapshot and phase statistics

  Non-finite floats are written as the strings ``"NaN"`` / ``"Infinity"``
  / ``"-Infinity"``, so every file parses as strict JSON. Bundles are
  pruned to the newest ``DL4J_FLIGHTREC_KEEP`` (default 16) siblings, under
  ``DL4J_FLIGHTREC_DIR`` (default ``flightrec``) unless a directory is
  given.
- :func:`flight_recorder` is the context every ``fit`` runs in: an
  exception escaping it (``health.DivergenceError`` among them) dumps a
  bundle once and is re-raised. Disabled (the default), it is a bare
  ``yield``.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import os
import shutil
import time
from typing import Optional, Sequence

from deeplearning4j_tpu_torch.telemetry import health as _health


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def batch_fingerprint(*arrays) -> list:
    """The identity of a batch without reading it: ``[shape, dtype]`` an
    array (None passes through; lists and tuples nest)."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        elif isinstance(a, (tuple, list)):
            out.append(batch_fingerprint(*a))
        else:
            out.append([list(getattr(a, "shape", ())),
                        _dtype_name(getattr(a, "dtype", "?"))])
    return out


def sanitize_json(obj):
    """Non-finite floats as the strings ``"NaN"`` / ``"Infinity"`` /
    ``"-Infinity"``, so the JSON written is strict."""
    if isinstance(obj, float):
        if obj != obj:
            return "NaN"
        if obj == float("inf"):
            return "Infinity"
        if obj == float("-inf"):
            return "-Infinity"
        return obj
    if isinstance(obj, dict):
        return {k: sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_json(v) for v in obj]
    return obj


def _materialize(x):
    """A device scalar / vector as a plain JSON value (bundle time)."""
    import numpy as np
    import torch

    if x is None:
        return None
    try:
        if isinstance(x, torch.Tensor):
            arr = x.detach().to("cpu", torch.float64).numpy()
        else:
            arr = np.asarray(x, np.float64)
    except Exception:
        return "unavailable"
    if arr.ndim == 0:
        return float(arr)
    return [float(v) for v in arr.ravel()]


class FlightRecorder:
    """Ring of step records and the bundle writer."""

    def __init__(self, capacity: int = 256):
        self._ring = collections.deque(maxlen=int(capacity))
        self._enabled = False
        self.last_bundle: Optional[str] = None
        self._conf_digest: Optional[str] = None

    # --- switches -----------------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> "FlightRecorder":
        if capacity is not None and capacity != self._ring.maxlen:
            self._ring = collections.deque(self._ring, maxlen=int(capacity))
        self._enabled = True
        return self

    def disable(self) -> "FlightRecorder":
        self._enabled = False
        return self

    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> "FlightRecorder":
        self._ring.clear()
        self.last_bundle = None
        return self

    # --- recording ----------------------------------------------------------
    def record_step(self, path: str, step: int, epoch: int, score=None,
                    guard=None, guard_keys: Sequence[str] = (),
                    lr=None, rng_seed=None, batch_fp=None) -> None:
        if not self._enabled:
            return
        self._ring.append({
            "path": path,
            "step": int(step),
            "epoch": int(epoch),
            "score": score,            # device scalar until a dump
            "guard": guard,            # device guard vector (or None)
            "guard_keys": list(guard_keys),
            "lr": lr,
            "rng_seed": rng_seed,
            "batch": batch_fp,
            "wall_time": time.time(),
        })

    def set_config_digest(self, conf_json: str) -> None:
        """The sha256 of the model's configuration, in the manifest."""
        self._conf_digest = hashlib.sha256(
            conf_json.encode("utf-8", "replace")).hexdigest()

    def records(self) -> list:
        """Host copies of the ring's records, oldest first."""
        out = []
        for r in list(self._ring):
            r = dict(r)
            for k in ("score", "guard", "lr"):
                r[k] = _materialize(r[k])
            out.append(r)
        return out

    # --- bundles ------------------------------------------------------------
    def dump_bundle(self, directory: Optional[str] = None,
                    reason: str = "manual") -> str:
        """Write a bundle and return its directory. It writes what it can:
        a part that fails is left out rather than raised."""
        from deeplearning4j_tpu_torch.telemetry import export, spans, tracing

        if directory is None:
            root = os.environ.get("DL4J_FLIGHTREC_DIR", "flightrec")
            directory = os.path.join(
                root, f"bundle_{int(time.time())}_{os.getpid()}")
        os.makedirs(directory, exist_ok=True)
        try:
            trace_snap = tracing.snapshot()
        except Exception:
            trace_snap = None
        records = self.records()
        with open(os.path.join(directory, "records.jsonl"), "w") as f:
            for r in records:
                f.write(json.dumps(sanitize_json(r)) + "\n")
        try:
            health_report = _health.report()
        except Exception:
            health_report = None
        env = {k: v for k, v in os.environ.items()
               if k.startswith(("DL4J_", "CUDA_", "TORCH_"))}
        versions = {}
        try:
            import torch

            versions["torch"] = torch.__version__
            versions["cuda"] = torch.version.cuda
            if torch.cuda.is_available():
                versions["devices"] = [torch.cuda.get_device_name(i)
                                       for i in range(
                                           torch.cuda.device_count())]
        except Exception:
            pass
        manifest = {
            "format_version": 1,
            "created_at": time.time(),
            "reason": reason,
            "n_records": len(records),
            "health": health_report,
            "config_digest": self._conf_digest,
            "env": env,
            "versions": versions,
            "request_trace_ids": (
                [t["trace_id"] for t in trace_snap["traces"]]
                if trace_snap else []),
            "files": ["manifest.json", "records.jsonl", "trace.json",
                      "traces.json", "metrics.json"],
        }
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(sanitize_json(manifest), f, indent=2)
        try:
            spans.export_chrome_trace(os.path.join(directory, "trace.json"))
        except Exception:
            pass
        try:
            if trace_snap is not None:
                with open(os.path.join(directory, "traces.json"), "w") as f:
                    json.dump(sanitize_json(trace_snap), f)
        except Exception:
            pass
        try:
            with open(os.path.join(directory, "metrics.json"), "w") as f:
                json.dump(sanitize_json(export.telemetry_record()), f)
        except Exception:
            pass
        self.last_bundle = directory
        try:
            self._prune_siblings(directory)
        except Exception:
            pass  # retention never fails the dump
        return directory

    @staticmethod
    def _prune_siblings(directory: str) -> None:
        """Keep the newest ``DL4J_FLIGHTREC_KEEP`` (default 16; <= 0 keeps
        all) ``bundle_*`` siblings, by mtime, the new one among them."""
        keep = int(os.environ.get("DL4J_FLIGHTREC_KEEP", "16"))
        if keep <= 0:
            return
        root = os.path.dirname(os.path.abspath(directory)) or "."
        bundles = []
        for name in os.listdir(root):
            p = os.path.join(root, name)
            if name.startswith("bundle_") and os.path.isdir(p):
                bundles.append((os.path.getmtime(p), p))
        bundles.sort(reverse=True)
        for _, p in bundles[keep:]:
            shutil.rmtree(p, ignore_errors=True)


RECORDER = FlightRecorder()


def record_step(*args, **kw) -> None:
    """Module-level hot path (one flag check while disabled)."""
    rec = RECORDER
    if rec._enabled:
        rec.record_step(*args, **kw)


@contextlib.contextmanager
def flight_recorder(directory: Optional[str] = None, model=None):
    """The context a ``fit`` runs in: an exception escaping it dumps a
    bundle (once: nested fits mark the exception) and is re-raised. A bare
    ``yield`` while the recorder is disabled."""
    rec = RECORDER
    if not rec._enabled:
        yield rec
        return
    if model is not None:
        # per fit: the digest names this run's network
        try:
            rec.set_config_digest(model.conf.to_json())
        except Exception:
            pass
    try:
        yield rec
    except BaseException as e:
        # BaseException: a Ctrl-C on a diverging run leaves a bundle too
        if not getattr(e, "_dl4j_flightrec_dumped", False):
            try:
                reason = (f"DivergenceError: {e}"
                          if isinstance(e, _health.DivergenceError)
                          else f"{type(e).__name__}: {e}")
                rec.dump_bundle(directory, reason=reason)
                e._dl4j_flightrec_dumped = True
            except Exception:
                pass  # never mask the original failure
        raise
