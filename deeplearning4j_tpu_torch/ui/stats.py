"""Stats collection (reference ``org.deeplearning4j.ui.stats.StatsListener``
+ ``StatsStorage``).

Counterpart of the JAX package's ``ui/stats.py``: the same records, the
same JSONL file (a ``FileStatsStorage`` file written by either package
reads in the other) and the same remote router. The listener brings the
params to the host in one copy a collection; the system block reads
``torch.cuda`` memory where the JAX package reads its devices'
allocator stats."""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


class StatsStorage:
    """Storage contract (reference ``StatsStorage``): ordered records per
    session."""

    def put(self, record: dict) -> None:
        raise NotImplementedError

    def records(self) -> List[dict]:
        raise NotImplementedError


class InMemoryStatsStorage(StatsStorage):
    """Reference class of the same name."""

    def __init__(self):
        self._records: List[dict] = []

    def put(self, record):
        self._records.append(record)

    def records(self):
        return list(self._records)


class FileStatsStorage(StatsStorage):
    """JSONL-on-disk storage (reference ``FileStatsStorage`` uses MapDB;
    JSONL keeps it greppable and append-only). Corrupt or truncated lines
    (a run killed mid-write, a partial copy) are SKIPPED on load — counted
    in ``corrupt_lines`` — instead of poisoning every later read: the
    reference reopens damaged MapDB files the same forgiving way."""

    def __init__(self, path: str):
        self.path = str(path)
        self._records: List[dict] = []
        self.corrupt_lines = 0
        try:
            with open(self.path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        self.corrupt_lines += 1
                        continue
                    if isinstance(rec, dict):
                        self._records.append(rec)
                    else:
                        self.corrupt_lines += 1
        except FileNotFoundError:
            pass

    def put(self, record):
        self._records.append(record)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def records(self):
        return list(self._records)


class RemoteUIStatsStorageRouter(StatsStorage):
    """POSTs each record to a remote ``UIServer`` (reference class of the
    same name: listeners on worker machines route stats to a central
    dashboard). Delivery is ASYNC with retries, like the reference's
    queued router: a dashboard outage must never crash or stall the
    training loop. Records are also kept locally so ``records()`` works;
    ``dropped`` counts records that exhausted their retries."""

    def __init__(self, url: str, retries: int = 3, timeout: float = 10.0):
        import queue

        from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy

        self.url = url.rstrip("/")
        self.retries = int(retries)
        self.timeout = float(timeout)
        self.dropped = 0
        self._records: List[dict] = []
        self._q: "queue.Queue" = queue.Queue()
        self._thread = None
        # retry EVERYTHING here (not just the transient classes): a
        # delivery failure's only downside is a dropped dashboard record,
        # and the historical contract was retries-then-drop for any error
        # (retries=0 stays the historical drop-without-attempting config)
        self._retry = RetryPolicy(max_attempts=self.retries,
                                  base_delay_s=0.2, multiplier=1.5,
                                  jitter=0.25, retryable=(Exception,),
                                  name="stats.flush") \
            if self.retries >= 1 else None

    def _ensure_thread(self):
        import threading

        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True)
            self._thread.start()

    def _post(self, data: bytes) -> None:
        """One delivery attempt (the ``stats.flush`` fault site — a chaos
        plan exercises exactly the path a dashboard outage would)."""
        import urllib.request

        from deeplearning4j_tpu_torch.resilience import faults

        faults.fault_point("stats.flush")
        req = urllib.request.Request(
            self.url + "/train/post", data=data,
            headers={"Content-Type": "application/json"})
        # no proxy: a proxy variable must never send the dashboard's
        # records elsewhere
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(req, timeout=self.timeout) as resp:
            resp.read()

    def _worker(self):
        while True:
            record = self._q.get()
            try:
                try:
                    data = json.dumps(record).encode()
                except (TypeError, ValueError):
                    self.dropped += 1  # unserializable record: drop, keep
                    continue           # the worker alive
                if self._retry is None:
                    self.dropped += 1  # retries=0: drop, never deliver
                    continue
                try:
                    self._retry.call(self._post, data, op="stats.flush")
                except Exception:
                    self.dropped += 1  # retries exhausted: drop, keep
            finally:                   # the worker alive
                self._q.task_done()

    def put(self, record):
        self._records.append(record)
        self._q.put(record)
        self._ensure_thread()

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait until queued records are delivered (or dropped)."""
        # monotonic: a wall-clock adjustment mid-flush must not extend
        # or truncate the wait (same contract as the earlystopping and
        # checkpoint timers)
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.02)
        return self._q.unfinished_tasks == 0

    def records(self):
        return list(self._records)


def _np(t) -> np.ndarray:
    """A tensor (any device) or array as a float numpy array."""
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def _histogram(values: np.ndarray, bins: int) -> Optional[dict]:
    """Fixed-bin histogram record {min, max, counts} (the reference
    ``StatsListener`` ships per-layer histograms to the dashboard's
    parameter/update/activation/gradient panels)."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        return None
    lo, hi = float(v.min()), float(v.max())
    if lo == hi:
        hi = lo + 1e-12
    counts, _ = np.histogram(v, bins=bins, range=(lo, hi))
    return {"min": lo, "max": hi, "counts": counts.tolist()}


def _layer_histograms(tree, bins: int) -> Dict[str, dict]:
    """One histogram per layer over the concatenation of its tensors."""
    out = {}
    for layer_idx, params in (tree or {}).items():
        arrs = ([_np(v).ravel() for v in params.values()]
                if isinstance(params, dict)
                else [_np(params).ravel()])
        if not arrs:
            continue
        h = _histogram(np.concatenate(arrs) if len(arrs) > 1 else arrs[0],
                       bins)
        if h is not None:
            out[str(layer_idx)] = h
    return out


def _mean_magnitude(tree) -> Dict[str, float]:
    out = {}
    for layer_idx, params in (tree or {}).items():
        if not isinstance(params, dict) or not params:
            continue
        total, count = 0.0, 0
        for v in params.values():
            a = _np(v)
            total += float(np.abs(a).sum())
            count += a.size
        if count:
            out[str(layer_idx)] = total / count
    return out


class StatsListener(TrainingListener):
    """Computes DL4J's dashboard stats each ``frequency`` iterations:
    score, examples/sec, per-layer parameter mean magnitude, UPDATE mean
    magnitude (params delta since the previous collection), and the
    log10(update/param) ratio — the reference's signature learning-rate
    diagnostic (healthy ≈ -3).

    ``histograms=True`` additionally records per-layer parameter and
    UPDATE histograms (round 3, the reference dashboard's signature
    panels); with a ``sample_ds`` it also records per-layer ACTIVATION
    histograms (via ``model.feed_forward``) and GRADIENT histograms (via
    ``model.compute_gradient_and_score``) on that fixed probe batch.
    Histogram cost is one host d2h of params (+ one extra fwd/bwd when
    ``sample_ds`` is set) per collection — raise ``frequency`` to
    amortize; measured in tests/test_training_tools.py."""

    def __init__(self, storage: StatsStorage, frequency: int = 1,
                 session_id: Optional[str] = None,
                 histograms: bool = False, histogram_bins: int = 20,
                 sample_ds=None, system_metrics: bool = True):
        self.storage = storage
        self.frequency = max(1, int(frequency))
        self.session_id = session_id or f"session_{int(time.time())}"
        self.histograms = bool(histograms)
        self.histogram_bins = int(histogram_bins)
        self.sample_ds = sample_ds
        self.system_metrics = bool(system_metrics)
        self._prev_params = None
        self._last_time = None

    def _host_params(self, model):
        """Every float param on the host in one copy (one device-to-host
        transfer of their concatenation), as float32 numpy by layer."""
        import torch

        keys = [(k, pk) for k in model.params
                for pk, v in model.params[k].items()
                if isinstance(v, torch.Tensor) and v.is_floating_point()]
        if not keys:
            return {}
        with torch.no_grad():
            flat = torch.cat([model.params[k][pk].detach().reshape(-1)
                              .float() for k, pk in keys]).cpu().numpy()
        out, off = {}, 0
        for k, pk in keys:
            t = model.params[k][pk]
            n = t.numel()
            out.setdefault(k, {})[pk] = flat[off:off + n].reshape(t.shape)
            off += n
        return out

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency:
            return
        now = time.monotonic()
        params = self._host_params(model)
        rec = {
            "session": self.session_id,
            "iteration": int(iteration),
            "epoch": int(epoch),
            "score": float(score),
            "timestamp": time.time(),
            "param_mean_mag": _mean_magnitude(params),
        }
        if self._last_time is not None:
            rec["iter_seconds"] = now - self._last_time
        if self._prev_params is not None:
            updates = {}
            for k, lp in params.items():
                prev = self._prev_params.get(k)
                if isinstance(lp, dict) and prev:
                    updates[k] = {pk: np.asarray(pv) - prev[pk]
                                  for pk, pv in lp.items()}
            upd_mag = _mean_magnitude(updates)
            rec["update_mean_mag"] = upd_mag
            ratios = {}
            for k, u in upd_mag.items():
                p = rec["param_mean_mag"].get(k, 0.0)
                if p > 0 and u > 0:
                    ratios[k] = math.log10(u / p)
            rec["update_param_ratio_log10"] = ratios
            if self.histograms:
                rec["update_histograms"] = _layer_histograms(
                    updates, self.histogram_bins)
        if self.histograms:
            rec["param_histograms"] = _layer_histograms(
                params, self.histogram_bins)
            if self.sample_ds is not None:
                self._probe_histograms(model, rec)
        if self.system_metrics:
            rec["system"] = collect_system_metrics()
        self._prev_params = params
        self._last_time = now
        self.storage.put(rec)

    def _probe_histograms(self, model, rec):
        """Activation + gradient histograms on the fixed probe batch."""
        ds = self.sample_ds
        try:
            feats = getattr(ds, "features", ds)
            if hasattr(model, "network_inputs") or hasattr(
                    model.conf, "network_inputs"):  # ComputationGraph
                feats = feats if isinstance(feats, (list, tuple)) else [feats]
                acts = model.feed_forward(*feats)
            else:
                acts = {str(i): a
                        for i, a in enumerate(model.feed_forward(feats))}
            rec["activation_histograms"] = _layer_histograms(
                {k: _np(v) for k, v in acts.items()},
                self.histogram_bins)
        except Exception:
            pass  # probe must never break training
        try:
            grads, _ = model.compute_gradient_and_score(ds)
            rec["gradient_histograms"] = _layer_histograms(
                {k: {pk: _np(pv) for pk, pv in lg.items()}
                 for k, lg in grads.items()},
                self.histogram_bins)
        except Exception:
            pass  # probe must never break training


def collect_system_metrics() -> dict:
    """Host + device memory snapshot (reference: the dashboard's System
    tab charts JVM/off-heap memory and GPU memory per device). Host RSS
    from /proc (resource as the fallback); device memory from
    ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` per card
    (``{"cpu": {}}`` without one). Collection must never break training:
    every probe is best-effort."""
    out: dict = {}
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        out["host_rss_mb"] = rss_pages * (os.sysconf("SC_PAGE_SIZE")
                                          / 1e6)
    except Exception:
        try:
            import resource
            import sys

            # ru_maxrss is kilobytes on Linux but BYTES on macOS —
            # and this fallback only runs where /proc is absent
            div = 1e6 if sys.platform == "darwin" else 1e3
            out["host_rss_mb"] = (resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / div)
        except Exception:
            pass
    try:
        # the envelope cache's counters (optimize.aot_cache): a first
        # forward at a new envelope shows up next to the memory it costs
        from deeplearning4j_tpu_torch.optimize import aot_cache

        out["aot_cache"] = aot_cache.stats()
    except Exception:
        pass
    try:
        # active sharding plans (sharding.plan registry): compact rows; the
        # full param-path -> spec tables live on /sharding and the
        # System-tab panel
        from deeplearning4j_tpu_torch.sharding import active_plans

        plans = []
        for p in active_plans():
            s = p.explain(fmt="json")
            plans.append({"mesh": s["mesh"], "params": len(s["params"]),
                          "opt_buffers": len(s["opt_state"]),
                          "demoted": sum(1 for r in s["params"]
                                         if r.get("demoted"))})
        if plans:
            out["sharding_plans"] = plans
    except Exception:
        pass
    try:
        # collective-scheduler counters (comms.scheduler): plans built /
        # plan-cache hits
        from deeplearning4j_tpu_torch.comms import scheduler as _comms_sched

        st = _comms_sched.stats()
        if st["plans_built"]:
            out["collective_plans"] = st
    except Exception:
        pass
    try:
        import torch

        devices = {}
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                devices[f"cuda:{i}"] = {
                    "mem_in_use_mb": torch.cuda.memory_allocated(i) / 1e6,
                    "peak_mem_mb": torch.cuda.max_memory_allocated(i) / 1e6}
        else:
            devices["cpu"] = {}
        out["devices"] = devices
    except Exception:
        pass
    return out
