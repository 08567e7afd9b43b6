"""Export surfaces: a stats-storage bridge and JSONL snapshots.

Counterpart of the JAX package's ``telemetry/export.py``:

- ``telemetry_record`` is one snapshot: the registry's metrics and the
  span phase statistics;
- ``dump_jsonl`` appends one snapshot line to a file (the offline-diff
  format);
- ``TelemetryListener`` puts a snapshot into a storage (any object with
  ``put(record)``, e.g. the reference's ``StatsStorage``) every N
  iterations. Collecting reads host counters only: no device
  synchronization.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener


def telemetry_record(session_id: Optional[str] = None,
                     iteration: Optional[int] = None) -> dict:
    """One snapshot: registry metrics and span phase statistics."""
    from deeplearning4j_tpu_torch.telemetry import registry, spans

    rec = {
        "timestamp": time.time(),
        "telemetry": registry.REGISTRY.snapshot(),
        "phases": spans.phase_stats(),
    }
    if session_id is not None:
        rec["session"] = session_id
    if iteration is not None:
        rec["iteration"] = int(iteration)
    return rec


def dump_jsonl(path: str, extra: Optional[dict] = None) -> str:
    """Append one snapshot line to ``path``; ``extra`` keys merge into the
    record (e.g. ``{"run": "r07"}``)."""
    rec = telemetry_record()
    if extra:
        rec.update(extra)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return path


class TelemetryListener(TrainingListener):
    """Put a snapshot into ``storage`` every ``frequency`` iterations."""

    def __init__(self, storage, frequency: int = 10,
                 session_id: Optional[str] = None):
        self.storage = storage
        self.frequency = max(1, int(frequency))
        self.session_id = session_id or f"telemetry_{int(time.time())}"

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency:
            return
        self.storage.put(telemetry_record(self.session_id, iteration))
