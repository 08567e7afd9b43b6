"""Training UI — stats collection, storage, and a static dashboard.

Counterpart of the JAX package's ``ui/`` (reference
``deeplearning4j-ui-parent``: ``StatsListener`` feeding a ``StatsStorage``,
in memory or in a file, read by the ``UIServer`` web app). The listener
computes the same diagnostics (score, per-layer param and update mean
magnitudes and their ratio), storage is in memory or JSONL on disk (one
format for both packages), and ``UIServer`` serves a self-contained
dashboard (inline SVG, no JS dependencies) statically (``render``) or
live over HTTP (``start``), with ``RemoteUIStatsStorageRouter`` POSTing
worker stats to a central server like the reference's remote router.
"""

from deeplearning4j_tpu_torch.ui.stats import (  # noqa: F401
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    StatsListener,
    StatsStorage,
    collect_system_metrics,
)
from deeplearning4j_tpu_torch.ui.server import UIServer  # noqa: F401
