"""Content keys for model configurations.

The JAX package's ``optimize/aot_cache.py`` keys compiled executables by
configuration; PyTorch runs eagerly and caches nothing, so the port keeps
only :func:`graph_signature`, which ``nn.inference_opt`` uses to tie a
calibration record to the graph it was taken on.
"""

from __future__ import annotations

import hashlib
import threading

_LOCK = threading.Lock()
# objects keyed by identity stay alive here, so a recycled address can never
# give a later object the same key
_ID_PINNED: list = []


def graph_signature(obj) -> str:
    """Stable content key for a model configuration: the sha1 of its repr
    when that repr is deterministic, else an identity key (two instances
    then never share). A repr holds every hyperparameter of the nested
    config dataclasses; ``...`` (numpy's elision of a large array) means
    the repr no longer identifies the config."""
    try:
        r = repr(obj)
    except Exception:  # an exotic repr: fall back to identity
        r = None
    if r and "..." not in r:
        return hashlib.sha1(r.encode()).hexdigest()
    with _LOCK:
        _ID_PINNED.append(obj)
    return f"id:{id(obj)}"
