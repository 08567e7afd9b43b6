"""The training health layer's switch, refused until it is ported.

The JAX package's ``telemetry/health.py`` compiles guard vectors into
every train step (``ParallelWrapper``'s among them) once
``configure(policy)`` turns a mode on, and rolls back through the
networks' ``_health_snapshot`` / ``_health_restore``. The port has the
hooks; the guards, the monitor and the rollback come with the health
layer (ROADMAP A: "The remainder, in dependency order"), and until then
turning a mode on raises.
"""

from __future__ import annotations

import enum


class AnomalyPolicy(enum.Enum):
    """The JAX package's policies."""

    WARN = "warn"
    SKIP_STEP = "skip_step"
    ROLLBACK = "rollback"
    HALT = "halt"


def configure(policy: AnomalyPolicy = AnomalyPolicy.WARN, **kwargs):
    raise NotImplementedError(
        f"health guard modes ({policy}) are not ported yet: they wait for "
        f"the health layer, telemetry/health.py (ROADMAP A: 'The "
        f"remainder, in dependency order')")
