"""Shared findings model for the static-analysis passes.

A copy of the JAX package's ``analysis/findings.py`` (which imports no
jax). In the port only the serving platform records here so far (PLT301,
a tenant's truncated warmup); the JAX package's linters are not ported.

In the JAX package, both linters — the program pass
(``analysis.program``, jaxpr/HLO checks hooked into the AOT-cache compile
path) and the source pass (``analysis.source``, AST checks over the repo)
— report through one vocabulary: a :class:`Finding` carries a stable
rule id, a severity, a location, and (when the repo explicitly accepts the
behavior) a waiver.

Waivers are inline comments in the flagged source (``<RULE>`` is a
placeholder here so this docstring does not itself parse as a waiver)::

    x = arr.item()  # dl4j: waive <RULE> — score() is a sync point by contract

optionally time-boxed::

    # dl4j: waive <RULE> until=2026-12-01 — kept for the pallas backport

An expired waiver stops suppressing (the finding comes back), and a
waiver that matches nothing raises ``SRC100 stale-waiver`` so dead
suppressions cannot accumulate. The program pass waives by cache-key
substring instead (no source line to annotate) — see
``analysis.program.waive_program``.

Every recorded unwaived finding increments
``dl4j_analysis_findings_total{rule,severity}`` in the telemetry
registry, so a live process's ``/metrics`` shows what compile-time lint
saw without anyone re-running the CLI.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Dict, List, Optional, Tuple

# severity ladder; make lint fails on unwaived findings >= WARN
INFO = "INFO"
WARN = "WARN"
ERROR = "ERROR"
_ORDER = {INFO: 10, WARN: 20, ERROR: 30}


def severity_at_least(sev: str, floor: str) -> bool:
    return _ORDER.get(sev, 0) >= _ORDER.get(floor, 0)


@dataclasses.dataclass
class Finding:
    rule: str          # stable id: SRC1xx (source) / PRG2xx (program)
    severity: str      # INFO / WARN / ERROR
    message: str
    location: str      # "path/to/file.py:123" or "graph=abcd kind=train_step"
    waived: bool = False
    waiver_reason: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        w = f" [waived: {self.waiver_reason}]" if self.waived else ""
        return f"{self.severity:5s} {self.rule} {self.location}: " \
               f"{self.message}{w}"


# --------------------------------------------------------------------------
# inline waivers
# --------------------------------------------------------------------------

# matches "dl4j: waive <rule>[,<rule>...] [until=YYYY-MM-DD] — reason"
WAIVER_RE = re.compile(
    r"#\s*dl4j:\s*waive\s+(?P<rules>[A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)"
    r"(?:\s+until=(?P<until>\d{4}-\d{2}-\d{2}))?"
    r"\s*(?:—|--|-)\s*(?P<reason>.+?)\s*$")


@dataclasses.dataclass
class Waiver:
    rules: Tuple[str, ...]
    reason: str
    line: int                 # line the comment sits on
    until: Optional[str] = None  # ISO date; past = expired
    used: bool = False

    def expired(self, today: Optional[str] = None) -> bool:
        if self.until is None:
            return False
        if today is None:
            import datetime

            today = datetime.date.today().isoformat()
        return self.until < today

    def covers(self, rule: str, line: int) -> bool:
        # a waiver suppresses findings on its own line, or — for a
        # standalone comment line — on the next line
        return rule in self.rules and line in (self.line, self.line + 1)


def parse_waivers(text: str) -> List[Waiver]:
    out = []
    for i, line in enumerate(text.splitlines(), start=1):
        m = WAIVER_RE.search(line)
        if m:
            rules = tuple(r.strip() for r in m.group("rules").split(","))
            out.append(Waiver(rules=rules, reason=m.group("reason"),
                              line=i, until=m.group("until")))
    return out


def apply_waivers(findings: List[Finding], waivers: List[Waiver],
                  filename: str, today: Optional[str] = None
                  ) -> List[Finding]:
    """Mark findings covered by an unexpired waiver; append a
    ``SRC100 stale-waiver`` for every waiver that suppressed nothing
    (including expired ones — an expired waiver is by definition no
    longer doing its job and must be refreshed or deleted)."""
    for f in findings:
        try:
            line = int(f.location.rsplit(":", 1)[1])
        except (IndexError, ValueError):
            continue
        for w in waivers:
            if w.covers(f.rule, line):
                if w.expired(today):
                    w.used = True  # matched, but out of date
                    f.message += f" (waiver expired {w.until})"
                else:
                    w.used = True
                    f.waived = True
                    f.waiver_reason = w.reason
                break
    for w in waivers:
        if not w.used:
            findings.append(Finding(
                rule="SRC100", severity=WARN,
                message=f"stale waiver for {', '.join(w.rules)}: suppresses "
                        f"nothing (fix landed? delete the comment)",
                location=f"{filename}:{w.line}"))
    return findings


# --------------------------------------------------------------------------
# process-global findings log (the program pass records here at compile
# time; /metrics and the UI read it)
# --------------------------------------------------------------------------

class FindingsLog:
    """Bounded thread-safe sink. ``counts`` survives the ring so a
    long-lived process keeps exact totals even after old entries age
    out."""

    _MAX = 500

    def __init__(self):
        self._lock = threading.Lock()
        self._items: List[Finding] = []
        self._counts: Dict[Tuple[str, str], int] = {}

    def record(self, finding: Finding) -> None:
        from deeplearning4j_tpu_torch import telemetry

        with self._lock:
            if len(self._items) >= self._MAX:
                del self._items[: self._MAX // 4]
            self._items.append(finding)
            k = (finding.rule, finding.severity)
            self._counts[k] = self._counts.get(k, 0) + 1
        if not finding.waived:
            telemetry.record_analysis_finding(finding.rule,
                                              finding.severity)

    def items(self) -> List[Finding]:
        with self._lock:
            return list(self._items)

    def counts(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._counts.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "findings": [f.as_dict() for f in self._items],
                "counts": {f"{r}/{s}": n
                           for (r, s), n in sorted(self._counts.items())},
            }


LOG = FindingsLog()


def summarize(findings: List[Finding], min_severity: str = WARN) -> dict:
    """Counts for CLI exit-code logic: total / waived / actionable
    (unwaived at or above ``min_severity``)."""
    actionable = [f for f in findings
                  if not f.waived and severity_at_least(f.severity,
                                                        min_severity)]
    return {
        "total": len(findings),
        "waived": sum(1 for f in findings if f.waived),
        "actionable": len(actionable),
    }
