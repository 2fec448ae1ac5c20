"""Normalized trace records: the one shape every parser lands on.

Public cluster traces disagree about everything — file format (the
Google ClusterData 2019 collection/instance events are JSONL, the
Alibaba cluster-trace-v2018 tables are headerless CSV), time units
(microseconds vs seconds), resource units (fractions of the largest
machine vs centi-cores vs percent of machine memory), and priority
vocabularies (Borg's 0..450 tier bands vs Alibaba's task classes).
The parsers (``borg.py`` / ``alibaba.py``) absorb those differences and
emit this ONE record per workload item; ``resample.py`` and
``compile.py`` never see a format again.

The normalized fields:

- ``name``      — stable identity from the trace (job/task/container
  id).  The compiler never reuses a pod name even when the trace
  resubmits an identity (name reuse is a replay fallback class —
  engine/replay.py ``pod_name_reuse``/``backoff_name_reuse``).
- ``arrival_s`` — seconds since trace start (floats; parsers convert).
- ``cpu_milli`` / ``mem_mib`` — the request, in Kubernetes-exact units
  (millicores / MiB) so quantity lowering stays exact on the device
  path (the ``inexact_units`` fallback class can never fire).
- ``lifetime_s``— seconds until the workload leaves (the compiler emits
  the delete); ``0`` = unknown/forever (no delete is emitted).
- ``tier``      — the normalized priority band ``0..4`` (free /
  best-effort batch / mid / production / monitoring), mapped by each
  parser from its native vocabulary.  ``compile.py`` lands tiers on
  ``PRIORITY_LADDER`` as pod ``spec.priority`` values.
- ``priority``  — the NATIVE priority value, kept for evidence and
  golden tests.
- ``kind``      — workload class: ``"batch"`` or ``"service"`` (becomes
  the pod's ``app`` label, the same label the synthetic churn uses for
  its feature mix).

This module is stdlib-only at import time (machine-checked:
tools/ksimlint import-boundary covers ``ksim_tpu/traces/``).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "TraceRecord",
    "TraceError",
    "TraceParseError",
    "TraceBoundExceeded",
    "TIER_COUNT",
]

#: Normalized priority bands (see ``tier`` above).
TIER_COUNT = 5


class TraceError(ValueError):
    """Any trace-plane failure a caller can act on (bad reference,
    unreadable file, oversized input).  A ``ValueError`` so the spec
    layer can re-raise it as a ``ScenarioSpecError`` (HTTP 400)."""


class TraceParseError(TraceError):
    """A malformed row.  Carries the 1-based line number — parsers are
    strict by construction: a silently-skipped row would make the
    compiled stream depend on which corruption a copy of the trace
    happens to carry, and the whole point of the plane is deterministic
    replay."""

    def __init__(self, line: int, message: str) -> None:
        super().__init__(f"line {line}: {message}")
        self.line = line


class TraceBoundExceeded(TraceError):
    """A tenant ingest bound was provably exceeded MID-READ — raised by
    the streaming selector the moment the compiled-event floor passes
    the caller's limit, so oversized (or gzip-bomb-sized) traces stop
    costing bytes immediately instead of after full parse+compile.
    Carries machine-readable fields; the jobs plane maps it onto its
    own limit vocabulary (``KSIM_JOBS_MAX_EVENTS`` / ``_MAX_NODES``)
    and HTTP 413."""

    def __init__(self, kind: str, limit: int, observed: int) -> None:
        super().__init__(
            f"trace ingest exceeds the {kind} bound: at least {observed} > {limit}"
        )
        self.kind = kind  # "events" | "nodes"
        self.limit = limit
        self.observed = observed


@dataclass(frozen=True)
class TraceRecord:
    """One normalized workload item (see module docstring)."""

    name: str
    arrival_s: float
    cpu_milli: int
    mem_mib: int
    lifetime_s: float = 0.0
    tier: int = 0
    priority: int = 0
    kind: str = "batch"  # "batch" | "service"

    def __post_init__(self) -> None:
        if not self.name:
            raise TraceError("trace record needs a name")
        if not 0 <= self.tier < TIER_COUNT:
            raise TraceError(f"tier {self.tier} outside 0..{TIER_COUNT - 1}")
        if self.kind not in ("batch", "service"):
            raise TraceError(f"unknown workload kind {self.kind!r}")
        if self.cpu_milli < 0 or self.mem_mib < 0:
            raise TraceError("negative resource request")
