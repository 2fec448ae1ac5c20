"""Process-global trace plane: spans, latency histograms, event ring,
and the fleet observability plane's merging and Prometheus exposition.

The port of ksim_tpu/obs.py.

- **Spans** -- named intervals on a monotonic clock (``TRACE.span``),
  one per pipeline phase (segment lower / dispatch / reconcile, the
  per-pass host step, a scheduling pass).  Every span lands its
  duration in a fixed-bucket log-spaced latency histogram and (ring
  mode) a structured record in the event ring.
- **Events** -- instants (``TRACE.event``): fallback reasons with the
  segment context, pass outcomes, fault-plane fires, store-transaction
  commit/rollback.
- **Providers** -- ``register_provider``: named evidence snapshots (the
  replay driver's ``stats()``).
- **Export** -- ``KSIM_TRACE_OUT=path`` writes the ring as Chrome
  trace-event JSON at process exit; ``/api/v1/trace`` serves the same
  document live.
- **Fleet documents** -- ``merge_fleet_docs`` / ``merge_chrome_traces``
  fold many processes' evidence; ``render_prometheus`` /
  ``parse_prometheus`` speak the Prometheus text format (``GET
  /metrics``); ``publish_snapshot`` / ``read_fleet_snapshots`` /
  ``read_fleet_traces`` write and read the workers' snapshots under
  ``KSIM_JOBS_DIR/obs/`` (jobs/fleet.py publishes, the server folds).
- **Scoped planes** -- ``TRACE.scoped(plane)`` makes a private plane the
  calling thread's recording target; the job plane gives each job one
  (tagged ``job=<id>``, its records fed to the job's SSE log through
  ``set_sink``), and the replay executor carries the scope onto its
  dispatch worker.

Nothing here reads or writes scheduling state, so the churn behavior
locks hold with tracing enabled.  With the plane disabled every site
costs one attribute check (``TRACE._active``).  The module imports
torch only inside a span, and only when ``KSIM_TRACE_TORCH=1`` asks for
``torch.profiler.record_function`` annotations.

Environment:

- ``KSIM_TRACE_OUT=path``  enable timing + ring; export Chrome trace
  JSON to ``path`` at process exit.
- ``KSIM_TRACE=1``         enable timing + ring without a file.
- ``KSIM_TRACE=timing``    histograms/counters only (no ring storage).
- ``KSIM_TRACE=0|off``     off, whatever else is set.
- ``KSIM_TRACE_RING=N``    ring capacity (default 65536 records).
- ``KSIM_TRACE_TORCH=1``   also wrap spans in
  ``torch.profiler.record_function``.
"""

from __future__ import annotations

import atexit
import bisect
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator

__all__ = [
    "TRACE",
    "TracePlane",
    "LatencyHistogram",
    "SPAN_NAMES",
    "EVENT_NAMES",
    "METRIC_NAMES",
    "register_provider",
    "provider_snapshots",
    "process_identity",
    "OBS_DIR",
    "next_publish_seq",
    "publish_snapshot",
    "read_fleet_snapshots",
    "read_fleet_traces",
    "merge_latency_snapshots",
    "merge_fleet_docs",
    "merge_chrome_traces",
    "render_prometheus",
    "parse_prometheus",
]

# ---------------------------------------------------------------------------
# Taxonomy: the names the port's modules record
# ---------------------------------------------------------------------------

#: Interval (span) names, a subset of ``ksim_tpu``'s.  The port records
#: one span more: ``replay.exec``, the dispatch worker's own interval
#: (transfer, launch, pull, decode: engine/replay.py ``_run``), against
#: which the prelower's overlap is measured.
SPAN_NAMES: tuple[str, ...] = (
    "replay.lower",  # segment lowering (engine/replay.py)
    "replay.prelower",  # the NEXT window's speculative store-independent
    #                     parse, overlapped with the in-flight dispatch
    "replay.dispatch",  # kernel D's transfer, launch, pull and decode on
    #                     the watchdogged worker, and the main thread's
    #                     wait for it
    "replay.reconcile",  # staged store reconcile (the segment txn)
    "runner.step",  # one per-pass host step (ops + flush + schedule)
    "service.schedule",  # one scheduling pass (scheduler/service.py)
    "scenario.ingest",  # one materialized trace ingestion: parse +
    #                     resample + compile (traces/compile.py)
    "traces.stream",  # the streaming producer's life (traces/stream.py)
    "writeback.push",  # live-cluster write-back push (syncer/writeback.py)
    "kubeapi.request",  # any kube-apiserver HTTP request (syncer/kubeapi.py)
    "obs.fleet_merge",  # one fleet-scope aggregation (merge_fleet_docs /
    #                     merge_chrome_traces)
    "jobs.run",  # one tenant job on a job-plane worker (jobs/manager.py;
    #              recorded on the job's private plane)
    "jobs.journal_append",  # one durable append to the job journal
    "jobs.journal_replay",  # one startup journal replay
    "jobs.checkpoint_append",  # one segment checkpoint built and appended
    "jobs.checkpoint_restore",  # one restore attempt from a checkpoint
    "jobs.lease_claim",  # one fleet claim attempt (jobs/fleet.py)
    "jobs.lease_renew",  # one heartbeat batch renewing this worker's leases
    "obs.publish",  # one crash-atomic snapshot written to
    #                 KSIM_JOBS_DIR/obs/<worker_id>.json
)

#: Instant event names.
EVENT_NAMES: tuple[str, ...] = (
    "replay.fallback",  # segment rejected; args.reason is the stable
    #                     reason (ReplayDriver._reject)
    "replay.watchdog_timeout",  # a dispatch outlived its watchdog
    "replay.breaker_open",  # the circuit breaker opened (args.cause)
    "replay.breaker_probe",  # a half-open probe window was admitted
    "replay.breaker_close",  # a healthy probe closed the breaker
    "traces.ingest_fallback",  # the streaming producer fell back to the
    #                            materialized path (traces/stream.py)
    "service.pass",  # pass outcome: attempts/scheduled/unschedulable
    "fault.fired",  # the fault plane injected at args.site
    "store.txn_commit",  # segment transaction committed (args.writes)
    "store.txn_rollback",  # segment transaction rolled back
    "replay.cache_invalidate",  # the lowered-universe cache flushed
    #                             (args.reason)
    "replay.fleet_lane_fallback",  # one fleet lane left the convergent
    #                                cohort (args.lane, args.reason) and
    #                                continues on the solo device path
    #                                (engine/fleet.py)
    "obs.snapshot_stale",  # fleet aggregation found a worker snapshot
    #                        older than its publish cadence allows
    #                        (args: worker / stale_s; the worker is
    #                        flagged in the merged document, not dropped)
    "jobs.enqueue",  # a tenant job entered the job queue
    "job.cancelled",  # a tenant job was cancelled (queued or mid-run)
    "jobs.journal_recover",  # startup journal replay rebuilt the registry
    "jobs.checkpoint",  # checkpoint cadence outcome (written or skipped)
    "jobs.checkpoint_restore",  # restore-from-checkpoint outcome
    "jobs.fleet_claim",  # a fleet member won a job lease
    "jobs.lease_expired",  # a lease aged out and a survivor took the job
)


_KNOWN_NAMES = frozenset(SPAN_NAMES) | frozenset(EVENT_NAMES)

#: Prometheus exposition metric FAMILY names (``GET /metrics``), the
#: same as ``ksim_tpu``'s: every ``_expo_family("...")`` literal below
#: is registered here.  Individual counter/timer/site names become LABELS (``name`` /
#: ``site``), not families, so the family set stays a static literal.
METRIC_NAMES: tuple[str, ...] = (
    "ksim_counter_total",
    "ksim_event_total",
    "ksim_fault_calls_total",
    "ksim_fault_fired_total",
    "ksim_latency_seconds",
    "ksim_queue_depth",
    "ksim_queue_capacity",
    "ksim_workers_pool",
    "ksim_workers_active",
    "ksim_breaker_open",
    "ksim_uptime_seconds",
    "ksim_snapshot_age_seconds",
    "ksim_up",
    "ksim_trace_ring_evicted_total",
)


def _expo_family(name: str, kind: str, help_: str) -> dict:
    """Declare one exposition family.  The first argument MUST be a
    string literal — the registry-literals rule scans these calls the
    same way it scans ``TRACE.span("...")`` sites."""
    return {"name": name, "kind": kind, "help": help_}


#: The exposition surface, in render order.  ``kind`` is the Prometheus
#: TYPE; histogram families render ``_bucket``/``_sum``/``_count``
#: samples with ``le`` labels from the fixed LatencyHistogram edges.
_EXPO_FAMILIES: tuple[dict, ...] = (
    _expo_family(
        "ksim_counter_total", "counter",
        "Scheduler counters (label: name).",
    ),
    _expo_family(
        "ksim_event_total", "counter",
        "Trace-plane instant events (label: name).",
    ),
    _expo_family(
        "ksim_fault_calls_total", "counter",
        "Fault-plane site traversals (label: site).",
    ),
    _expo_family(
        "ksim_fault_fired_total", "counter",
        "Fault-plane injections fired (label: site).",
    ),
    _expo_family(
        "ksim_latency_seconds", "histogram",
        "Latency histograms over the fixed log-spaced edges "
        "(label: site = span or timer name).",
    ),
    _expo_family("ksim_queue_depth", "gauge", "Job queue depth."),
    _expo_family("ksim_queue_capacity", "gauge", "Job queue capacity."),
    _expo_family("ksim_workers_pool", "gauge", "Local worker pool size."),
    _expo_family(
        "ksim_workers_active", "gauge", "Local workers running a job.",
    ),
    _expo_family(
        "ksim_breaker_open", "gauge",
        "Replay circuit breaker state (1 = open).",
    ),
    _expo_family("ksim_uptime_seconds", "gauge", "Process uptime."),
    _expo_family(
        "ksim_snapshot_age_seconds", "gauge",
        "Age of a worker's published snapshot (fleet scope).",
    ),
    _expo_family(
        "ksim_up", "gauge", "1 = snapshot fresh, 0 = stale.",
    ),
    _expo_family(
        "ksim_trace_ring_evicted_total", "counter",
        "Trace ring records evicted.",
    ),
)


# ---------------------------------------------------------------------------
# Latency histogram
# ---------------------------------------------------------------------------


def _log_edges() -> tuple[float, ...]:
    """Fixed log-spaced bucket upper edges: 4 per decade from 1 µs to
    100 s (33 edges; an overflow bucket catches the rest).  Fixed — not
    adaptive — so two snapshots (or two processes) always merge and
    compare bucket-for-bucket."""
    return tuple(1e-6 * 10 ** (i / 4) for i in range(33))


class LatencyHistogram:
    """Fixed-bucket latency histogram (seconds).  NOT thread-safe on its
    own — callers (``TracePlane``, ``util.Metrics``) hold their lock."""

    EDGES: tuple[float, ...] = _log_edges()

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    def __init__(self) -> None:
        self.counts = [0] * (len(self.EDGES) + 1)  # +1 = overflow
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = 0.0

    def observe(self, seconds: float) -> None:
        # bisect_left: an observation exactly ON an edge belongs to the
        # bucket whose upper edge it is (le semantics, like Prometheus).
        self.counts[bisect.bisect_left(self.EDGES, seconds)] += 1
        self.count += 1
        self.total += seconds
        if seconds < self.vmin:
            self.vmin = seconds
        if seconds > self.vmax:
            self.vmax = seconds

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (upper edge of the
        bucket holding the q-th observation; the overflow bucket
        reports the observed max)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                # Clamped: a bucket's upper edge can exceed anything
                # actually observed.
                return (
                    min(self.EDGES[i], self.vmax)
                    if i < len(self.EDGES)
                    else self.vmax
                )
        return self.vmax

    def snapshot(self) -> dict:
        """JSON-ready view: ``total_seconds`` / ``count`` /
        ``mean_seconds``, and the histogram's nonzero buckets as
        ``[upper_edge_seconds, count]`` pairs plus estimated
        quantiles."""
        if not self.count:
            return {"count": 0, "total_seconds": 0.0, "mean_seconds": 0.0}
        buckets = [
            [round(self.EDGES[i], 9) if i < len(self.EDGES) else None, c]
            for i, c in enumerate(self.counts)
            if c
        ]
        return {
            "count": self.count,
            "total_seconds": round(self.total, 6),
            "mean_seconds": round(self.total / self.count, 6),
            "min_seconds": round(self.vmin, 6),
            "max_seconds": round(self.vmax, 6),
            "p50_seconds": round(self.quantile(0.50), 6),
            "p90_seconds": round(self.quantile(0.90), 6),
            "p99_seconds": round(self.quantile(0.99), 6),
            "buckets": buckets,
        }

    def merge_snapshot(self, snap: dict) -> None:
        """Fold one ``snapshot()`` document into this histogram,
        bucket-for-bucket.  EXACT by construction: the edges are fixed
        (never adaptive), so two snapshots' buckets are the same
        partition of the real line and addition loses nothing — the
        merged quantiles are as honest as solo ones.  A bucket edge
        that is not one of ours means the snapshot came from a
        different (future?) edge layout: fail loudly rather than fold
        counts into the wrong bucket."""
        count = int(snap.get("count") or 0)
        if count <= 0:
            return
        for edge, c in snap.get("buckets") or ():
            if edge is None:
                i = len(self.EDGES)
            else:
                i = _EDGE_INDEX.get(edge)
                if i is None:
                    raise ValueError(
                        f"snapshot bucket edge {edge!r} is not one of the "
                        f"fixed histogram edges"
                    )
            self.counts[i] += int(c)
        self.count += count
        self.total += float(snap.get("total_seconds") or 0.0)
        vmin = snap.get("min_seconds")
        if vmin is not None and float(vmin) < self.vmin:
            self.vmin = float(vmin)
        vmax = snap.get("max_seconds")
        if vmax is not None and float(vmax) > self.vmax:
            self.vmax = float(vmax)

    @classmethod
    def from_snapshot(cls, snap: dict) -> "LatencyHistogram":
        h = cls()
        h.merge_snapshot(snap)
        return h


#: Serialized-edge -> bucket index (snapshots round edges to 9 digits;
#: JSON round-trips floats exactly, so dict lookup is safe).
_EDGE_INDEX: dict[float, int] = {
    round(e, 9): i for i, e in enumerate(LatencyHistogram.EDGES)
}


def merge_latency_snapshots(snaps: "list[dict]") -> dict:
    """Bucket-wise merge of K ``LatencyHistogram.snapshot()`` documents
    into one merged snapshot (the fleet aggregation primitive; the
    property test in tests/test_obs_fleet.py pins merge == histogram of
    the concatenated observations)."""
    h = LatencyHistogram()
    for snap in snaps:
        h.merge_snapshot(snap)
    return h.snapshot()


# ---------------------------------------------------------------------------
# The plane
# ---------------------------------------------------------------------------


class _NoopSpan:
    """Shared do-nothing context manager — the whole disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    """One live span.  Records at exit: a span that never exits leaves
    no record."""

    __slots__ = ("_plane", "name", "args", "_t0", "_prof_ctx")

    def __init__(self, plane: "TracePlane", name: str, args: dict) -> None:
        self._plane = plane
        self.name = name
        self.args = args
        self._t0 = 0
        self._prof_ctx = None

    def __enter__(self):
        plane = self._plane
        tl = plane._tls
        tl.depth = getattr(tl, "depth", 0) + 1
        if plane._prof_bridge:
            # Guarded device-timeline bridge: annotations show up in a
            # captured torch profile next to the kernels they enclose.
            try:
                import torch

                self._prof_ctx = torch.profiler.record_function(self.name)
                self._prof_ctx.__enter__()
            except Exception:
                self._prof_ctx = None
        self._t0 = time.perf_counter_ns()
        return self

    def set(self, **args) -> None:
        """Refine span attributes mid-flight (recorded at exit) — for
        values the caller only learns inside the span, e.g. the ACTUAL
        lowered step count of a window that hit a vocabulary miss."""
        self.args.update(args)

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._prof_ctx is not None:
            try:
                self._prof_ctx.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        plane = self._plane
        tl = plane._tls
        depth = getattr(tl, "depth", 1)
        tl.depth = depth - 1
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        plane._record_span(self.name, self._t0, t1, depth - 1, self.args)
        return False


class _PlaneScope:
    """Context manager installing an override plane for the current
    thread (``TracePlane.scoped``); restores the previous override on
    exit, so scopes nest."""

    __slots__ = ("_plane", "_override", "_prev")

    def __init__(self, plane: "TracePlane", override: "TracePlane | None") -> None:
        self._plane = plane
        self._override = override
        self._prev = None

    def __enter__(self):
        tls = self._plane._tls
        self._prev = getattr(tls, "scope", None)
        tls.scope = self._override
        return self._override

    def __exit__(self, *exc):
        self._plane._tls.scope = self._prev
        return False


class TracePlane:
    """Bounded, thread-safe trace storage; the process-global ``TRACE``
    is the default instance, and each tenant job has its own.

    Three layers behind one ``_active`` gate: per-name latency
    histograms and event counters (``timing``), the structured event
    ring (``ring``), and the Chrome-trace exporter over the ring.  One
    leaf lock guards all storage (nothing under it calls out).

    **Scoped override**: ``TRACE.scoped(plane)`` installs ``plane`` as
    the current thread's recording target: every ``span`` / ``event`` /
    ``ensure_timing`` / ``phase_totals`` call on the default plane
    delegates to it until the scope exits, so a job worker gets a
    private ring and histograms without a call-site change.  Reads of a
    specific plane's storage (``snapshot`` / ``ring_records`` /
    ``export_chrome``) never delegate.  ``tags`` merge into every
    recorded span's and event's args (the job id); the ``sink`` set by
    ``set_sink`` receives each record after the storage lock is
    released (a raising sink is swallowed)."""

    def __init__(self, *, tags: "dict | None" = None) -> None:
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._active = False
        # Set by an explicit disable() / KSIM_TRACE=off: ensure_timing's
        # convenience activation must never override an operator's
        # stated choice.
        self._user_disabled = False
        self._ring_on = False  # guarded-by: _lock
        self._prof_bridge = False
        self.out_path: str | None = None
        # Constant after construction (read unlocked on the hot path):
        # args merged into every record, and the out-of-lock callback.
        self._tags: dict = dict(tags or {})
        self._sink: "Callable[[dict], None] | None" = None
        self._epoch_ns = time.perf_counter_ns()  # guarded-by: _lock
        self._hist: dict[str, LatencyHistogram] = {}  # guarded-by: _lock
        self._counters: dict[str, int] = {}  # guarded-by: _lock
        self._ring: deque = deque(maxlen=65536)  # guarded-by: _lock
        # guarded-by: _lock (ring pressure evidence: dropped = appended - len)
        self._appended = 0
        self._thread_names: dict[int, str] = {}  # guarded-by: _lock

    # -- configuration ---------------------------------------------------

    def enable(self, *, ring: bool = True, out: str | None = None) -> None:
        """Turn the plane on.  ``ring=False`` keeps histograms/counters
        only (no per-record storage); ``out`` arms the atexit Chrome
        export (also settable via ``KSIM_TRACE_OUT``)."""
        with self._lock:
            self._ring_on = ring or out is not None
            if out is not None:
                self.out_path = out
            self._user_disabled = False
            self._active = True

    def disable(self) -> None:
        """One attribute check per site from here on (storage kept;
        ``reset`` clears it).  Sticky against ``ensure_timing``: only an
        explicit ``enable`` turns the plane back on."""
        self._active = False
        self._user_disabled = True

    def reset(self) -> None:
        """Drop all recorded state (test teardown); enablement flags
        and the ring capacity survive."""
        with self._lock:
            self._hist.clear()
            self._counters.clear()
            self._ring.clear()
            self._appended = 0
            self._thread_names.clear()
            self._epoch_ns = time.perf_counter_ns()

    def configure_from_env(self, environ=os.environ) -> None:
        """Apply ``KSIM_TRACE*`` (import-time; tests re-invoke)."""
        cap = environ.get("KSIM_TRACE_RING", "")
        if cap:
            try:
                maxlen = max(int(cap), 16)
            except ValueError:
                maxlen = None
            if maxlen is not None:
                # Swap under the lock: a concurrent event() append must
                # never land in an orphaned deque (that record would
                # vanish and the eviction accounting would over-report).
                with self._lock:
                    self._ring = deque(self._ring, maxlen=maxlen)
        self._prof_bridge = environ.get("KSIM_TRACE_TORCH", "") == "1"
        out = environ.get("KSIM_TRACE_OUT", "")
        mode = environ.get("KSIM_TRACE", "")
        if mode in ("0", "off"):
            # The operator's opt-out beats everything, including a
            # KSIM_TRACE_OUT a wrapper script may have exported — the
            # same never-override-a-stated-choice contract as
            # ensure_timing vs disable().
            self.disable()
        elif out:
            self.enable(ring=True, out=out)
        elif mode:
            self.enable(ring=(mode != "timing"))

    @property
    def active(self) -> bool:
        return self._active

    def set_sink(self, sink: "Callable[[dict], None] | None") -> None:
        """Install (or clear) the record callback.  Set before the plane
        starts receiving records: the hot path reads it unlocked."""
        self._sink = sink

    # -- scoped override -------------------------------------------------

    def scoped(self, plane: "TracePlane | None") -> _PlaneScope:
        """Install ``plane`` as the current thread's recording target for
        ``span`` / ``event`` / ``ensure_timing`` / ``phase_totals`` calls
        on this plane (``None`` = a no-op scope); the previous scope
        restores on exit."""
        return _PlaneScope(self, plane)

    def scope(self) -> "TracePlane | None":
        """The current thread's override plane, if any: captured by the
        replay executor before it hands work to its dispatch worker, so
        the scope survives the thread hop."""
        return getattr(self._tls, "scope", None)

    def scope_tags(self) -> dict:
        """The effective record tags for the calling thread (the override
        plane's, else this plane's): e.g. the owning job id for the
        compile-once gate's per-tenant sharing evidence."""
        ov = getattr(self._tls, "scope", None)
        return (ov if ov is not None else self)._tags

    def ensure_timing(self) -> None:
        """Idempotent timing-only activation.  ScenarioRunner calls this
        so per-phase wall-clock totals always exist (the histogram cost
        is two clock reads + one locked increment per span, at
        segment/pass granularity); ring storage stays off unless the
        operator armed it, and an explicit ``disable()`` /
        ``KSIM_TRACE=off`` wins — convenience activation never
        overrides a stated opt-out."""
        ov = getattr(self._tls, "scope", None)
        if ov is not None:
            ov.ensure_timing()
            return
        if not self._active and not self._user_disabled:
            self.enable(ring=False)

    # -- the hot path ----------------------------------------------------

    def span(self, name: str, **args):
        """Open a named span; a no-op singleton when the plane is off.  A
        thread-scoped override plane (``scoped``) takes the record
        instead."""
        ov = getattr(self._tls, "scope", None)
        if ov is not None:
            return ov.span(name, **args)
        if not self._active:
            return _NOOP
        return _Span(self, name, args)

    def event(self, name: str, **args) -> None:
        """Record one instant event (counted always; stored when the
        ring is on)."""
        ov = getattr(self._tls, "scope", None)
        if ov is not None:
            ov.event(name, **args)
            return
        if not self._active:
            return
        now = time.perf_counter_ns()
        tid = threading.get_ident()
        if self._tags:
            args = {**self._tags, **args}
        sink = self._sink
        rec = None
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + 1
            if self._ring_on or sink is not None:
                rec = {"ph": "i", "name": name, "t": now, "tid": tid, "args": args}
                if self._ring_on:
                    self._note_thread(tid)
                    self._appended += 1
                    self._ring.append(rec)
        if rec is not None and sink is not None:
            try:
                sink(rec)
            except Exception:  # a broken sink must not break the plane
                pass

    def _record_span(
        self, name: str, t0: int, t1: int, depth: int, args: dict
    ) -> None:
        tid = threading.get_ident()
        if self._tags:
            args = {**self._tags, **args}
        sink = self._sink
        rec = None
        with self._lock:
            hist = self._hist.get(name)
            if hist is None:
                hist = self._hist[name] = LatencyHistogram()
            hist.observe((t1 - t0) / 1e9)
            if self._ring_on or sink is not None:
                rec = {
                    "ph": "X",
                    "name": name,
                    "t": t0,
                    "d": t1 - t0,
                    "tid": tid,
                    "depth": depth,
                    "args": args,
                }
                if self._ring_on:
                    self._note_thread(tid)
                    self._appended += 1
                    self._ring.append(rec)
        if rec is not None and sink is not None:
            try:
                sink(rec)
            except Exception:  # a broken sink must not break the plane
                pass

    def _note_thread(self, tid: int) -> None:  # ksimlint: lock-held(_lock)
        if tid not in self._thread_names:
            t = threading.current_thread()
            self._thread_names[tid] = t.name

    # -- evidence --------------------------------------------------------

    def phase_totals(self) -> dict[str, tuple[float, int]]:
        """Per-span-name ``(total_seconds, count)`` — the runner diffs
        two of these around a run for its per-phase breakdown.  Follows
        the thread's scoped override, so a job's run reads the job's
        histograms."""
        ov = getattr(self._tls, "scope", None)
        if ov is not None:
            return ov.phase_totals()
        with self._lock:
            return {n: (h.total, h.count) for n, h in self._hist.items()}

    def snapshot(self) -> dict:
        """Histograms + event counters + ring pressure, JSON-ready (the
        ``trace`` section of /api/v1/metrics)."""
        with self._lock:
            return {
                "enabled": self._active,
                "ring": {
                    "capacity": self._ring.maxlen,
                    "size": len(self._ring),
                    "appended": self._appended,
                    "evicted": self._appended - len(self._ring),
                },
                "histograms": {n: h.snapshot() for n, h in sorted(self._hist.items())},
                "events": dict(sorted(self._counters.items())),
            }

    def ring_records(self) -> list[dict]:
        """A consistent copy of the ring (tests; the exporter)."""
        with self._lock:
            return list(self._ring)

    # -- export ----------------------------------------------------------

    def _chrome_events(self) -> Iterator[dict]:
        with self._lock:
            ring = list(self._ring)
            names = dict(self._thread_names)
            epoch = self._epoch_ns
        pid = os.getpid()
        for tid, tname in names.items():
            yield {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "args": {"name": tname},
            }
        for r in ring:
            ev: dict[str, Any] = {
                "name": r["name"],
                "cat": r["name"].partition(".")[0],
                "ph": r["ph"],
                "ts": (r["t"] - epoch) / 1e3,  # µs
                "pid": pid,
                "tid": r["tid"],
                "args": r["args"],
            }
            if r["ph"] == "X":
                ev["dur"] = r["d"] / 1e3
            else:
                ev["s"] = "t"  # instant scoped to its thread
            yield ev

    def export_chrome(self, path: str | None = None) -> dict:
        """Render the ring as a Chrome trace-event document (the JSON
        object format, so Perfetto metadata can ride along); write it
        to ``path`` when given.  Returns the document either way.

        The ``otherData`` metadata carries what the RING cannot: the
        per-phase histogram totals (``phase_totals``) and the eviction
        count, so a consumer of an export whose ring wrapped knows
        exactly how many records were dropped and what the aggregate
        timings were anyway; and ``epoch_unix_s``, the wall-clock
        instant of this plane's perf_counter epoch, which is what lets
        ``merge_chrome_traces`` align exports from different processes
        (each plane's ``ts`` values are relative to its own epoch) on
        one timeline."""
        now_wall = time.time()
        now_ns = time.perf_counter_ns()
        with self._lock:
            phase = {
                n: [round(h.total, 6), h.count]
                for n, h in sorted(self._hist.items())
            }
            appended = self._appended
            size = len(self._ring)
            epoch = self._epoch_ns
        doc = {
            "traceEvents": list(self._chrome_events()),
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "ksim_tpu_torch.obs",
                "pid": os.getpid(),
                "epoch_unix_s": round(now_wall - (now_ns - epoch) / 1e9, 6),
                "phase_totals": phase,
                "ring": {
                    "appended": appended,
                    "size": size,
                    "evicted": appended - size,
                },
            },
        }
        if path:
            # Crash-atomic, same discipline as lease/journal compaction:
            # a reader (the fleet trace merge) never sees a torn file.
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        return doc


# ---------------------------------------------------------------------------
# Stats providers (non-timing evidence, e.g. the replay driver's stats)
# ---------------------------------------------------------------------------

_providers: dict[str, Callable[[], dict]] = {}  # guarded-by: _providers_lock
_providers_lock = threading.Lock()

#: Section names of the merged evidence document a provider must not
#: shadow.
RESERVED_PROVIDER_NAMES = frozenset({"counters", "timings", "trace", "faults"})


def register_provider(name: str, fn: Callable[[], dict]) -> None:
    """Register (or replace) a named evidence provider: e.g. the current
    run's ``ReplayDriver.stats()`` registers under ``"replay"`` (latest
    driver wins; one driver exists per ScenarioRunner run)."""
    if name in RESERVED_PROVIDER_NAMES:
        raise ValueError(f"provider name {name!r} shadows a core evidence section")
    with _providers_lock:
        _providers[name] = fn


def provider_snapshots() -> dict[str, dict]:
    """All providers' current snapshots; a provider that raises reports
    its error instead of poisoning the document."""
    with _providers_lock:
        items = list(_providers.items())
    out: dict[str, dict] = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as e:  # one broken provider must not hide the rest
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


#: The process-global plane every span/event site checks.  ``KSIM_TRACE*``
#: configures it at import, so child processes inherit tracing through
#: the environment.
TRACE = TracePlane()
TRACE.configure_from_env()


# ---------------------------------------------------------------------------
# Fleet observability plane
#
# Each fleet member publishes its merged evidence document
# crash-atomically to KSIM_JOBS_DIR/obs/<worker_id>.json on a cadence
# (KSIM_OBS_PUBLISH_S; the obs-publisher thread in jobs/fleet.py) and
# once at clean shutdown; the front door folds every published snapshot
# into one fleet-scope document (``merge_fleet_docs``: counters sum,
# histograms merge bucket-wise exactly) and ``render_prometheus``
# renders either scope as Prometheus text exposition.  Everything here
# is stdlib-only, like the rest of the module.
# ---------------------------------------------------------------------------

#: Subdirectory of KSIM_JOBS_DIR holding published worker snapshots.
#: Created lazily by the first publish: with publishing off
#: (KSIM_OBS_PUBLISH_S=0) it never appears.
OBS_DIR = "obs"

_STARTED_AT = time.time()
_seq_lock = threading.Lock()
_publish_seq = 0  # guarded-by: _seq_lock


def next_publish_seq() -> int:
    """Monotonic per-process snapshot sequence number: lets a consumer
    of ``obs/<worker_id>.json`` tell "worker restarted" (seq reset) from
    "worker stalled" (seq frozen, published_at aging)."""
    global _publish_seq
    with _seq_lock:
        _publish_seq += 1
        return _publish_seq


def process_identity(
    *, role: "str | None" = None, worker_id: "str | None" = None
) -> dict:
    """The process-identity block every metrics document carries (solo
    ``/api/v1/metrics`` and published fleet snapshots alike): who
    produced this evidence, from which process, alive since when."""
    return {
        "role": role or "solo",
        "worker_id": worker_id or f"w{os.getpid()}",
        "pid": os.getpid(),
        "started_at": round(_STARTED_AT, 3),
        "uptime_s": round(time.time() - _STARTED_AT, 3),
    }


def _atomic_json(path: str, doc: dict) -> None:
    """tmp + fsync + os.replace: a crashed writer leaves the previous
    snapshot intact, never a torn file."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def publish_snapshot(
    jobs_dir: str,
    doc: dict,
    *,
    worker_id: str,
    trace_doc: "dict | None" = None,
) -> str:
    """Write one worker's telemetry snapshot (and optionally its merged
    Chrome trace export) crash-atomically under ``<jobs_dir>/obs/``.
    Returns the snapshot path."""
    with TRACE.span("obs.publish", worker=worker_id):
        obs_dir = os.path.join(jobs_dir, OBS_DIR)
        os.makedirs(obs_dir, exist_ok=True)
        path = os.path.join(obs_dir, f"{worker_id}.json")
        _atomic_json(path, doc)
        if trace_doc is not None:
            _atomic_json(os.path.join(obs_dir, f"{worker_id}.trace.json"), trace_doc)
        return path


def _read_json_docs(obs_dir: str, suffix: str) -> "dict[str, dict]":
    out: dict[str, dict] = {}
    try:
        names = sorted(os.listdir(obs_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(suffix):
            continue
        if suffix == ".json" and name.endswith(".trace.json"):
            continue
        try:
            with open(os.path.join(obs_dir, name), "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue  # mid-replace or torn: the previous read stands
        if isinstance(doc, dict):
            out[name[: -len(suffix)]] = doc
    return out


def read_fleet_snapshots(jobs_dir: str) -> "dict[str, dict]":
    """All published worker snapshots, by worker id.  Unreadable files
    are skipped (a concurrent os.replace can lose the race with
    listdir); staleness is judged by ``merge_fleet_docs``."""
    return _read_json_docs(os.path.join(jobs_dir, OBS_DIR), ".json")


def read_fleet_traces(jobs_dir: str) -> "dict[str, dict]":
    """All published worker Chrome-trace exports, by worker id."""
    return _read_json_docs(os.path.join(jobs_dir, OBS_DIR), ".trace.json")


def merge_fleet_docs(
    docs: "dict[str, dict]",
    *,
    now: "float | None" = None,
    stale_after: "float | None" = None,
) -> dict:
    """Fold per-worker snapshot documents into ONE fleet document:
    counters and event/fault counts SUM; latency histograms (Metrics
    timings and trace-plane span histograms alike) merge bucket-wise
    exactly into ``timings``; each worker's full document survives
    under ``workers[<id>]`` with its identity block plus ``stale_s`` /
    ``stale`` — a dead worker is FLAGGED (and an ``obs.snapshot_stale``
    event fires), never silently dropped.  A snapshot is stale past
    ``stale_after`` seconds (default: 3x its own published cadence,
    floored at 1 s)."""
    with TRACE.span("obs.fleet_merge", workers=len(docs)):
        if now is None:
            now = time.time()
        workers: dict[str, dict] = {}
        counters: dict[str, float] = {}
        events: dict[str, int] = {}
        faults: dict[str, dict] = {}
        hists: dict[str, LatencyHistogram] = {}
        for wid in sorted(docs):
            doc = docs[wid]
            ident = doc.get("process") or {}
            published = float(ident.get("published_at") or 0.0)
            cadence = float(ident.get("publish_s") or 0.0) or 10.0
            stale_s = max(0.0, now - published) if published else None
            limit = (
                stale_after
                if stale_after is not None
                else max(3.0 * cadence, 1.0)
            )
            stale = stale_s is None or stale_s > limit
            if stale:
                TRACE.event(
                    "obs.snapshot_stale",
                    worker=wid,
                    stale_s=None if stale_s is None else round(stale_s, 3),
                )
            wdoc = dict(doc)
            wdoc["stale"] = stale
            wdoc["stale_s"] = (
                None if stale_s is None else round(stale_s, 3)
            )
            workers[wid] = wdoc
            for name, v in (doc.get("counters") or {}).items():
                if isinstance(v, (int, float)):
                    counters[name] = counters.get(name, 0) + v
            trace = doc.get("trace") or {}
            for name, v in (trace.get("events") or {}).items():
                if isinstance(v, (int, float)):
                    events[name] = events.get(name, 0) + int(v)
            for section in (
                doc.get("timings") or {},
                trace.get("histograms") or {},
            ):
                for name, snap in section.items():
                    if isinstance(snap, dict):
                        hists.setdefault(
                            name, LatencyHistogram()
                        ).merge_snapshot(snap)
            for site, c in (doc.get("faults") or {}).items():
                if not isinstance(c, dict):
                    continue
                agg = faults.setdefault(site, {"calls": 0, "fired": 0})
                agg["calls"] += int(c.get("calls") or 0)
                agg["fired"] += int(c.get("fired") or 0)
        return {
            "scope": "fleet",
            "generated_at": round(now, 3),
            "workers": workers,
            "counters": counters,
            "timings": {n: h.snapshot() for n, h in sorted(hists.items())},
            "trace": {"events": events},
            "faults": faults,
        }


def _flow_events(events: "list[dict]") -> "list[dict]":
    """Chrome flow events (``s``/``t``/``f`` phases) stitching each
    job's ``jobs.enqueue`` -> ``jobs.fleet_claim`` -> ``jobs.run``
    records into one arrow across process lanes.  Only COMPLETE triples
    emit — a partial chain (job still queued, ring evicted an anchor)
    draws no arrow rather than a misleading stub."""
    anchors: dict[str, dict] = {}
    want = {
        "jobs.enqueue": "s",
        "jobs.fleet_claim": "t",
        "jobs.run": "f",
    }
    for ev in events:
        ph = want.get(ev.get("name") or "")
        if ph is None:
            continue
        args = ev.get("args") or {}
        jid = args.get("job")
        if not isinstance(jid, str):
            continue
        anchors.setdefault(jid, {}).setdefault(ph, ev)
    out: list[dict] = []
    for idx, jid in enumerate(sorted(anchors)):
        chain = anchors[jid]
        if len(chain) != 3:
            continue
        for ph in ("s", "t", "f"):
            ev = chain[ph]
            rec = {
                "ph": ph,
                "name": "jobs.flow",
                "cat": "jobs",
                "id": idx + 1,
                "ts": ev.get("ts", 0),
                "pid": ev.get("pid"),
                "tid": ev.get("tid"),
                "args": {"job": jid},
            }
            if ph == "f":
                rec["bp"] = "e"  # bind the arrow end to the run slice
            out.append(rec)
    return out


def merge_chrome_traces(
    docs: "dict[str, dict]", *, flows: bool = False
) -> dict:
    """Merge per-process Chrome trace exports into ONE document with
    one process lane per worker.  Each export's ``ts`` values are
    relative to its own plane's perf_counter epoch; the exports'
    ``epoch_unix_s`` anchors rebase them all onto the EARLIEST epoch,
    so cross-process ordering is honest to wall-clock sync.  The
    merged document records its own base epoch, so merges compose
    (a worker's local global+per-job merge feeds the frontdoor's
    fleet merge).  ``flows=True`` additionally synthesizes the
    submit->claim->run flow arrows (``_flow_events``)."""
    with TRACE.span("obs.fleet_merge", traces=len(docs)):
        epochs: dict[str, float] = {}
        for wid, doc in docs.items():
            od = doc.get("otherData") or {}
            try:
                epochs[wid] = float(od.get("epoch_unix_s") or 0.0)
            except (TypeError, ValueError):
                epochs[wid] = 0.0
        known = [e for e in epochs.values() if e]
        base = min(known) if known else 0.0
        merged: list[dict] = []
        lane_names: dict = {}  # pid -> worker id (first wins)
        named: set = set()  # pids already carrying process_name metadata
        for wid in sorted(docs):
            doc = docs[wid]
            od = doc.get("otherData") or {}
            doc_pid = od.get("pid")
            off_us = (epochs[wid] - base) * 1e6 if epochs[wid] else 0.0
            for ev in doc.get("traceEvents") or ():
                ev = dict(ev)
                pid = ev.get("pid", doc_pid)
                if ev.get("ph") == "M" and ev.get("name") == "process_name":
                    named.add(pid)
                elif pid is not None and pid not in lane_names:
                    lane_names[pid] = wid
                if "ts" in ev and off_us:
                    ev["ts"] = ev["ts"] + off_us
                merged.append(ev)
        meta = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": wid},
            }
            for pid, wid in lane_names.items()
            if pid not in named
        ]
        events = meta + merged
        if flows:
            events = events + _flow_events(merged)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "ksim_tpu_torch.obs",
                "pid": os.getpid(),
                "merged": sorted(docs),
                "epoch_unix_s": base,
            },
        }


# -- Prometheus text exposition ---------------------------------------------


def _escape_label(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return format(f, ".10g")


def _fmt_edge(edge: float) -> str:
    return format(edge, ".9g")


def _sample_line(name: str, labels: dict, value) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in labels.items()
        )
        return f"{name}{{{body}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


def _emit_histogram(
    out: "list[tuple[str, dict, Any]]", family: str, labels: dict, snap: dict
) -> None:
    """Expand one LatencyHistogram snapshot into cumulative ``_bucket``
    samples over EVERY fixed edge (plus ``+Inf``), ``_sum`` and
    ``_count`` — the native Prometheus histogram shape, ``le``
    semantics matching ``observe``'s bisect_left exactly."""
    counts = [0] * (len(LatencyHistogram.EDGES) + 1)
    for edge, c in snap.get("buckets") or ():
        i = len(LatencyHistogram.EDGES) if edge is None else _EDGE_INDEX[edge]
        counts[i] += int(c)
    cum = 0
    for i, edge in enumerate(LatencyHistogram.EDGES):
        cum += counts[i]
        out.append(
            (f"{family}_bucket", {**labels, "le": _fmt_edge(edge)}, cum)
        )
    cum += counts[-1]
    out.append((f"{family}_bucket", {**labels, "le": "+Inf"}, cum))
    out.append((f"{family}_sum", labels, snap.get("total_seconds") or 0.0))
    out.append((f"{family}_count", labels, snap.get("count") or 0))


def _expose_section(
    samples: "dict[str, list]", doc: dict, labels: dict
) -> None:
    """Render one solo-shaped metrics document (a worker snapshot or
    the serving process's own document) into per-family samples."""
    for name, v in sorted((doc.get("counters") or {}).items()):
        if isinstance(v, (int, float)):
            samples["ksim_counter_total"].append(
                ("ksim_counter_total", {**labels, "name": name}, v)
            )
    trace = doc.get("trace") or {}
    for name, v in sorted((trace.get("events") or {}).items()):
        if isinstance(v, (int, float)):
            samples["ksim_event_total"].append(
                ("ksim_event_total", {**labels, "name": name}, v)
            )
    ring = trace.get("ring") or {}
    if ring:
        samples["ksim_trace_ring_evicted_total"].append(
            (
                "ksim_trace_ring_evicted_total",
                labels,
                ring.get("evicted") or 0,
            )
        )
    merged_hists = dict(doc.get("timings") or {})
    merged_hists.update(trace.get("histograms") or {})
    for name in sorted(merged_hists):
        snap = merged_hists[name]
        if isinstance(snap, dict):
            _emit_histogram(
                samples["ksim_latency_seconds"],
                "ksim_latency_seconds",
                {**labels, "site": name},
                snap,
            )
    for site, c in sorted((doc.get("faults") or {}).items()):
        if not isinstance(c, dict):
            continue
        samples["ksim_fault_calls_total"].append(
            (
                "ksim_fault_calls_total",
                {**labels, "site": site},
                c.get("calls") or 0,
            )
        )
        samples["ksim_fault_fired_total"].append(
            (
                "ksim_fault_fired_total",
                {**labels, "site": site},
                c.get("fired") or 0,
            )
        )
    jobs = doc.get("jobs") or {}
    q = jobs.get("queue") or {}
    if q:
        samples["ksim_queue_depth"].append(
            ("ksim_queue_depth", labels, q.get("depth") or 0)
        )
        samples["ksim_queue_capacity"].append(
            ("ksim_queue_capacity", labels, q.get("capacity") or 0)
        )
    w = jobs.get("workers") or {}
    if w:
        samples["ksim_workers_pool"].append(
            ("ksim_workers_pool", labels, w.get("pool") or 0)
        )
        samples["ksim_workers_active"].append(
            ("ksim_workers_active", labels, w.get("active") or 0)
        )
    replay = doc.get("replay") or {}
    if isinstance(replay, dict) and "breaker_tripped" in replay:
        samples["ksim_breaker_open"].append(
            (
                "ksim_breaker_open",
                labels,
                1.0 if replay["breaker_tripped"] else 0.0,
            )
        )
    ident = doc.get("process") or {}
    if "uptime_s" in ident:
        samples["ksim_uptime_seconds"].append(
            ("ksim_uptime_seconds", labels, ident["uptime_s"])
        )


def render_prometheus(doc: dict) -> str:
    """Render a metrics document — solo (``/api/v1/metrics`` shape) or
    fleet (``merge_fleet_docs`` shape) — as Prometheus text exposition.
    Fleet scope renders PER-WORKER series only (``worker``/``role``
    labels); a scraper's ``sum()`` re-derives the fleet totals, so
    nothing is double-counted.  ``parse_prometheus`` round-trips and
    validates this output in-suite."""
    samples: dict[str, list] = {f["name"]: [] for f in _EXPO_FAMILIES}
    if doc.get("scope") == "fleet":
        for wid, wdoc in sorted((doc.get("workers") or {}).items()):
            ident = wdoc.get("process") or {}
            labels = {
                "worker": str(ident.get("worker_id") or wid),
                "role": str(ident.get("role") or ""),
            }
            _expose_section(samples, wdoc, labels)
            stale_s = wdoc.get("stale_s")
            if stale_s is not None:
                samples["ksim_snapshot_age_seconds"].append(
                    ("ksim_snapshot_age_seconds", labels, stale_s)
                )
            samples["ksim_up"].append(
                ("ksim_up", labels, 0.0 if wdoc.get("stale") else 1.0)
            )
    else:
        ident = doc.get("process") or {}
        labels = {
            "worker": str(ident.get("worker_id") or f"w{os.getpid()}"),
            "role": str(ident.get("role") or "solo"),
        }
        _expose_section(samples, doc, labels)
        samples["ksim_up"].append(("ksim_up", labels, 1.0))
    lines: list[str] = []
    for fam in _EXPO_FAMILIES:
        rows = samples[fam["name"]]
        if not rows:
            continue
        lines.append(f"# HELP {fam['name']} {fam['help']}")
        lines.append(f"# TYPE {fam['name']} {fam['kind']}")
        for name, labels, value in rows:
            lines.append(_sample_line(name, labels, value))
    return "\n".join(lines) + "\n"


_NAME_START = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_:"
)
_NAME_CHARS = _NAME_START | frozenset("0123456789")


def _parse_sample(line: str) -> "tuple[str, dict, float]":
    """Strict parse of one exposition sample line."""
    i = 0
    n = len(line)
    if not line or line[0] not in _NAME_START:
        raise ValueError(f"bad metric name: {line!r}")
    while i < n and line[i] in _NAME_CHARS:
        i += 1
    name = line[:i]
    labels: dict[str, str] = {}
    if i < n and line[i] == "{":
        i += 1
        while True:
            if i >= n:
                raise ValueError(f"unterminated label set: {line!r}")
            if line[i] == "}":
                i += 1
                break
            j = i
            while j < n and line[j] in _NAME_CHARS:
                j += 1
            key = line[i:j]
            if (
                not key
                or j + 1 >= n
                or line[j] != "="
                or line[j + 1] != '"'
            ):
                raise ValueError(f"bad label at col {i}: {line!r}")
            j += 2
            buf: list[str] = []
            while j < n and line[j] != '"':
                if line[j] == "\\":
                    if j + 1 >= n:
                        raise ValueError(f"bad escape: {line!r}")
                    esc = line[j + 1]
                    buf.append(
                        {"n": "\n", "\\": "\\", '"': '"'}.get(esc, esc)
                    )
                    j += 2
                else:
                    buf.append(line[j])
                    j += 1
            if j >= n:
                raise ValueError(f"unterminated label value: {line!r}")
            labels[key] = "".join(buf)
            j += 1
            if j < n and line[j] == ",":
                j += 1
            i = j
    rest = line[i:].strip()
    if not rest:
        raise ValueError(f"sample has no value: {line!r}")
    value_str = rest.split()[0]
    if value_str == "+Inf":
        value = float("inf")
    elif value_str == "-Inf":
        value = float("-inf")
    else:
        value = float(value_str)
    return name, labels, value


def parse_prometheus(text: str) -> "dict[str, dict]":
    """Stdlib validator for the exposition format: every sample must
    follow a ``# TYPE`` for its family, histogram samples must carry
    coherent ``le`` labels (cumulative, non-decreasing, ``+Inf``
    present and equal to ``_count``).  Returns families with their
    parsed samples; raises ``ValueError`` on any violation — the
    golden test pins the format by parser, not by hope."""
    families: dict[str, dict] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name, _, help_ = line[len("# HELP "):].partition(" ")
            families.setdefault(
                name, {"kind": None, "help": None, "samples": []}
            )["help"] = help_
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            fam = families.setdefault(
                name, {"kind": None, "help": None, "samples": []}
            )
            if fam["samples"]:
                raise ValueError(
                    f"line {lineno}: TYPE for {name!r} after its samples"
                )
            fam["kind"] = kind.strip()
            continue
        if line.startswith("#"):
            continue  # free comment
        try:
            name, labels, value = _parse_sample(line)
        except ValueError as e:
            raise ValueError(f"line {lineno}: {e}") from None
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                cand = name[: -len(suffix)]
                if families.get(cand, {}).get("kind") == "histogram":
                    base = cand
                    break
        fam = families.get(base)
        if fam is None or not fam["kind"]:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no preceding # TYPE"
            )
        if (
            fam["kind"] == "histogram"
            and name.endswith("_bucket")
            and "le" not in labels
        ):
            raise ValueError(
                f"line {lineno}: histogram bucket without le label"
            )
        fam["samples"].append({"name": name, "labels": labels, "value": value})
    for fname, fam in families.items():
        if fam["kind"] != "histogram":
            continue
        series: dict[tuple, dict] = {}
        for sample in fam["samples"]:
            name, labels, value = (
                sample["name"], sample["labels"], sample["value"]
            )
            key = tuple(
                sorted((k, v) for k, v in labels.items() if k != "le")
            )
            ent = series.setdefault(key, {"buckets": [], "count": None})
            if name.endswith("_bucket"):
                le = labels["le"]
                ent["buckets"].append(
                    (float("inf") if le == "+Inf" else float(le), value)
                )
            elif name.endswith("_count"):
                ent["count"] = value
        for key, ent in series.items():
            buckets = sorted(ent["buckets"])
            if not buckets or buckets[-1][0] != float("inf"):
                raise ValueError(
                    f"{fname}{dict(key)}: histogram missing +Inf bucket"
                )
            prev = -1.0
            for le, v in buckets:
                if v < prev:
                    raise ValueError(
                        f"{fname}{dict(key)}: bucket counts decrease at "
                        f"le={le}"
                    )
                prev = v
            if ent["count"] is not None and buckets[-1][1] != ent["count"]:
                raise ValueError(
                    f"{fname}{dict(key)}: +Inf bucket != _count"
                )
    return families


@atexit.register
def _export_at_exit() -> None:
    if TRACE.out_path and TRACE.active:
        try:
            TRACE.export_chrome(TRACE.out_path)
        except OSError:
            pass
