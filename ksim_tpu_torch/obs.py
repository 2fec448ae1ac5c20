"""Process-global trace plane: spans, latency histograms, event ring.

The port's share of ksim_tpu/obs.py: what its modules call.

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
  trace-event JSON at process exit.

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
    "register_provider",
    "provider_snapshots",
]

# ---------------------------------------------------------------------------
# Taxonomy: the names the port's modules record
# ---------------------------------------------------------------------------

#: Interval (span) names.
SPAN_NAMES: tuple[str, ...] = (
    "replay.lower",  # segment lowering (engine/replay.py)
    "replay.dispatch",  # kernel D's launch and its outputs' copy back
    "replay.reconcile",  # staged store reconcile (the segment txn)
    "runner.step",  # one per-pass host step (ops + flush + schedule)
    "service.schedule",  # one scheduling pass (scheduler/service.py)
)

#: Instant event names.
EVENT_NAMES: tuple[str, ...] = (
    "replay.fallback",  # segment rejected; args.reason is the stable
    #                     reason (ReplayDriver._reject)
    "service.pass",  # pass outcome: attempts/scheduled/unschedulable
    "fault.fired",  # the fault plane injected at args.site
    "store.txn_commit",  # segment transaction committed (args.writes)
    "store.txn_rollback",  # segment transaction rolled back
    "replay.cache_invalidate",  # the lowered-universe cache flushed
    #                             (args.reason)
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


class TracePlane:
    """Bounded, thread-safe trace storage.

    Three layers behind one ``_active`` gate: per-name latency
    histograms and event counters (``timing``), the structured event
    ring (``ring``), and the Chrome-trace exporter over the ring.  One
    leaf lock guards all storage (nothing under it calls out)."""

    def __init__(self) -> None:
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

    def ensure_timing(self) -> None:
        """Idempotent timing-only activation.  ScenarioRunner calls this
        so per-phase wall-clock totals always exist (the histogram cost
        is two clock reads + one locked increment per span, at
        segment/pass granularity); ring storage stays off unless the
        operator armed it, and an explicit ``disable()`` /
        ``KSIM_TRACE=off`` wins — convenience activation never
        overrides a stated opt-out."""
        if not self._active and not self._user_disabled:
            self.enable(ring=False)

    # -- the hot path ----------------------------------------------------

    def span(self, name: str, **args):
        """Open a named span; a no-op singleton when the plane is off."""
        if not self._active:
            return _NOOP
        return _Span(self, name, args)

    def event(self, name: str, **args) -> None:
        """Record one instant event (counted always; stored when the
        ring is on)."""
        if not self._active:
            return
        now = time.perf_counter_ns()
        tid = threading.get_ident()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + 1
            if self._ring_on:
                self._note_thread(tid)
                self._appended += 1
                self._ring.append({"ph": "i", "name": name, "t": now, "tid": tid, "args": args})

    def _record_span(
        self, name: str, t0: int, t1: int, depth: int, args: dict
    ) -> None:
        tid = threading.get_ident()
        with self._lock:
            hist = self._hist.get(name)
            if hist is None:
                hist = self._hist[name] = LatencyHistogram()
            hist.observe((t1 - t0) / 1e9)
            if self._ring_on:
                self._note_thread(tid)
                self._appended += 1
                self._ring.append({
                    "ph": "X",
                    "name": name,
                    "t": t0,
                    "d": t1 - t0,
                    "tid": tid,
                    "depth": depth,
                    "args": args,
                })

    def _note_thread(self, tid: int) -> None:  # ksimlint: lock-held(_lock)
        if tid not in self._thread_names:
            t = threading.current_thread()
            self._thread_names[tid] = t.name

    # -- evidence --------------------------------------------------------

    def phase_totals(self) -> dict[str, tuple[float, int]]:
        """Per-span-name ``(total_seconds, count)`` — the runner diffs
        two of these around a run for its per-phase breakdown."""
        with self._lock:
            return {n: (h.total, h.count) for n, h in self._hist.items()}

    def snapshot(self) -> dict:
        """Histograms + event counters + ring pressure, JSON-ready."""
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

        The ``otherData`` metadata carries what the ring cannot: the
        per-phase histogram totals (``phase_totals``), the eviction
        count, and ``epoch_unix_s``, the wall-clock instant of this
        plane's perf_counter epoch."""
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
            # Crash-atomic: a reader never sees a torn file.
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


@atexit.register
def _export_at_exit() -> None:
    if TRACE.out_path and TRACE.active:
        try:
            TRACE.export_chrome(TRACE.out_path)
        except OSError:
            pass
