"""Tenant job plane: a bounded queue + worker pool over ScenarioRunner.

The port of ``ksim_tpu/jobs/manager.py``.  ``JobManager(device=,
exact=)`` hands both to every ``SchedulerService`` and ``ScenarioRunner``
it builds; ``device=None`` is the card, and without one the constructor
raises (a job never carries on on the CPU unless ``device="cpu"`` was
asked for).  On the card a solo ``deviceReplay: true`` job runs kernel D
(``replay_segment``), a ``fleet: S`` job kernel D's lanes entry
(``replay_segment_fleet``) and a per-pass job kernel A per step; a
kernel that fails to build or launch fails its job, with the error in
the job's status.

Simulation-as-a-service: N tenants submit scenario jobs concurrently, a fixed worker
pool keeps the hardware hot, and every job runs in full isolation —

- its own ``ClusterStore`` + ``SchedulerService`` + ``ScenarioRunner``
  (built from the job's inline spec; tenant specs may NOT reference
  server files or import plugin modules),
- its own **TracePlane** (private ring + latency histograms, every
  record tagged ``job=<id>``), installed for the worker thread via the
  global plane's scoped override (``obs.TracePlane.scoped``) — no call
  site anywhere in the pipeline changes,
- its own **FaultPlane** (``KSIM_JOBS_FAULTS``), checked next to the
  process-global one at ``jobs.run`` and the replay sites, so a chaos
  schedule degrades ONE tenant while its neighbors' counts stay locked,
- a cooperative **cancel** flag the runner honors between steps and
  INSIDE the segment reconcile (a mid-segment cancel rolls the
  in-flight store transaction back — the job's store stays consistent).

What jobs share is exactly what SHOULD be shared: the process-wide
compile-once gate (engine/compilecache.py: a kernel library's load and
a rung's first launch happen once, however many tenants reach the same
bucketed shape rung at once) and the worker pool itself.

The HTTP surface lives in server/http.py (``/api/v1/jobs``): submit /
status / result / cancel plus an SSE stream of the job's progress and
trace events, fed by the job plane's record sink.

Admission is cost- and
bounds-aware:

- the queue orders shortest-job-first within a priority band, costed by
  the spec's event count, with a starvation bound
  (``KSIM_JOBS_SJF_BYPASS`` — jobs/queue.py), so a 50k-event job cannot
  convoy 6k jobs behind it;
- per-submission resource bounds (``KSIM_JOBS_MAX_EVENTS`` /
  ``KSIM_JOBS_MAX_NODES``) refuse oversized specs at POST time with
  ``JobLimitExceeded`` (HTTP 413) — measured against what the job would
  actually replay.  Trace-sourced specs are refused DURING streaming
  ingest (``TraceBoundExceeded`` from traces/resample.py's monotone
  lower bound): the server stops reading the trace at the first proof
  of excess instead of compiling the whole stream first;
- scenarios may reference REGISTERED traces by name
  (``spec.scenario.source.trace.name`` resolved in the operator's
  ``KSIM_TRACES_DIR`` — traces/registry.py); raw ``path``
  references are refused exactly like the snapshot-path fields;
- a spec may arm its own chaos (``spec.faults`` —
  scenario/spec.py ``faults_spec_from_doc``) on the job's PRIVATE
  fault plane, sites restricted to ``JOB_FAULT_SITES`` like the
  operator's ``KSIM_JOBS_FAULTS`` ordinals.

Durability: when ``KSIM_JOBS_DIR`` is set, every
submission, state transition, cancellation and result document is
journaled through the crash-safe WAL in jobs/journal.py
BEFORE the in-memory state machine observes it, and a restarted
manager replays that journal to reconstruct the registry — completed
results serve byte-identically, jobs that died mid-run surface as
``interrupted`` (or re-enqueue under ``KSIM_JOBS_RESUME=1``).  Unset,
the plane is in-memory only.

Incremental resume (docs/jobs.md "Incremental resume"): a
solo device-replay job also journals SEGMENT CHECKPOINTS — every
``KSIM_JOBS_CHECKPOINT_EVERY`` committed segment reconciles, one
``checkpoint`` record carries the exact store state
(``ClusterStore.checkpoint``), the event-stream cursor, the service's
determinism carries (pass counter, backoff map, featurizer slot order,
pnts rotation) and the partial result accounting.  Under
``KSIM_JOBS_RESUME=1`` the worker restores from the NEWEST valid
checkpoint and replays only the remaining suffix, byte-identical to an
uninterrupted run; an unusable checkpoint falls back to the previous
one, then scratch.  Checkpoints are best-effort by policy: a
non-restorable moment (Permit-waiting pods), an oversized snapshot
(``KSIM_JOBS_CHECKPOINT_MAX_BYTES``) or an append failure SKIPS the
checkpoint with a counted ``jobs.checkpoint`` event — never fails the
job.

Tenancy: submissions carry a
tenant label (HTTP ``X-Ksim-Tenant`` or ``spec.tenant``; default
``default``) and the operator may bound each tenant's concurrency
(``KSIM_JOBS_TENANT_MAX_ACTIVE``) and sustained submission rate
(``KSIM_JOBS_TENANT_RATE``, a token bucket) — over either bound the
submit raises ``JobThrottled`` (HTTP 429 with a ``Retry-After`` hint).

Environment (docs/env.md "Job plane"): ``KSIM_JOBS_WORKERS``,
``KSIM_JOBS_QUEUE``, ``KSIM_JOBS_RING``, ``KSIM_JOBS_KEEP``,
``KSIM_JOBS_EVENTS``, ``KSIM_JOBS_FAULTS``, ``KSIM_JOBS_MAX_EVENTS``,
``KSIM_JOBS_MAX_NODES``, ``KSIM_JOBS_SJF_BYPASS``,
``KSIM_JOBS_TENANT_MAX_ACTIVE``, ``KSIM_JOBS_TENANT_RATE``;
durability: ``KSIM_JOBS_DIR``, ``KSIM_JOBS_RESUME``,
``KSIM_JOBS_JOURNAL_MAX_BYTES``, ``KSIM_JOBS_CHECKPOINT_EVERY``,
``KSIM_JOBS_CHECKPOINT_MAX_BYTES``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any

from ksim_tpu_torch.errors import RunCancelled
from ksim_tpu_torch.faults import FAULTS, FaultPlane
from ksim_tpu_torch.jobs.journal import JOURNAL_NAME, JobJournal
from ksim_tpu_torch.jobs.queue import JobQueue, JobQueueFull
from ksim_tpu_torch.obs import TRACE, TracePlane

logger = logging.getLogger(__name__)

__all__ = [
    "Job",
    "JobLimitExceeded",
    "JobManager",
    "JobQueueFull",
    "JobThrottled",
    "parse_job_faults",
]


class JobLimitExceeded(Exception):
    """A submission exceeded the operator's per-job resource bounds
    (``KSIM_JOBS_MAX_EVENTS`` / ``KSIM_JOBS_MAX_NODES``) — HTTP 413
    upstream, with this message as the reason body."""


class JobThrottled(Exception):
    """A tenant is over its admission bound — the concurrency quota
    (``KSIM_JOBS_TENANT_MAX_ACTIVE``) or the submission-rate token
    bucket (``KSIM_JOBS_TENANT_RATE``).  HTTP 429 upstream with
    ``retry_after`` (seconds) as the ``Retry-After`` header: the bucket
    knows exactly when the next token lands, so the hint is a real
    schedule, not a guess."""

    def __init__(self, msg: str, *, retry_after: float) -> None:
        super().__init__(msg)
        self.retry_after = retry_after

#: Final job states (no transitions out).  ``interrupted`` is
#: recovery-only: the journal saw the job queued/running when the
#: process died (docs/jobs.md "Durability & recovery") — terminal
#: unless ``KSIM_JOBS_RESUME=1`` re-enqueues it as a fresh run.
TERMINAL_STATES = frozenset({"succeeded", "failed", "cancelled", "interrupted"})

#: Sites a tenant-job private plane may arm.  The private plane is only
#: CHECKED at these (jobs/manager.py + the runner/driver's lane-plane
#: checks); accepting any other site would arm a schedule that can
#: never fire — the vacuously-green chaos run every parser in this
#: repo refuses.
JOB_FAULT_SITES = frozenset(
    {"jobs.run", "replay.lower", "replay.dispatch", "replay.reconcile"}
)


def _job_fault_specs(spec: str) -> dict[int, list[str]]:
    """Parse ``KSIM_JOBS_FAULTS`` into per-ordinal schedule SPEC
    strings (the manager builds a FRESH plane per submission from
    these, so a refused submission can never leave schedules behind on
    a shared plane).

    Syntax mirrors ``KSIM_FLEET_FAULTS``: comma/semicolon-separated
    ``<ordinal>:<site>=<schedule>[@error]`` entries where ``ordinal``
    is the job's 0-based SUBMISSION index — e.g.
    ``"0:replay.dispatch=always@device"`` arms only the first job
    submitted.  Sites outside ``JOB_FAULT_SITES`` and malformed entries
    raise."""
    specs: dict[int, list[str]] = {}
    for part in spec.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        ord_s, sep, rest = part.partition(":")
        if not sep or not ord_s.strip().isdigit():
            raise ValueError(
                f"KSIM_JOBS_FAULTS entry {part!r}: expected "
                f"<job-ordinal>:<site>=<schedule>"
            )
        site = rest.partition("=")[0].strip()
        if site not in JOB_FAULT_SITES:
            raise ValueError(
                f"KSIM_JOBS_FAULTS entry {part!r}: site {site!r} is not a "
                f"job-plane site (have {sorted(JOB_FAULT_SITES)})"
            )
        # Fail-fast on the SCHEDULE too (a throwaway plane): an operator
        # typo must raise at JobManager construction, not surface later
        # as an HTTP 400 blaming some tenant's spec.faults while the
        # chaos schedule silently never runs.
        FaultPlane().configure(rest)
        specs.setdefault(int(ord_s), []).append(rest)
    return specs


def parse_job_faults(spec: str) -> dict[int, FaultPlane]:
    """``KSIM_JOBS_FAULTS`` -> per-job-ordinal fault planes (see
    ``_job_fault_specs`` for the grammar and refusals)."""
    planes: dict[int, FaultPlane] = {}
    for ordinal, entries in _job_fault_specs(spec).items():
        plane = planes[ordinal] = FaultPlane()
        for entry in entries:
            plane.configure(entry)
    return planes


def _tenant_trace_resolver(trace_doc: dict) -> str:
    """The job plane's trace resolver: registered names only.  A raw
    ``path`` is refused for the same reason ``initialSnapshotPath`` is —
    tenants must never make the server read arbitrary files; the
    operator registers traces by placing them in ``KSIM_TRACES_DIR``."""
    from ksim_tpu_torch.scenario.spec import ScenarioSpecError, default_trace_resolver

    if trace_doc.get("path"):
        raise ScenarioSpecError(
            "source.trace.path is not allowed in a tenant job spec — "
            "reference a trace registered in KSIM_TRACES_DIR by name"
        )
    return default_trace_resolver(trace_doc)


def _spec_hash(sim: dict) -> str:
    """Canonical content hash of a job's simulator spec (docs/jobs.md
    "Resume across a config change").  Checkpoint records carry it so ``_restore_checkpoint``
    can REFUSE a restore whose spec no longer matches the resubmitted
    job: the rebuilt SchedulerService would silently diverge from the
    carries the old config produced.  Sorted-key compact JSON makes the
    hash independent of dict ordering; the 16-hex truncation (64 bits)
    is plenty for an equality check that only ever compares a job
    against its own history."""
    blob = json.dumps(
        sim or {}, sort_keys=True, separators=(",", ":"), default=str
    )
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _parse_job_spec(
    doc: Any, *, event_bound: int = 0, node_bound: int = 0
) -> tuple[list, dict, int, str]:
    """Validate a tenant job document -> (operations, simulator spec,
    priority, canonical fault spec).  Accepts the
    SchedulerSimulation-ish shape::

        {"spec": {"priority": 0,
                  "simulator": {...},          # recordMode/preemption/
                                               # deviceReplay/fleet/
                                               # schedulerConfig/
                                               # initialSnapshot (INLINE)
                  "faults": {...},             # site -> schedule (the
                                               # job's PRIVATE plane)
                  "scenario": {"operations": [...]   # or source.trace
                  }}}

    or a bare ``{"operations": [...]}``.  File-path fields are REFUSED:
    tenants must not make the server read its own filesystem (the
    KEP-184 mounted-file workflow is the operator's
    ``cmd/simulation.py``, not this surface); trace references resolve
    by REGISTERED NAME only (``_tenant_trace_resolver``).

    ``event_bound`` / ``node_bound`` flow into the streaming trace
    ingest (traces/stream + resample): a trace-sourced spec that
    provably exceeds either bound raises ``TraceBoundExceeded``
    mid-read, before the rest of the trace is consumed."""
    from ksim_tpu_torch.scenario.spec import (
        ScenarioSpecError,
        faults_spec_from_doc,
        operations_from_spec,
    )

    if not isinstance(doc, dict):
        raise ScenarioSpecError("job document must be a mapping")
    spec = doc.get("spec") or doc
    sim = spec.get("simulator") or {}
    for scope in (spec, sim):
        for banned in (
            "initialSnapshotPath",
            "scenarioTemplateFilePath",
            "scenarioResultFilePath",
        ):
            if banned in scope:
                raise ScenarioSpecError(
                    f"{banned} is not allowed in a tenant job spec — inline "
                    "the document (the job plane never reads server files)"
                )
    if sim.get("fleet"):
        # The fleet runner builds every lane's store/service itself —
        # a config/snapshot silently dropped here would run the wrong
        # simulation and still report Succeeded.  Refuse until fleet
        # lanes learn to carry them.
        for unsupported in ("schedulerConfig", "initialSnapshot"):
            if sim.get(unsupported):
                raise ScenarioSpecError(
                    f"simulator.{unsupported} is not supported together with "
                    "simulator.fleet (fleet lanes build default-config stores)"
                )
    scenario = spec.get("scenario")
    if scenario is None and "operations" in spec:
        scenario = {"operations": spec["operations"]}
    if scenario is None and "source" in spec:
        scenario = {"source": spec["source"]}
    if scenario is None:
        raise ScenarioSpecError(
            "job spec needs an inline scenario (spec.scenario.operations "
            "or spec.scenario.source.trace)"
        )
    ops = operations_from_spec(
        scenario,
        trace_resolver=_tenant_trace_resolver,
        event_bound=event_bound,
        node_bound=node_bound,
    )
    fault_spec = faults_spec_from_doc(doc)
    if fault_spec:
        for part in fault_spec.split(","):
            site = part.partition("=")[0]
            if site not in JOB_FAULT_SITES:
                raise ScenarioSpecError(
                    f"spec.faults site {site!r} is not a job-plane site "
                    f"(have {sorted(JOB_FAULT_SITES)})"
                )
    try:
        priority = int(spec.get("priority", 0))
    except (TypeError, ValueError):
        raise ScenarioSpecError("spec.priority must be an integer") from None
    return ops, dict(sim), priority, fault_spec


class Job:
    """One tenant job: spec + isolation planes + the event log the SSE
    stream replays.  Mutable state lives under ``_cond`` (the SSE
    readers wait on it); the trace/fault planes and the parsed ops are
    construction-time constants."""

    def __init__(
        self,
        job_id: str,
        ordinal: int,
        ops: list,
        sim: dict,
        priority: int,
        *,
        ring_cap: int,
        max_events: int,
        faults: "FaultPlane | None",
        tenant: str = "default",
    ) -> None:
        self.id = job_id
        self.ordinal = ordinal
        self.ops = ops
        self.sim = sim
        self.priority = priority
        self.faults = faults
        self.tenant = tenant
        self.cancel = threading.Event()
        self.created = time.time()
        self.steps_total = len({op.step for op in ops})
        # The job's PRIVATE trace plane: ring + histograms, every record
        # tagged with the job id; the sink feeds the SSE event log.
        self.trace = TracePlane(tags={"job": job_id})
        self.trace.configure_from_env(
            {"KSIM_TRACE_RING": str(ring_cap), "KSIM_TRACE": "1"}
        )
        self.trace.set_sink(self._on_record)
        self._max_events = max_events
        self._cond = threading.Condition()
        self.state = "queued"  # guarded-by: _cond
        self.error: "str | None" = None  # guarded-by: _cond
        self.result: "dict | None" = None  # guarded-by: _cond
        self.started: "float | None" = None  # guarded-by: _cond
        self.finished: "float | None" = None  # guarded-by: _cond
        self.steps_done = 0  # guarded-by: _cond
        self._events: list[dict] = []  # guarded-by: _cond
        self._dropped = 0  # guarded-by: _cond
        self.sse_listeners = 0  # guarded-by: _cond
        # The raw submitted document, kept ONLY once its submit record
        # is durably journaled (compaction re-serializes it; None in
        # the in-memory-only plane).
        self.doc: Any = None
        # Diagnostics handles, set by the worker (the job's own store/
        # runner — tests assert cancel-rollback consistency through
        # them; None for queued jobs).
        self.store = None
        self.runner = None
        # Incremental resume (docs/jobs.md): the journaled checkpoint
        # records recovery stashed for the worker's restore attempt
        # (single-threaded: written before the workers start, read only
        # by the one worker that claims the job), the NEWEST durable
        # checkpoint (re-emitted by compaction), and the status fields.
        self.checkpoints: list[dict] = []
        self._last_checkpoint: "dict | None" = None  # guarded-by: _cond
        self.checkpoint_segment: "int | None" = None  # guarded-by: _cond
        self.resumed_from: "int | None" = None  # guarded-by: _cond
        self._resume_info: "dict | None" = None  # worker-thread only
        # Fleet ownership (docs/jobs.md "Multi-worker fleet"): which
        # worker process holds the job's lease, folded from the lease
        # file by the front door's poller (or set locally on adoption).
        # None outside fleet mode — status() serves the keys either way.
        self.owner: "str | None" = None  # guarded-by: _cond
        self.lease_epoch: "int | None" = None  # guarded-by: _cond
        self.lease_ts: "float | None" = None  # guarded-by: _cond

    # -- event log (the SSE source) --------------------------------------

    def _emit_locked(self, ev: dict, vital: bool) -> None:  # ksimlint: lock-held(_cond)
        if not vital and len(self._events) >= self._max_events:
            self._dropped += 1
            return
        ev = dict(ev, seq=len(self._events), job=self.id)
        self._events.append(ev)
        self._cond.notify_all()

    def emit(self, ev: dict, *, vital: bool = False) -> None:
        with self._cond:
            self._emit_locked(ev, vital)

    def _on_record(self, rec: dict) -> None:
        """The job plane's record sink (called OUTSIDE the plane lock):
        reconcile/step spans become monotonically increasing progress
        events, instant trace events forward to the stream (droppable
        once the log caps out)."""
        name = rec.get("name")
        args = rec.get("args") or {}
        if rec.get("ph") == "X":
            if name == "runner.step":
                self._note_steps(1)
            elif name == "replay.reconcile" and "error" not in args:
                # Committed segments only: a rolled-back reconcile exits
                # its span with the error recorded, and its steps re-run
                # (head per-pass, rest on-device) — counting it would
                # double-book and break monotonic-progress semantics.
                self._note_steps(int(args.get("steps") or 0))
            return
        self.emit({"event": "trace", "name": name, "args": args})

    def _note_steps(self, n: int) -> None:
        if n <= 0:
            return
        with self._cond:
            self.steps_done += n
            self._emit_locked(
                {
                    "event": "progress",
                    "steps_done": self.steps_done,
                    "steps_total": self.steps_total,
                },
                True,
            )

    # -- state machine ---------------------------------------------------

    def claim(self) -> bool:
        """queued -> running (the worker's atomic take); False if the
        job was cancelled while queued."""
        with self._cond:
            if self.state != "queued" or self.cancel.is_set():
                return False
            self.state = "running"
            self.started = time.time()
            self._emit_locked({"event": "state", "state": "running"}, True)
            return True

    def finish(
        self,
        state: str,
        *,
        error: "str | None" = None,
        result: "dict | None" = None,
    ) -> None:
        with self._cond:
            if self.state in TERMINAL_STATES:
                return
            self.state = state
            self.error = error
            self.result = result
            self.finished = time.time()
            ev = {"event": "state", "state": state}
            if error:
                ev["error"] = error
            self._emit_locked(ev, True)

    def restore(
        self,
        state: str,
        *,
        error: "str | None" = None,
        result: "dict | None" = None,
        created: "float | None" = None,
        started: "float | None" = None,
        finished: "float | None" = None,
        cancelled: bool = False,
    ) -> None:
        """Journal-recovery only (JobManager._recover): install the
        reconstructed final state directly — the job never ran in THIS
        process, so the queued→running→terminal machinery must not
        fire (no worker owns it, no planes are scoped)."""
        if cancelled:
            self.cancel.set()
        with self._cond:
            self.state = state
            self.error = error
            self.result = result
            if created:
                self.created = float(created)
            self.started = float(started) if started else None
            self.finished = float(finished) if finished else time.time()
            ev = {"event": "state", "state": state, "recovered": True}
            if error:
                ev["error"] = error
            self._emit_locked(ev, True)

    def _set_lease(self, lease: dict) -> None:
        """Fleet: install the folded lease view (front door) or the
        just-claimed lease (worker adoption) for status()."""
        with self._cond:
            self.owner = lease.get("worker")
            self.lease_epoch = lease.get("epoch")
            ts = lease.get("ts")
            self.lease_ts = float(ts) if ts else None

    def _mirror_state(
        self,
        state: str,
        *,
        error: "str | None" = None,
        result: "dict | None" = None,
        started: "float | None" = None,
        finished: "float | None" = None,
        segment: "int | None" = None,
    ) -> None:
        """Fleet front door only: install a worker-journaled transition
        into this MIRROR job without emitting events — the per-job
        event file is the event authority (FleetMember forwards it into
        the ring), the shared journal the state authority.  A terminal
        mirror never regresses: a duplicate terminal record from the
        cancel race (front door finalized queued, worker journaled
        cancelled) folds to the same state."""
        with self._cond:
            if self.state in TERMINAL_STATES:
                return
            self.state = state
            if error is not None:
                self.error = error
            if result is not None:
                self.result = result
            if started:
                self.started = float(started)
            if state in TERMINAL_STATES:
                self.finished = float(finished) if finished else time.time()
                self.checkpoint_segment = None  # terminal: not carried
            else:
                self.checkpoint_segment = segment
            self._cond.notify_all()

    def request_cancel(self) -> str:
        """Set the cancel flag; a QUEUED job finalizes immediately, a
        RUNNING one stops at the runner's next checkpoint (rolling back
        any in-flight segment).  Returns the state after the request."""
        self.cancel.set()
        with self._cond:
            if self.state == "queued":
                self.state = "cancelled"
                self.finished = time.time()
                self._emit_locked({"event": "state", "state": "cancelled"}, True)
            return self.state

    def sse_attach(self) -> None:
        """One SSE reader subscribed (server/http.py pairs every attach
        with a detach in a finally — the leak regression test counts
        these through an aborted stream)."""
        with self._cond:
            self.sse_listeners += 1

    def sse_detach(self) -> None:
        with self._cond:
            self.sse_listeners = max(self.sse_listeners - 1, 0)

    # -- views -----------------------------------------------------------

    def status(self) -> dict:
        with self._cond:
            return {
                "id": self.id,
                "state": self.state,
                "priority": self.priority,
                "tenant": self.tenant,
                "created": round(self.created, 3),
                "started": round(self.started, 3) if self.started else None,
                "finished": round(self.finished, 3) if self.finished else None,
                "progress": {
                    "steps_done": self.steps_done,
                    "steps_total": self.steps_total,
                },
                "events": len(self._events),
                "events_dropped": self._dropped,
                "sse_listeners": self.sse_listeners,
                "cancel_requested": self.cancel.is_set(),
                "checkpoint_segment": self.checkpoint_segment,
                "resumed_from": self.resumed_from,
                "error": self.error,
                "owner": self.owner,
                "lease": (
                    {
                        "epoch": self.lease_epoch,
                        "age": round(time.time() - self.lease_ts, 3)
                        if self.lease_ts
                        else None,
                    }
                    if self.owner is not None
                    else None
                ),
            }

    def result_view(self) -> tuple[str, "dict | None", "str | None"]:
        with self._cond:
            return self.state, self.result, self.error

    def events_since(
        self, idx: int, timeout: "float | None" = None
    ) -> tuple[list[dict], int, bool]:
        """(new events from ``idx``, next index, end-of-stream).  Blocks
        up to ``timeout`` when nothing new exists and the job is still
        live — the SSE handler's poll step."""
        with self._cond:
            if idx >= len(self._events) and self.state not in TERMINAL_STATES:
                self._cond.wait(timeout)
            evs = list(self._events[idx:])
            nxt = idx + len(evs)
            done = self.state in TERMINAL_STATES and nxt >= len(self._events)
            return evs, nxt, done

    def wait_done(self, timeout: "float | None" = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.state not in TERMINAL_STATES:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    def trace_summary(self) -> dict:
        """The per-job plane snapshot trimmed for the merged metrics
        document: event counters, ring pressure, and per-span latency
        quantiles (the job's OWN p50/p99, not the process's)."""
        snap = self.trace.snapshot()
        return {
            "events": snap["events"],
            "ring": snap["ring"],
            "histograms": {
                name: {
                    k: h[k]
                    for k in ("count", "mean_seconds", "p50_seconds", "p99_seconds")
                    if k in h
                }
                for name, h in snap["histograms"].items()
            },
        }


class JobManager:
    """The worker pool + registry behind ``/api/v1/jobs``."""

    # Machine-checked acquisition order (tools/ksimlint lock-order —
    # docs/lint.md "Lock order").  Under the registry lock the submit
    # path notifies jobs/queue conditions and consults the planes;
    # the JOURNAL lock is never taken under the registry lock outside
    # construction-time recovery (waived inline in ``_recover``).
    # ksimlint: lock-order(JobManager._lock<Job._cond)
    # ksimlint: lock-order(JobManager._lock<JobQueue._cond)
    # ksimlint: lock-order(JobManager._lock<FaultPlane._lock)
    # ksimlint: lock-order(JobManager._lock<TracePlane._lock)

    def __init__(
        self,
        *,
        workers: "int | None" = None,
        queue_limit: "int | None" = None,
        ring_cap: "int | None" = None,
        keep: "int | None" = None,
        max_events: "int | None" = None,
        fault_spec: "str | None" = None,
        max_job_events: "int | None" = None,
        max_job_nodes: "int | None" = None,
        sjf_bypass: "int | None" = None,
        jobs_dir: "str | None" = None,
        resume: "bool | None" = None,
        journal_max_bytes: "int | None" = None,
        checkpoint_every: "int | None" = None,
        checkpoint_max_bytes: "int | None" = None,
        tenant_max_active: "int | None" = None,
        tenant_rate: "float | None" = None,
        role: "str | None" = None,
        worker_id: "str | None" = None,
        lease_s: "float | None" = None,
        heartbeat_s: "float | None" = None,
        poll_s: "float | None" = None,
        device: "str | None" = None,
        exact: bool = True,
    ) -> None:
        env = os.environ
        # Fleet role (docs/jobs.md "Multi-worker fleet"): None is the
        # solo manager;
        # "frontdoor" serves HTTP over a mirror registry (zero local
        # workers); "worker" claims jobs by lease from the shared dir.
        if role is None:
            role = env.get("KSIM_WORKERS_ROLE", "") or None
        if role not in (None, "frontdoor", "worker"):
            raise ValueError(
                f"KSIM_WORKERS_ROLE must be 'frontdoor' or 'worker', "
                f"got {role!r}"
            )
        self.role = role
        # Every service and runner a job builds runs on ``device`` (None:
        # the card) in ``exact`` or f32 mode.  A member that runs jobs
        # refuses to start without the card it was given: its jobs would
        # otherwise fail one by one.  The front door runs none.
        self._device = device
        self._exact = bool(exact)
        if role != "frontdoor":
            import torch

            wanted = torch.device("cuda" if device is None else device)
            if wanted.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: pass device='cpu' to run the plain PyTorch versions"
                )
        if worker_id is None:
            worker_id = env.get("KSIM_WORKER_ID", "") or f"w{os.getpid()}"
        self.worker_id = str(worker_id)
        if lease_s is None:
            lease_s = float(env.get("KSIM_WORKERS_LEASE_S", "10"))
        if heartbeat_s is None:
            raw = env.get("KSIM_WORKERS_HEARTBEAT_S", "")
            heartbeat_s = float(raw) if raw else None
        if poll_s is None:
            poll_s = float(env.get("KSIM_WORKERS_POLL_S", "0.5"))
        if role == "frontdoor":
            workers = 0  # the front door never runs jobs locally
        if workers is None:
            workers = int(env.get("KSIM_JOBS_WORKERS", "2"))
        if queue_limit is None:
            queue_limit = int(env.get("KSIM_JOBS_QUEUE", "16"))
        if ring_cap is None:
            ring_cap = int(env.get("KSIM_JOBS_RING", "4096"))
        if keep is None:
            keep = int(env.get("KSIM_JOBS_KEEP", "64"))
        if max_events is None:
            max_events = int(env.get("KSIM_JOBS_EVENTS", "8192"))
        if fault_spec is None:
            fault_spec = env.get("KSIM_JOBS_FAULTS", "")
        if max_job_events is None:
            max_job_events = int(env.get("KSIM_JOBS_MAX_EVENTS", "0"))
        if max_job_nodes is None:
            max_job_nodes = int(env.get("KSIM_JOBS_MAX_NODES", "0"))
        if sjf_bypass is None:
            raw = env.get("KSIM_JOBS_SJF_BYPASS", "")
            sjf_bypass = int(raw) if raw else None
        if jobs_dir is None:
            jobs_dir = env.get("KSIM_JOBS_DIR", "")
        # Exposed for the fleet observability plane: the HTTP layer
        # resolves KSIM_JOBS_DIR/obs/ (published worker snapshots)
        # through the manager it already has.
        self.jobs_dir = jobs_dir or None
        if resume is None:
            resume = env.get("KSIM_JOBS_RESUME", "") == "1"
        if checkpoint_every is None:
            checkpoint_every = int(env.get("KSIM_JOBS_CHECKPOINT_EVERY", "8"))
        if checkpoint_max_bytes is None:
            checkpoint_max_bytes = int(
                env.get("KSIM_JOBS_CHECKPOINT_MAX_BYTES", str(64 * 1024 * 1024))
            )
        if tenant_max_active is None:
            tenant_max_active = int(env.get("KSIM_JOBS_TENANT_MAX_ACTIVE", "0"))
        if tenant_rate is None:
            tenant_rate = float(env.get("KSIM_JOBS_TENANT_RATE", "0"))
        # Checkpoint cadence/bounds (0 = off / unbounded) and tenant
        # admission bounds (0 = off) — docs/env.md "Job plane".
        self._checkpoint_every = max(int(checkpoint_every), 0)
        self._checkpoint_max_bytes = max(int(checkpoint_max_bytes), 0)
        self._tenant_max_active = max(int(tenant_max_active), 0)
        self._tenant_rate = max(float(tenant_rate), 0.0)
        # tenant -> token-bucket + counters (jobs section of the merged
        # metrics document).
        self._tenants: dict[str, dict] = {}  # guarded-by: _lock
        self._ring_cap = max(ring_cap, 16)
        self._keep = max(keep, 1)
        self._max_events = max(max_events, 64)
        # Per-submission resource bounds (0 = unbounded): HTTP 413.
        self._max_job_events = max(max_job_events, 0)
        self._max_job_nodes = max(max_job_nodes, 0)
        self._fault_specs = _job_fault_specs(fault_spec) if fault_spec else {}
        self.queue = JobQueue(queue_limit, max_bypass=sjf_bypass)
        self._lock = threading.Lock()
        self._jobs: "OrderedDict[str, Job]" = OrderedDict()  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._active = 0  # guarded-by: _lock
        # Durability: journal replay + registry reconstruction happen
        # BEFORE the workers start — recovery is single-threaded by
        # construction, so no claim can race the rebuild.
        self._journal: "JobJournal | None" = None
        if jobs_dir:
            self._journal = JobJournal(
                os.path.join(jobs_dir, JOURNAL_NAME),
                max_bytes=journal_max_bytes,
                # Fleet mode: other PROCESSES hold this journal open —
                # appends/compactions take the flock sidecar.
                shared=role is not None,
            )
            # Worker role NEVER replays at startup: the journal's
            # non-terminal jobs belong to whichever member holds their
            # lease (marking them interrupted here would sabotage a
            # live peer) — a worker's registry fills by adoption only.
            # The front door replays into MIRRORS: live states restore
            # verbatim, nothing is flagged interrupted, nothing is
            # re-enqueued locally.
            if role != "worker":
                self._recover(bool(resume) if role is None else False)
        self._threads: list[threading.Thread] = []
        for i in range(max(int(workers), 0)):
            t = threading.Thread(
                target=self._worker_loop, name=f"jobs-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        # The fleet poller starts LAST: adoption may enqueue onto the
        # local pool, so the workers must already be draining.
        self._fleet = None
        if role is not None and jobs_dir:
            from ksim_tpu_torch.jobs.fleet import FleetMember

            self._fleet = FleetMember(
                self, jobs_dir, role=role, worker_id=self.worker_id,
                lease_s=lease_s, heartbeat_s=heartbeat_s, poll_s=poll_s,
            )
            self._fleet.start()

    # -- durability ------------------------------------------------------

    def _journal_append(self, rec: dict) -> bool:
        """One best-effort durable append.  False on failure (I/O error
        or an armed ``jobs.journal_append`` fault) — CALLERS decide the
        blast radius, which is always the ONE job the record belongs
        to, never the registry or the worker pool."""
        if self._journal is None:
            return True
        try:
            self._journal.append(rec)
            return True
        except Exception:
            logger.exception(
                "job journal append failed (type=%s job=%s)",
                rec.get("t"), rec.get("id"),
            )
            return False

    def _journal_state(
        self, job: Job, state: str, *, error: "str | None" = None
    ) -> bool:
        if self._journal is None:
            return True
        rec: dict = {
            "t": "state", "id": job.id, "state": state,
            "ts": round(time.time(), 3),
        }
        if error:
            rec["error"] = error
        return self._journal_append(rec)

    # Compaction's three-lock chain — the only path that ever holds
    # all three (journal first; the qualified lock-held below is what
    # lets the analyzer SEE the dynamic snapshot_fn callback):
    # ksimlint: lock-order(JobJournal._lock<JobManager._lock<Job._cond)
    def _journal_records(self) -> list[dict]:  # ksimlint: lock-held(JobJournal._lock)
        """The LIVE registry re-serialized as journal records — the
        compaction snapshot.  Called by ``JobJournal.maybe_compact``
        with the journal lock held; lock order journal ``_lock`` →
        manager ``_lock`` → job ``_cond`` (the only path that ever
        holds all three)."""
        recs: list[dict] = []
        for j in self.jobs():
            if j.doc is None:
                continue  # its submit record never became durable
            st = j.status()
            recs.append({
                "t": "submit", "id": j.id, "ordinal": j.ordinal,
                "priority": j.priority, "tenant": j.tenant, "doc": j.doc,
                "created": round(j.created, 3),
            })
            if st["started"]:
                recs.append({
                    "t": "state", "id": j.id, "state": "running",
                    "ts": st["started"],
                })
            if st["state"] not in TERMINAL_STATES:
                # A LIVE job keeps exactly its newest durable checkpoint
                # (older ones are dead weight once a newer one exists);
                # terminal jobs keep none — their result is the record.
                with j._cond:
                    ck = j._last_checkpoint
                if ck is not None:
                    recs.append(ck)
            if st["state"] in TERMINAL_STATES:
                _, result, _ = j.result_view()
                if result is not None:
                    recs.append({"t": "result", "id": j.id, "result": result})
                state_rec: dict = {
                    "t": "state", "id": j.id, "state": st["state"],
                    "ts": st["finished"],
                }
                if st["error"]:
                    state_rec["error"] = st["error"]
                recs.append(state_rec)
        return recs

    def _maybe_compact(self) -> None:
        """Bound the journal (called with NO locks held — submit's tail
        and the worker's run epilogue)."""
        if self._journal is not None:
            self._journal.maybe_compact(self._journal_records)

    def _recover(self, resume: bool) -> None:  # ksimlint: lock-held(_lock)
        """Rebuild the registry from the journal (startup, pre-workers).
        Runs in ``__init__`` BEFORE any worker thread exists, so the
        registry is single-threaded here by construction — the
        lock-held annotation records that exclusivity, not an actual
        acquisition.  Never raises: an unreadable journal (or an armed
        ``jobs.journal_replay`` fault) starts an empty registry; a
        per-job reconstruction failure loses that ONE job."""
        try:
            # Construction-time inversion of the compaction chain
            # (registry "lock" -> journal lock): waived, not blessed —
            # no worker thread exists yet, so no second thread can hold
            # the journal lock against us.
            recs = self._journal.replay()  # ksimlint: disable=lock-order
        except Exception:
            logger.exception(
                "job journal replay failed; starting with an empty registry"
            )
            return
        folded: "OrderedDict[str, dict]" = OrderedDict()
        for rec in recs:
            jid, t = rec.get("id"), rec.get("t")
            if not isinstance(jid, str):
                continue
            ent = folded.setdefault(jid, {
                "submit": None, "state": None, "error": None,
                "result": None, "cancel": False,
                "started": None, "finished": None,
                "checkpoints": [], "history": [],
            })
            if t == "submit":
                ent["submit"] = rec
            elif t == "state":
                state = rec.get("state")
                ent["state"], ent["error"] = state, rec.get("error")
                if state == "running":
                    ent["started"] = rec.get("ts")
                elif state in TERMINAL_STATES:
                    ent["finished"] = rec.get("ts")
                # The full transition history, in journal order — the
                # resumed job's SSE backlog replays it so a reconnecting
                # tenant's stream is gap-free across the restart.
                ent["history"].append({
                    "state": state, "ts": rec.get("ts"),
                    "error": rec.get("error"),
                })
            elif t == "result":
                ent["result"] = rec.get("result")
            elif t == "cancel":
                ent["cancel"] = True
            elif t == "checkpoint":
                ent["checkpoints"].append(rec)
        interrupted = resumed = 0
        max_ordinal = -1
        for jid, ent in folded.items():
            sub = ent["submit"]
            if sub is None:
                continue  # debris past compaction: states without a spec
            try:
                ordinal = int(sub.get("ordinal", 0))
                priority = int(sub.get("priority", 0))
                max_ordinal = max(max_ordinal, ordinal)
                job: "Job | None" = None
                # Resumable: died mid-flight (no terminal record) OR
                # already flagged interrupted by an earlier restart —
                # KSIM_JOBS_RESUME=1 is exactly the "re-run those"
                # switch, so it must reach jobs a resume-less restart
                # already journaled as interrupted.
                resumable = (
                    ent["state"] not in TERMINAL_STATES
                    or ent["state"] == "interrupted"
                )
                if resumable and resume:
                    job = self._resume_job(jid, ordinal, priority, sub, ent)
                    if job is not None:
                        resumed += 1
                if job is None:
                    # Same construction-time waiver as replay() above.
                    job = self._restore_job(jid, ordinal, priority, sub, ent)  # ksimlint: disable=lock-order
                    if job.status()["state"] == "interrupted":
                        interrupted += 1
                self._jobs[jid] = job
            except Exception:
                logger.exception("job journal recovery lost job %s", jid)
        self._seq = max_ordinal + 1
        TRACE.event(
            "jobs.journal_recover",
            jobs=len(self._jobs), interrupted=interrupted, resumed=resumed,
            truncated_bytes=self._journal.truncated_bytes,
        )

    def _restore_job(
        self, jid: str, ordinal: int, priority: int, sub: dict, ent: dict
    ) -> Job:
        """One journal-reconstructed job: terminal states restore
        verbatim (the result document serves byte-identically); a job
        last seen queued/running died with the old process and is
        flagged ``interrupted``.

        Fleet front door EXCEPTION: a restarting front door's
        non-terminal jobs are (probably) still running on a live worker
        — they restore as LIVE mirrors with the journaled state
        verbatim, no interrupted flag, no interrupted record (which a
        worker would read as terminal and skip the job forever).  If
        the owner really is dead, lease expiry hands the job to a
        survivor and the mirror catches up."""
        job = Job(
            jid, ordinal, [], {}, priority,
            ring_cap=self._ring_cap, max_events=self._max_events, faults=None,
            tenant=str(sub.get("tenant") or "default"),
        )
        job.doc = sub.get("doc")
        state = ent["state"]
        if state in TERMINAL_STATES:
            job.restore(
                state,
                error=ent["error"],
                result=ent["result"] if state == "succeeded" else None,
                created=sub.get("created"), started=ent["started"],
                finished=ent["finished"], cancelled=ent["cancel"],
            )
        elif self.role == "frontdoor":
            if ent["cancel"]:
                job.cancel.set()
            with job._cond:
                job.state = state or "queued"
                if sub.get("created"):
                    job.created = float(sub["created"])
                job.started = (
                    float(ent["started"]) if ent["started"] else None
                )
            # Gap-free SSE across the front-door restart: replay the
            # journaled lifecycle into the fresh mirror ring first; the
            # event-file tailer appends the live tail on top.
            for h in ent.get("history", ()):
                ev = {"event": "state", "state": h["state"],
                      "recovered": True}
                if h.get("error"):
                    ev["error"] = h["error"]
                job.emit(ev, vital=True)
            if ent["checkpoints"]:
                with job._cond:
                    job.checkpoint_segment = (
                        ent["checkpoints"][-1].get("segment")
                    )
        else:
            job.restore(
                "interrupted",
                error="interrupted by server restart",
                created=sub.get("created"), started=ent["started"],
                cancelled=ent["cancel"],
            )
            self._journal_state(job, "interrupted",
                                error="interrupted by server restart")
        return job

    def _resume_job(
        self, jid: str, ordinal: int, priority: int, sub: dict, ent: dict
    ) -> "Job | None":
        """KSIM_JOBS_RESUME=1: re-parse the journaled spec and re-enqueue
        the died-mid-run job under its original id/ordinal, carrying its
        journaled checkpoints for the worker's incremental restore.
        None when the spec no longer parses or the queue is full — the
        caller falls back to ``interrupted`` (recovery never crashes
        startup)."""
        try:
            ops, sim, _, fault_spec = _parse_job_spec(sub.get("doc"))
            entries = list(self._fault_specs.get(ordinal, ()))
            if fault_spec:
                entries.append(fault_spec)
            faults: "FaultPlane | None" = None
            if entries and not sim.get("fleet"):
                faults = FaultPlane()
                for entry in entries:
                    faults.configure(entry)
            job = Job(
                jid, ordinal, ops, sim, priority,
                ring_cap=self._ring_cap, max_events=self._max_events,
                faults=faults, tenant=str(sub.get("tenant") or "default"),
            )
            job.doc = sub.get("doc")
            # Gap-free SSE across the restart: replay the journaled
            # lifecycle transitions into the fresh event log FIRST, so a
            # reconnecting tenant streaming from index 0 sees the
            # pre-restart history (queued→running→...) ahead of the
            # re-enqueue — not a log that starts mid-life.
            for h in ent.get("history", ()):
                ev = {"event": "state", "state": h["state"], "recovered": True}
                if h.get("error"):
                    ev["error"] = h["error"]
                job.emit(ev, vital=True)
            job.checkpoints = list(ent.get("checkpoints", ()))
            if job.checkpoints:
                last = job.checkpoints[-1]
                with job._cond:
                    job._last_checkpoint = last
                    job.checkpoint_segment = last.get("segment")
            job.emit({"event": "state", "state": "queued", "resumed": True},
                     vital=True)
            self.queue.put(job, priority=priority, cost=len(ops))
            return job
        except Exception:
            logger.exception("job %s could not be resumed", jid)
            return None

    # -- fleet adoption --------------------------------------------------

    def adopt(self, jid: str, ent: dict,
              lease: "dict | None" = None) -> "Job | None":
        """Fleet worker: take ownership of a journal-folded job this
        process just LEASED (FleetMember's poller, after a winning
        ``LeasePlane.claim``) — the cross-process twin of
        ``_resume_job``.  Re-parses the journaled spec, replays the
        journaled lifecycle into the event log (tagged ``recovered``),
        carries the folded checkpoints for the incremental
        restore, and enqueues onto the LOCAL pool under the original
        id/ordinal.  ``JobQueueFull`` propagates — local backpressure
        is retryable, the caller keeps the lease and tries again.  A
        spec that no longer parses journals a terminal ``failed``
        record (so the front door mirrors the refusal) and returns
        None."""
        sub = ent.get("submit") or {}
        ordinal = int(sub.get("ordinal", 0))
        priority = int(sub.get("priority", 0))
        existing = self.get(jid)
        if existing is not None:
            return existing
        try:
            ops, sim, _, fault_spec = _parse_job_spec(sub.get("doc"))
            entries = list(self._fault_specs.get(ordinal, ()))
            if fault_spec:
                entries.append(fault_spec)
            faults: "FaultPlane | None" = None
            if entries and not sim.get("fleet"):
                faults = FaultPlane()
                for entry in entries:
                    faults.configure(entry)
        except Exception as e:
            error = f"adopted spec no longer parses: {type(e).__name__}: {e}"
            logger.exception("job %s could not be adopted", jid)
            self._journal_append({
                "t": "state", "id": jid, "state": "failed", "error": error,
                "ts": round(time.time(), 3),
            })
            return None
        job = Job(
            jid, ordinal, ops, sim, priority,
            ring_cap=self._ring_cap, max_events=self._max_events,
            faults=faults, tenant=str(sub.get("tenant") or "default"),
        )
        job.doc = sub.get("doc")
        if sub.get("created"):
            job.created = float(sub["created"])
        for h in ent.get("history", ()):
            ev = {"event": "state", "state": h["state"], "recovered": True}
            if h.get("error"):
                ev["error"] = h["error"]
            job.emit(ev, vital=True)
        job.checkpoints = list(ent.get("checkpoints", ()))
        if job.checkpoints:
            last = job.checkpoints[-1]
            with job._cond:
                job._last_checkpoint = last
                job.checkpoint_segment = last.get("segment")
        if ent.get("cancel"):
            job.cancel.set()
        job._set_lease(lease or {"worker": self.worker_id,
                                 "ts": time.time()})
        job.emit({"event": "state", "state": "queued", "resumed": True},
                 vital=True)
        # JobQueueFull propagates with no registry residue.
        self.queue.put(job, priority=priority, cost=len(ops))
        with self._lock:
            self._seq = max(self._seq, ordinal + 1)
            self._jobs[jid] = job
            self._prune_locked()
        TRACE.event("jobs.enqueue", job=jid, priority=priority,
                    depth=self.queue.depth())
        return job

    # -- submission ------------------------------------------------------

    def submit(
        self,
        doc: Any,
        *,
        priority: "int | None" = None,
        tenant: "str | None" = None,
    ) -> Job:
        """Validate + enqueue one tenant job document.  Raises
        ``ScenarioSpecError`` on a bad spec (HTTP 400),
        ``JobLimitExceeded`` when the spec exceeds the operator's
        per-job bounds (HTTP 413), ``JobThrottled`` when the tenant is
        over its quota/rate (HTTP 429 + Retry-After), and
        ``JobQueueFull`` on a saturated queue (HTTP 429).

        ``tenant`` (the HTTP layer's ``X-Ksim-Tenant`` header) wins
        over ``spec.tenant``; absent both, jobs pool under ``default``.

        The submission ordinal (the ``KSIM_JOBS_FAULTS`` key) commits
        only on a SUCCESSFUL enqueue: a refused submission must not
        shift which job an armed chaos schedule lands on (that would be
        the vacuously-green sweep the fault parsers exist to refuse).
        The whole reserve-build-enqueue sequence runs under the manager
        lock, so concurrent submits cannot interleave ordinals with
        rejections; lock order is ``_lock`` → ``queue._cond`` →
        ``job._cond``, matching every other path."""
        from ksim_tpu_torch.traces.schema import TraceBoundExceeded

        try:
            ops, sim, spec_priority, fault_spec = _parse_job_spec(
                doc,
                event_bound=self._max_job_events,
                node_bound=self._max_job_nodes,
            )
        except TraceBoundExceeded as e:
            # Streaming ingest proved the bound exceeded MID-READ and
            # stopped consuming trace bytes; translate to the job
            # plane's vocabulary (HTTP 413, same as the post-parse
            # checks below).
            env = (
                "KSIM_JOBS_MAX_EVENTS"
                if e.kind == "events"
                else "KSIM_JOBS_MAX_NODES"
            )
            raise JobLimitExceeded(
                f"job trace compiles to at least {e.observed} {e.kind}, "
                f"over the per-job bound of {e.limit} ({env}); ingest "
                "stopped early"
            ) from None
        if priority is None:
            priority = spec_priority
        if tenant is None:
            scope = (doc.get("spec") or doc) if isinstance(doc, dict) else {}
            tenant = str(scope.get("tenant") or "") or "default"
        # Resource bounds for inline specs (trace-sourced specs are
        # bounded during streaming ingest above): what is measured is
        # the stream the job would actually replay.
        if self._max_job_events and len(ops) > self._max_job_events:
            raise JobLimitExceeded(
                f"job spec compiles to {len(ops)} events, over the "
                f"per-job bound of {self._max_job_events} "
                "(KSIM_JOBS_MAX_EVENTS)"
            )
        if self._max_job_nodes:
            n_nodes = sum(
                1 for op in ops if op.kind == "nodes" and op.op == "create"
            )
            if n_nodes > self._max_job_nodes:
                raise JobLimitExceeded(
                    f"job spec creates {n_nodes} nodes, over the per-job "
                    f"bound of {self._max_job_nodes} (KSIM_JOBS_MAX_NODES)"
                )
        with self._lock:
            # Tenant admission BEFORE the ordinal reservation: a
            # throttled submission must not shift which job an armed
            # KSIM_JOBS_FAULTS ordinal lands on, same as every other
            # refusal in this block.
            self._admit_tenant_locked(tenant)
            ordinal = self._seq
            # The job's private plane is built FRESH per submission from
            # the operator's per-ordinal schedules plus the spec's own
            # faults section (a refused submission leaves nothing armed;
            # FaultPlane.configure rejects malformed schedules loudly
            # -> HTTP 400).
            entries = list(self._fault_specs.get(ordinal, ()))
            if fault_spec:
                entries.append(fault_spec)
            faults: "FaultPlane | None" = None
            if entries:
                from ksim_tpu_torch.scenario.spec import ScenarioSpecError

                faults = FaultPlane()
                try:
                    for entry in entries:
                        faults.configure(entry)
                except ValueError as e:
                    raise ScenarioSpecError(f"spec.faults: {e}") from None
            if faults is not None and sim.get("fleet"):
                from ksim_tpu_torch.scenario.spec import ScenarioSpecError

                # The private plane is checked on the SOLO replay path
                # only; silently dropping it for a fleet job would run
                # the chaos schedule against nothing.
                raise ScenarioSpecError(
                    f"chaos is armed for job ordinal {ordinal} "
                    "(KSIM_JOBS_FAULTS or spec.faults), but the submitted "
                    "job is a fleet job — per-lane chaos uses "
                    "KSIM_FLEET_FAULTS (docs/faults.md)"
                )
            job = Job(
                f"job-{ordinal:06d}",
                ordinal,
                ops,
                sim,
                priority,
                ring_cap=self._ring_cap,
                max_events=self._max_events,
                faults=faults,
                tenant=tenant,
            )
            # The queued event lands BEFORE the queue hand-off: once
            # put() returns, a worker may claim (and emit "running")
            # immediately, and the SSE log's state order must match
            # reality.
            job.emit({"event": "state", "state": "queued"}, vital=True)
            # Cost-aware admission: the spec's event count is the cost
            # estimate (shortest-job-first within the priority band).
            # The fleet FRONT DOOR never enqueues locally — its journal
            # submit record IS the hand-off, and a worker process
            # claims it by lease; backpressure there is per-tenant
            # admission plus the workers' own queue capacity.
            if self.role != "frontdoor":
                self.queue.put(
                    job, priority=priority, cost=len(ops)
                )  # JobQueueFull -> no ordinal
            self._seq += 1
            self._jobs[job.id] = job
            self._prune_locked()
        # WAL: the submit record lands OUTSIDE the manager lock (lock
        # order — the journal lock is taken first on the compaction
        # path, so it must never nest inside ``_lock``).  A failed
        # append fails the ONE job: the worker's ``claim()`` then sees
        # a terminal state and skips it; the registry stays clean.
        if self._journal is not None:
            ok = self._journal_append({
                "t": "submit", "id": job.id, "ordinal": job.ordinal,
                "priority": priority, "tenant": job.tenant, "doc": doc,
                "created": round(job.created, 3),
            })
            if ok:
                job.doc = doc
            else:
                job.finish("failed", error="journal append failed (submit)")
        TRACE.event(
            "jobs.enqueue", job=job.id, priority=priority, depth=self.queue.depth()
        )
        self._maybe_compact()
        return job

    def _admit_tenant_locked(self, tenant: str) -> None:  # ksimlint: lock-held(_lock)
        """Per-tenant admission: the
        concurrency quota counts the tenant's non-terminal jobs in the
        registry; the rate limit is a token bucket refilled at
        ``KSIM_JOBS_TENANT_RATE`` tokens/s with burst
        ``max(rate, 1)``.  Raises ``JobThrottled`` with a computed
        ``retry_after`` — for the bucket it is exactly the time until
        the next token, for the quota a fixed re-poll hint (job
        durations are unknowable at admission)."""
        ent = self._tenants.get(tenant)
        if ent is None:
            ent = self._tenants[tenant] = {
                "tokens": max(self._tenant_rate, 1.0),
                "last": time.monotonic(),
                "admitted": 0,
                "throttled": 0,
            }
        if self._tenant_max_active:
            active = sum(
                1
                for j in self._jobs.values()
                if j.tenant == tenant
                and j.status()["state"] not in TERMINAL_STATES
            )
            if active >= self._tenant_max_active:
                ent["throttled"] += 1
                raise JobThrottled(
                    f"tenant {tenant!r} has {active} active jobs, at the "
                    f"per-tenant bound of {self._tenant_max_active} "
                    "(KSIM_JOBS_TENANT_MAX_ACTIVE)",
                    retry_after=5.0,
                )
        if self._tenant_rate:
            now = time.monotonic()
            burst = max(self._tenant_rate, 1.0)
            ent["tokens"] = min(
                burst, ent["tokens"] + (now - ent["last"]) * self._tenant_rate
            )
            ent["last"] = now
            if ent["tokens"] < 1.0:
                ent["throttled"] += 1
                raise JobThrottled(
                    f"tenant {tenant!r} is over the sustained submission "
                    f"rate of {self._tenant_rate:g}/s "
                    "(KSIM_JOBS_TENANT_RATE)",
                    retry_after=(1.0 - ent["tokens"]) / self._tenant_rate,
                )
            ent["tokens"] -= 1.0
        ent["admitted"] += 1

    def _prune_locked(self) -> None:  # ksimlint: lock-held(_lock)
        """Bound the registry: drop the oldest TERMINAL jobs beyond the
        retention limit (live jobs are never dropped — the bounded
        queue is what limits those)."""
        if len(self._jobs) <= self._keep:
            return
        for jid in list(self._jobs):
            if len(self._jobs) <= self._keep:
                break
            j = self._jobs[jid]
            if j.status()["state"] in TERMINAL_STATES:
                del self._jobs[jid]

    # -- the workers -----------------------------------------------------

    def _worker_loop(self) -> None:  # ksimlint: thread-role(job-worker)
        while True:
            job = self.queue.get()
            if job is None:
                return
            if not job.claim():
                continue  # cancelled while queued
            with self._lock:
                self._active += 1
            try:
                self._run_job(job)
            finally:
                with self._lock:
                    self._active -= 1

    def _run_job(self, job: Job) -> None:
        """Run one job inside its scoped planes.  The global TRACE's
        scoped override routes every span/event of the whole pipeline —
        runner, service, replay driver, even the dispatch worker thread
        (the executor re-installs the scope there) — onto the job's
        private plane, tagged ``job=<id>``."""
        # WAL: the running record lands BEFORE any work — a restart
        # that finds it (and no terminal record) knows the job died
        # mid-run and flags it ``interrupted``.  An unappendable
        # journal fails the job without running it.
        if not self._journal_state(job, "running"):
            job.finish("failed", error="journal append failed (running)")
            return
        try:
            with TRACE.scoped(job.trace):
                with TRACE.span("jobs.run", steps=job.steps_total):
                    FAULTS.check("jobs.run")
                    if job.faults is not None:
                        job.faults.check("jobs.run")
                    res, runner = self._execute(job)
            result = self._result_doc(job, res, runner)
            # WAL: result + terminal record become durable BEFORE the
            # in-memory success — a success the journal cannot vouch
            # for must not be reported (it would vanish on restart).
            if self._journal is not None:
                ok = self._journal_append(
                    {"t": "result", "id": job.id, "result": result}
                ) and self._journal_state(job, "succeeded")
                if not ok:
                    job.finish("failed", error="journal append failed (result)")
                    return
            job.finish("succeeded", result=result)
        except RunCancelled:
            job.finish("cancelled")
            self._journal_state(job, "cancelled")  # best-effort: terminal
            logger.info("job %s cancelled", job.id)
        except Exception as e:
            logger.exception("job %s failed", job.id)
            error = f"{type(e).__name__}: {e}"
            job.finish("failed", error=error)
            self._journal_state(job, "failed", error=error)  # best-effort
        finally:
            self._maybe_compact()

    def _execute(self, job: Job):
        """Build the job's isolated simulator stack from its spec and
        replay the scenario.  Imported lazily: the manager is
        constructible (and the queue/metrics surface usable) without
        pulling the scheduler and torch into a process that never runs
        a job."""
        from ksim_tpu_torch.scenario.runner import ScenarioRunner
        from ksim_tpu_torch.scheduler.service import SchedulerService
        from ksim_tpu_torch.state.cluster import ClusterStore

        sim = job.sim
        fleet = sim.get("fleet")
        if fleet:
            runner = ScenarioRunner(
                record=sim.get("recordMode", "selection"),
                preemption=bool(sim.get("preemption", False)),
                max_pods_per_pass=sim.get("maxPodsPerPass"),
                pod_bucket_min=sim.get("podBucketMin"),
                device_replay=True,
                fleet=int(fleet),
                cancel=job.cancel,
                exact=self._exact,
                device=self._device,
            )
            job.runner = runner
            res = runner.run(job.ops)
            return res, runner
        # Solo path: restore from the newest valid journaled checkpoint
        # when recovery carried any (KSIM_JOBS_RESUME=1), else build
        # fresh; either way the runner gets the checkpoint-cadence hook.
        resume_cursor = 0
        resume_result = None
        store = service = None
        if job.checkpoints:
            restored = self._restore_checkpoint(job, sim)
            if restored is not None:
                store, service, resume_cursor, resume_result = restored
        if store is None:
            store = ClusterStore()
            if sim.get("initialSnapshot"):
                from ksim_tpu_torch.state.snapshot import SnapshotService

                SnapshotService(store).load(sim["initialSnapshot"])
            service = SchedulerService(
                store,
                config=sim.get("schedulerConfig"),
                record=sim.get("recordMode", "selection"),
                preemption=bool(sim.get("preemption", False)),
                max_pods_per_pass=sim.get("maxPodsPerPass"),
                pod_bucket_min=sim.get("podBucketMin"),
                exact=self._exact,
                device=self._device,
            )
        hook = None
        if self._journal is not None and self._checkpoint_every > 0:
            hook = self._checkpoint_hook_for(job, store, service)
        runner = ScenarioRunner(
            store=store,
            service=service,
            device_replay=bool(sim.get("deviceReplay", False)),
            cancel=job.cancel,
            private_faults=job.faults,
            checkpoint_hook=hook,
        )
        job.store = store
        job.runner = runner
        res = runner.run(
            job.ops, resume_cursor=resume_cursor, resume_result=resume_result
        )
        return res, runner

    def _checkpoint_hook_for(self, job: Job, store, service):
        """The runner's post-commit segment callback: every
        ``KSIM_JOBS_CHECKPOINT_EVERY``-th COMMITTED segment appends one
        checkpoint record.  Committed segments are counted here (not
        ``segment_seq``, which also counts segments that later rolled
        back) so the cadence is exactly "every N durable advances"."""
        state = {"committed": 0, "seq": 0}

        def hook(cursor: int, driver, result) -> None:
            state["committed"] += 1
            if state["committed"] % self._checkpoint_every:
                return
            state["seq"] += 1
            self._append_checkpoint(
                job, store, service, cursor, driver, result, state["seq"]
            )

        return hook

    def _append_checkpoint(
        self, job: Job, store, service, cursor: int, driver, result, seq: int
    ) -> None:
        """Build + durably append one segment checkpoint.  Best-effort
        by contract: a non-restorable moment (Permit-waiting pods), an
        oversized snapshot, or any append/snapshot failure SKIPS the
        checkpoint with a counted ``jobs.checkpoint`` event — the run
        itself must never degrade because its insurance did."""
        try:
            with TRACE.span(
                "jobs.checkpoint_append", job=job.id, cursor=cursor
            ):
                FAULTS.check("jobs.checkpoint_append")
                carries = service.checkpoint_carries()
                if carries.pop("waiting"):
                    # Pods parked in a Permit plugin's waiting map are
                    # scheduling state with no restore story — resuming
                    # without them would double-admit or drop them.
                    TRACE.event(
                        "jobs.checkpoint", job=job.id,
                        skipped=True, reason="waiting_pods",
                    )
                    return
                rec = {
                    "t": "checkpoint",
                    "id": job.id,
                    "seq": seq,
                    "cursor": int(cursor),
                    "segment": int(driver.segment_seq),
                    # Restore-time identity check: a resume
                    # whose simulator spec changed must NOT consume
                    # this record (see _spec_hash / _restore_checkpoint).
                    "spec": _spec_hash(job.sim),
                    "store": store.checkpoint(),
                    "service": carries,
                    "result": {
                        "events_applied": result.events_applied,
                        "pods_scheduled": result.pods_scheduled,
                        "unschedulable_attempts": result.unschedulable_attempts,
                        "steps": [
                            [
                                s.step, s.ops_applied, s.scheduled,
                                s.unschedulable, s.pending_after,
                            ]
                            for s in result.steps
                        ],
                    },
                    "ts": round(time.time(), 3),
                }
                size = len(json.dumps(rec, separators=(",", ":")))
                if self._checkpoint_max_bytes and size > self._checkpoint_max_bytes:
                    TRACE.event(
                        "jobs.checkpoint", job=job.id, skipped=True,
                        reason="max_bytes", bytes=size,
                    )
                    return
                if not self._journal_append(rec):
                    TRACE.event(
                        "jobs.checkpoint", job=job.id,
                        skipped=True, reason="append_failed",
                    )
                    return
                with job._cond:
                    job._last_checkpoint = rec
                    job.checkpoint_segment = rec["segment"]
                TRACE.event(
                    "jobs.checkpoint", job=job.id, cursor=cursor,
                    segment=rec["segment"], bytes=size,
                )
        except Exception:
            # Injected jobs.checkpoint_append faults and unexpected
            # snapshot failures land here: counted, contained, the run
            # continues (and retries at the next cadence point).
            logger.exception("job %s checkpoint append failed", job.id)
            TRACE.event(
                "jobs.checkpoint", job=job.id,
                skipped=True, reason="append_failed",
            )

    def _restore_checkpoint(self, job: Job, sim: dict):
        """Newest-first restore attempts over the job's journaled
        checkpoints (worker thread — the only place the torch/scheduler
        stack may load).  Returns (store, service, cursor, partial
        result) or None (every checkpoint unusable → replay from
        scratch).  A failed attempt falls back to the PREVIOUS
        checkpoint: the mid-file analogue of the journal's torn-tail
        rule, which already drops a checkpoint torn mid-append before
        recovery ever sees it."""
        from ksim_tpu_torch.scenario.runner import ScenarioResult, StepResult
        from ksim_tpu_torch.scheduler.service import SchedulerService
        from ksim_tpu_torch.state.cluster import ClusterStore

        want = _spec_hash(sim)
        for rec in reversed(job.checkpoints):
            seg = rec.get("segment")
            got = rec.get("spec")
            if got is not None and got != want:
                # Round 19 (the code half of "Resume across a config
                # change", docs/jobs.md): the checkpoint was cut under a
                # DIFFERENT simulator spec — restoring its carries into
                # a service built from the new config would silently
                # diverge, so the record is refused (counted, loud) and
                # the scan falls through to older records; when every
                # checkpoint predates the change the job replays from
                # scratch — the correct-but-slow outcome the doc
                # promises.  Records without a "spec" field (pre-round-
                # 19 journals) restore as before.
                TRACE.event(
                    "jobs.checkpoint_restore", job=job.id, restored=False,
                    segment=seg, reason="spec_hash",
                )
                continue
            try:
                with TRACE.span(
                    "jobs.checkpoint_restore", job=job.id, segment=seg
                ):
                    FAULTS.check("jobs.checkpoint_restore")
                    store = ClusterStore.from_checkpoint(rec["store"])
                    # The service rebuilds from the SPEC (its config is
                    # deterministic given the document); the
                    # initialSnapshot is deliberately NOT re-loaded —
                    # its objects are already inside the restored store.
                    service = SchedulerService(
                        store,
                        config=sim.get("schedulerConfig"),
                        record=sim.get("recordMode", "selection"),
                        preemption=bool(sim.get("preemption", False)),
                        max_pods_per_pass=sim.get("maxPodsPerPass"),
                        pod_bucket_min=sim.get("podBucketMin"),
                        exact=self._exact,
                        device=self._device,
                    )
                    service.restore_carries(rec.get("service") or {})
                    acc = rec.get("result") or {}
                    result = ScenarioResult(
                        events_applied=int(acc.get("events_applied", 0)),
                        pods_scheduled=int(acc.get("pods_scheduled", 0)),
                        unschedulable_attempts=int(
                            acc.get("unschedulable_attempts", 0)
                        ),
                    )
                    for row in acc.get("steps") or ():
                        result.steps.append(
                            StepResult(*[int(v) for v in row])
                        )
                    cursor = int(rec["cursor"])
            except Exception as e:
                logger.exception(
                    "job %s checkpoint (segment %s) unusable; falling "
                    "back to the previous one", job.id, seg,
                )
                TRACE.event(
                    "jobs.checkpoint_restore", job=job.id, restored=False,
                    segment=seg, error=type(e).__name__,
                )
                continue
            TRACE.event(
                "jobs.checkpoint_restore", job=job.id, restored=True,
                segment=seg, cursor=cursor,
            )
            with job._cond:
                job.resumed_from = seg
                job.checkpoint_segment = seg
                # The progress baseline: the restored steps are done,
                # only suffix segments/passes add to it from here.
                job.steps_done = len(result.steps)
            job._resume_info = {
                "fromSegment": seg,
                "cursor": cursor,
                "carried_events": result.events_applied,
            }
            return store, service, cursor, result
        return None

    def _result_doc(self, job: Job, res, runner) -> dict:
        doc: dict = {
            "phase": "Succeeded",
            "done": res.succeeded,
            "result": {
                "eventsApplied": res.events_applied,
                "podsScheduled": res.pods_scheduled,
                "unschedulableAttempts": res.unschedulable_attempts,
                "wallSeconds": round(res.wall_seconds, 3),
                "steps": len(res.steps),
            },
            "phases": dict(res.phase_seconds),
            # The job's OWN latency quantiles (its private histograms).
            "latency": job.trace_summary()["histograms"],
        }
        if res.lanes is not None:
            doc["lanes"] = [
                [r.pods_scheduled, r.unschedulable_attempts] for r in res.lanes
            ]
        info = job._resume_info
        if info is not None:
            # eventsReplayed counts only THIS process's suffix — the
            # restart-check/bench evidence that an incremental resume
            # did strictly less work than a from-scratch replay.
            doc["resume"] = {
                "fromSegment": info["fromSegment"],
                "cursor": info["cursor"],
                "eventsReplayed": res.events_applied - info["carried_events"],
            }
        drv = getattr(runner, "replay_driver", None)
        if drv is not None:
            doc["replay"] = drv.stats()  # includes the shared compile_cache
        return doc

    # -- lookups & lifecycle --------------------------------------------

    def get(self, job_id: str) -> "Job | None":
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs.values())

    def cancel(self, job_id: str) -> "str | None":
        """Request cancellation; returns the post-request state, or
        None for an unknown job."""
        job = self.get(job_id)
        if job is None:
            return None
        already_done = job.status()["state"] in TERMINAL_STATES
        state = job.request_cancel()
        if not already_done:
            TRACE.event("job.cancelled", job=job.id, state=state)
            # Best-effort WAL: the cancel REQUEST, plus the terminal
            # record when the queued job finalized right here (a
            # running job's terminal record comes from its worker).
            self._journal_append(
                {"t": "cancel", "id": job.id, "ts": round(time.time(), 3)}
            )
            if state == "cancelled":
                self._journal_state(job, "cancelled")
        return state

    def join(self, timeout: "float | None" = None) -> bool:
        """Wait for every registered job to reach a terminal state
        (tests / bench).  True when all finished inside the timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for job in self.jobs():
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return False
            if not job.wait_done(remaining):
                return False
        return True

    def snapshot(self) -> dict:
        """The ``jobs`` section of /api/v1/metrics: queue depth, worker
        occupancy, and per-job status + private-plane summaries."""
        with self._lock:
            jobs = list(self._jobs.values())
            active = self._active
            tenants = {
                t: {
                    "admitted": e["admitted"],
                    "throttled": e["throttled"],
                    "tokens": round(e["tokens"], 3),
                }
                for t, e in self._tenants.items()
            }
        doc = {
            "queue": self.queue.stats(),
            "workers": {"pool": len(self._threads), "active": active},
            "tenants": tenants,
            "jobs": {
                j.id: dict(j.status(), trace=j.trace_summary()) for j in jobs
            },
        }
        if self._journal is not None:
            doc["journal"] = self._journal.snapshot()
        if self._fleet is not None:
            doc["fleet"] = self._fleet.snapshot()
        return doc

    def shutdown(self, timeout: "float | None" = 5.0) -> None:
        """Stop accepting work, cancel everything live, and join the
        workers (daemon threads — a stuck dispatch cannot block process
        exit, it is simply abandoned like the replay watchdog's).  The
        fleet poller stops LAST so its final drain forwards the jobs'
        terminal events and releases the now-terminal leases."""
        self.queue.close()
        for job in self.jobs():
            job.request_cancel()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            remaining = None if deadline is None else max(deadline - time.monotonic(), 0.1)
            t.join(remaining)
        if self._fleet is not None:
            self._fleet.stop()
