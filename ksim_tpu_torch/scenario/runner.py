"""Scenario runner: apply operations step-by-step, schedule, collect.

KEP-140 semantics (reference keps/140-scenario-based-simulation/README.md):
operations carry a step number; all operations of a step are applied,
then the scheduler runs, then results are recorded.

The port of ``ksim_tpu/scenario/runner.py``: the per-pass loop, the
solo ``device_replay=True`` loop (engine/replay.py, kernel D on a card),
the streaming loop over a trace stream (traces/stream.py, ingest
overlapping the device dispatch), fleet replay (``fleet=S``,
engine/fleet.py), and what the job plane passes: a private fault plane,
a post-commit checkpoint hook and incremental resume (jobs/manager.py).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

import torch

from ksim_tpu_torch.obs import TRACE
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import ClusterStore
from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Operation:
    """One timed mutation (KEP-140 ScenarioOperation: createOperation /
    patchOperation / deleteOperation at a step)."""

    step: int
    op: str  # create | update | patch | delete | done
    kind: str
    obj: JSON | None = None  # create/update payload; merge patch for "patch"
    name: str = ""  # patch/delete target
    namespace: str = ""


@dataclass
class StepResult:
    step: int
    ops_applied: int
    scheduled: int  # pods bound this step
    unschedulable: int  # scheduling attempts with no feasible node
    pending_after: int


@dataclass
class ScenarioResult:
    """The .status.result analogue: per-step aggregates + totals."""

    steps: list[StepResult] = field(default_factory=list)
    events_applied: int = 0
    pods_scheduled: int = 0
    unschedulable_attempts: int = 0
    wall_seconds: float = 0.0
    succeeded: bool = False  # a doneOperation step completed (KEP-140)
    # Per-phase wall-clock split of wall_seconds, sourced from the trace
    # plane (obs.SPAN_NAMES keys): device path = replay.lower /
    # replay.dispatch / replay.reconcile; per-pass host path =
    # runner.step (which NESTS its service.schedule span — the two are
    # reported side by side, not additive).
    phase_seconds: dict[str, float] = field(default_factory=dict)
    phase_counts: dict[str, int] = field(default_factory=dict)
    # Fleet runs (ScenarioRunner(fleet=S)): the per-lane results; the
    # aggregate fields above sum over them.
    lanes: "list[ScenarioResult] | None" = None

    @property
    def events_per_second(self) -> float:
        return self.events_applied / self.wall_seconds if self.wall_seconds else 0.0


class _StreamFeeder:
    """Incremental step-grouper over a streaming operation source
    (traces/stream.py ``TraceOperationStream``): the windowed twin of
    ``ScenarioRunner._group_by_step``, and the one view ``run``'s loop
    reads (a materialized list arrives grouped, see ``materialized``).

    ``keys``/``by_step`` grow as windows arrive; a step is COMPLETE (and
    appended to ``keys``) only once a later step's first operation — or
    EOF — proves no more operations belong to it.  Batch lists keep
    their object identity for as long as they are resident: the replay
    driver's speculative-prelower match (engine/replay.py ``_take_spec``)
    is identity-based, so ``by_step[s]`` must return the SAME list every
    iteration.  ``release`` evicts batches the run has committed past;
    the step keys themselves (small ints) are kept for cursor arithmetic.

    ``ensure`` BLOCKS on the producer queue; ``prefetch`` never blocks
    and is the replay driver's ingest-hook entry (drain while the
    device dispatch is in flight).  Both run on the consumer (main)
    thread only."""

    def __init__(self, stream) -> None:
        self._stream = stream
        self._it = iter(stream)
        self.keys: list[int] = []  # complete steps, ascending
        self.by_step: dict[int, list[Operation]] = {}
        self._open_step: "int | None" = None
        self._open_batch: "list[Operation] | None" = None
        self._eof = False
        self._released = 0  # keys-index cursor: everything below is evicted

    @classmethod
    def materialized(cls, ops: Iterable[Operation]) -> "_StreamFeeder":
        """A feeder over a whole operation list, grouped up front and
        already at EOF: ``ensure`` and ``prefetch`` have nothing left to
        pull, so the windowed loop sees the materialized batches."""
        feeder = cls(())
        feeder.by_step, feeder.keys = ScenarioRunner._group_by_step(ops)
        feeder._eof = True
        return feeder

    def _accept(self, op: Operation) -> None:
        if self._open_step is None or op.step > self._open_step:
            if self._open_step is not None:
                self._seal()
            elif self.keys and op.step <= self.keys[-1]:
                raise ValueError(
                    f"streaming operations out of step order: step {op.step} "
                    f"after step {self.keys[-1]} was sealed"
                )
            self._open_step = op.step
            self._open_batch = [op]
        elif op.step == self._open_step:
            self._open_batch.append(op)
        else:
            raise ValueError(
                f"streaming operations out of step order: step {op.step} "
                f"after step {self._open_step}"
            )

    def _seal(self) -> None:
        self.by_step[self._open_step] = self._open_batch
        self.keys.append(self._open_step)
        self._open_step = None
        self._open_batch = None

    def ensure(self, n: int) -> None:
        """Block until ``n`` complete steps exist or the stream ends."""
        while len(self.keys) < n and not self._eof:
            try:
                op = next(self._it)
            except StopIteration:
                self._eof = True
                if self._open_step is not None:
                    self._seal()
                return
            self._accept(op)

    def prefetch(self, n: int) -> int:
        """Drain whatever the producer has READY toward ``n`` complete
        steps; never blocks.  Producer-side errors are deferred: they
        re-raise at the next blocking ``ensure``."""
        pulled = 0
        while len(self.keys) < n and not self._eof:
            op = self._stream.next_nowait()
            if op is None:
                break
            self._accept(op)
            pulled += 1
        return pulled

    def release(self, upto: int) -> None:
        """Evict committed step batches (keys indices below ``upto``)."""
        while self._released < min(upto, len(self.keys)):
            self.by_step.pop(self.keys[self._released], None)
            self._released += 1


class ScenarioRunner:
    """Replays an operation stream against a store + scheduler service.

    ``requeue_on_node_delete`` re-marks a deleted node's bound pods as
    pending (the "node preemption" churn of BASELINE config 5 — a drained
    node's pods go back through scheduling, as a controller would recreate
    them).  ``record`` defaults to "selection": full per-node result
    recording multiplies host-side work by O(N) per pod and is opt-in for
    replay (the per-pass results remain available through the service's
    normal watch-driven path)."""

    def __init__(
        self,
        store: ClusterStore | None = None,
        service: SchedulerService | None = None,
        *,
        record: str = "selection",
        preemption: bool = False,
        requeue_on_node_delete: bool = True,
        max_pods_per_pass: int | None = None,
        pod_bucket_min: int | None = None,
        device_replay: bool = False,
        device_segment_steps: int | None = None,
        fleet: int | None = None,
        fleet_faults: str | None = None,
        cancel: "Any | None" = None,
        private_faults: "Any | None" = None,
        checkpoint_hook: "Any | None" = None,
        exact: bool = True,
        device: "str | torch.device | None" = None,
        config: "dict | None" = None,
    ) -> None:
        """``device_replay=True`` routes supported step segments through
        the device-resident path (engine/replay.py): K steps of event
        application + scheduling per kernel launch, host reconcile at
        segment boundaries, byte-identical scheduling counts.  Steps
        containing ops outside the tensor vocabulary (patch/update/done,
        non-pod/node kinds, pods with host ports or volumes, ...) fall
        back to this per-pass path automatically; DefaultPreemption and
        record="full" segments stay on the device (the victim search and
        the streamed records are in kernel D).  ``exact``, ``device`` and
        ``config`` (a KubeSchedulerConfiguration: its profiles and its
        ``extenders``) configure the service the runner builds, and every
        fleet lane's (SchedulerService).

        ``cancel`` (a ``threading.Event``-like object) makes the run
        cooperatively cancellable: the flag is checked before every
        per-pass step and inside the segment reconcile loop, where a set
        flag raises ``errors.RunCancelled`` inside the store transaction,
        rolling the in-flight segment back before it propagates.

        ``private_faults`` (a ``FaultPlane``) is this run's private fault
        plane (the job plane's ``KSIM_JOBS_FAULTS`` and ``spec.faults``):
        checked next to the process-global ``FAULTS`` at the replay sites
        (``replay.lower`` / ``replay.dispatch`` / ``replay.reconcile``)
        like a fleet lane's plane, so a chaos schedule degrades this run
        alone.  Mutually exclusive with ``fleet`` (use ``fleet_faults``
        there).

        ``checkpoint_hook`` (the job plane's incremental-resume cadence)
        is called as ``hook(cursor, driver, result)`` after every
        committed device segment: ``cursor`` is the index into the sorted
        step keys the next iteration starts from, the ``resume_cursor`` a
        later ``run`` needs to replay only the remaining suffix.  It runs
        outside the store transaction and must not raise for policy
        reasons.

        ``fleet=S`` (requires ``device_replay=True``) replays S
        independent trajectories, each with its own store, service and
        replay driver, advancing the fleet K steps per launch with the
        shared universe lowered once per window (engine/fleet.py).
        ``run`` then returns the aggregate result with the per-lane
        results on ``.lanes``; per-lane chaos arms via ``fleet_faults``
        / ``KSIM_FLEET_FAULTS`` (``lane:site=schedule`` entries), per-lane
        streams via ``run(..., lane_ops=...)``.  Lane 0 reuses this
        runner's own store and service."""
        if fleet is not None:
            if fleet < 2:
                raise ValueError("fleet needs at least 2 lanes")
            if not device_replay:
                raise ValueError("fleet replay requires device_replay=True")
            if store is not None or service is not None:
                raise ValueError(
                    "fleet lanes build their own stores/services; pass the "
                    "service CONFIG (record/preemption/...) instead"
                )
        elif fleet_faults is not None:
            # A lane fault spec with no fleet would be silently dropped.
            raise ValueError("fleet_faults requires fleet=S")
        if fleet is not None and private_faults is not None:
            raise ValueError(
                "private_faults is the solo-run chaos surface; fleet lanes "
                "arm per-lane planes via fleet_faults/KSIM_FLEET_FAULTS"
            )
        self.store = store if store is not None else ClusterStore()
        self.service = (
            service
            if service is not None
            else SchedulerService(
                self.store,
                record=record,
                preemption=preemption,
                max_pods_per_pass=max_pods_per_pass,
                pod_bucket_min=pod_bucket_min,
                exact=exact,
                device=device,
                config=config,
            )
        )
        self._requeue = requeue_on_node_delete
        self._drained_nodes: set[str] = set()
        self._device_replay = device_replay
        self._device_segment_steps = device_segment_steps
        self._fleet = fleet
        self._fleet_faults = fleet_faults
        # Per-lane service construction config (fleet lanes must match
        # lane 0's scheduling semantics exactly).
        self._lane_cfg = dict(
            record=record,
            preemption=preemption,
            max_pods_per_pass=max_pods_per_pass,
            pod_bucket_min=pod_bucket_min,
            exact=exact,
            device=device,
            config=config,
        )
        # Fleet-lane identity (set per lane by _run_fleet): the lane's
        # spans carry it.  One private-plane slot serves both chaos
        # surfaces, fleet lanes (set per lane) and solo job runs
        # (private_faults): the reconcile and driver checks are the same.
        self._lane: int | None = None
        self._lane_faults = private_faults
        self._cancel = cancel
        # Post-commit segment callback (job-plane checkpoints).  None for
        # fleet lanes: cohort segments commit lane by lane, and a per-lane
        # cursor is not a resume point.
        self._checkpoint_hook = checkpoint_hook
        # The last run's ReplayDriver (evidence counters: device_steps,
        # fallback_steps, device_round_trips, unsupported reasons).
        self.replay_driver = None
        # Fleet evidence (set by a fleet run): the FleetDriver (stats())
        # and the FleetLane list (per-lane runners, drivers, results).
        self.fleet_driver = None
        self.fleet_lanes = None

    def _check_cancelled(self) -> None:
        """Raise ``RunCancelled`` if the run's cancel flag is set.  Called
        between per-pass steps and inside the segment reconcile loop —
        the latter aborts (and rolls back) the in-flight store
        transaction, so a cancel never leaves a half-applied window."""
        if self._cancel is not None and self._cancel.is_set():
            from ksim_tpu_torch.errors import RunCancelled

            raise RunCancelled("scenario run cancelled")

    # -- one operation ------------------------------------------------------

    @staticmethod
    def _own(obj: JSON) -> JSON:
        """Hand an operation's object to the store without a deepcopy
        (two per create were ~11% of the 50k churn replay).  Only the
        top level and metadata are copied: the store writes rv/uid/
        namespace into metadata, and a same-ops-list replay must not see
        the previous run's values.  Nested structures are shared — safe
        under the store's replace-on-write contract (nothing mutates
        them in place)."""
        out = dict(obj)
        md = out.get("metadata")
        out["metadata"] = dict(md) if isinstance(md, dict) else {}
        return out

    def _apply(self, op: Operation) -> None:
        if op.op == "create":
            self.store.create(op.kind, self._own(op.obj), copy_obj=False)
        elif op.op == "update":
            self.store.update(op.kind, self._own(op.obj), copy_obj=False)
        elif op.op == "patch":
            # KEP-140 PatchOperation: RFC 7386 merge patch (scenario/spec.py).
            # Object identity is immutable under patch, like the apiserver:
            # name/namespace/uid survive whatever the patch does to
            # metadata (a patch can't rename or unkey an object).
            from ksim_tpu_torch.scenario.spec import ScenarioSpecError, merge_patch

            def apply_merge(obj: JSON) -> None:
                merged = merge_patch(obj, op.obj)
                if not isinstance(merged, dict):
                    raise ScenarioSpecError(
                        f"patch for {op.kind}/{op.name} must produce an object"
                    )
                orig_md = obj.get("metadata", {})
                md = merged.get("metadata")
                md = dict(md) if isinstance(md, dict) else {}
                for key in ("name", "namespace", "uid", "resourceVersion"):
                    if orig_md.get(key) is not None:
                        md[key] = orig_md[key]
                merged["metadata"] = md
                obj.clear()
                obj.update(merged)

            self.store.patch(
                op.kind, op.name, op.namespace, apply_merge, copy_ret=False
            )
        elif op.op == "delete":
            if op.kind == "nodes" and self._requeue:
                # Deferred: run() re-queues all drained nodes' pods in ONE
                # pod walk after the step's ops (walking the whole pod
                # list per node delete dominated churn host time).
                self._drained_nodes.add(op.name)
            self.store.delete(op.kind, op.name, op.namespace)
        elif op.op == "done":
            pass  # handled in run(): terminates after this step
        else:
            raise ValueError(f"unknown op {op.op!r}")

    def _requeue_pods_of(self, node_names: set[str]) -> None:
        if not node_names:
            return

        def clear(obj: JSON) -> None:
            obj["spec"].pop("nodeName", None)
            obj.get("status", {}).pop("phase", None)

        # The store's nodeName bucket index bounds the walk to pods ON
        # the drained nodes (the earlier bound-side walk still scanned
        # every bound pod per drain — ~10s of the 50k replay); the
        # matches sort by (name, "ns/name") — exactly list("pods")'s
        # (name, key) order — so patches apply (and consume
        # resourceVersions) in the same order the full walk produced.
        hit = [
            (name_of(p), f"{namespace_of(p) or 'default'}/{name_of(p)}", namespace_of(p))
            for p in self.store.pods_on_nodes(node_names)
        ]
        for name, _key, ns in sorted(hit):
            self.store.patch("pods", name, ns, clear, copy_ret=False)

    # -- replay -------------------------------------------------------------

    def _apply_batch(self, batch: Sequence[Operation]) -> bool:
        """Apply one step's operations to the store (+ deferred requeue).
        Returns whether the step carried a doneOperation."""
        done = False
        self._drained_nodes = set()
        for op in batch:
            self._apply(op)
            done = done or op.op == "done"
        self._requeue_pods_of(self._drained_nodes)
        return done

    def _run_step(self, step: int, batch: list[Operation], result: ScenarioResult) -> bool:
        """The per-pass step body: apply ops, flush, one scheduling pass.
        Returns the done flag."""
        tags = {} if self._lane is None else {"lane": self._lane}
        with TRACE.span("runner.step", step=step, ops=len(batch), **tags):
            return self._run_step_traced(step, batch, result)

    def _run_step_traced(
        self, step: int, batch: list[Operation], result: ScenarioResult
    ) -> bool:
        done = self._apply_batch(batch)
        result.events_applied += len(batch)
        # The runner drives the store directly (no watch loop), so it
        # raises the capacity-freed/topology-changed signal itself:
        # node ops and pod deletions flush the unschedulable backoff.
        if any(
            op.kind in ("nodes", "persistentvolumes",
                        "persistentvolumeclaims", "storageclasses")
            or (op.op == "delete" and op.kind == "pods")
            for op in batch
        ):
            self.service.flush_backoff()
        placements = self.service.schedule_pending()
        scheduled = sum(1 for v in placements.values() if v is not None)
        unsched = len(placements) - scheduled
        result.pods_scheduled += scheduled
        result.unschedulable_attempts += unsched
        result.steps.append(
            StepResult(
                step=step,
                ops_applied=len(batch),
                scheduled=scheduled,
                unschedulable=unsched,
                pending_after=self.service.pending_count(),
            )
        )
        return done

    def _stage_device_step(self, batch: list[Operation], outcome, eviction_sink: list) -> None:
        """Stage one device-computed step's STORE writes: the step's ops
        (+ requeue), then the pass's placements in commit order.  With
        per-attempt detail (preemption / record="full" segments) each
        attempt's write mirrors the per-pass rebuild — result
        annotations, bind or nomination — followed by its preemption
        victims' evictions, in the per-pass order.  Runs inside the
        segment transaction: store-only (victim eviction listeners defer
        into ``eviction_sink`` and fire after the commit)."""
        self._apply_batch(batch)
        if outcome.attempts is not None:
            from ksim_tpu_torch.engine.annotations import apply_results_to_pod

            for att in outcome.attempts:
                if att.anno or att.node or att.nominated:

                    def mutate(obj: JSON, att=att) -> None:
                        if att.anno:
                            annos = obj.setdefault("metadata", {}).setdefault("annotations", {})
                            apply_results_to_pod(annos, att.anno)
                        if att.node:
                            obj.setdefault("spec", {})["nodeName"] = att.node
                            obj.setdefault("status", {})["phase"] = "Running"
                            obj.get("status", {}).pop("nominatedNodeName", None)
                        elif att.nominated:
                            obj.setdefault("status", {})["nominatedNodeName"] = att.nominated

                    self.store.patch("pods", att.name, att.namespace, mutate, copy_ret=False)
                for vns, vname in att.victims:
                    self.service._evict_victim(
                        {"metadata": {"name": vname, "namespace": vns}}, listener_sink=eviction_sink
                    )
            return
        for ns, name, node in outcome.binds:

            def bind(obj: JSON) -> None:
                obj.setdefault("spec", {})["nodeName"] = node
                obj.setdefault("status", {})["phase"] = "Running"
                obj.get("status", {}).pop("nominatedNodeName", None)

            self.store.patch("pods", name, ns, bind, copy_ret=False)

    def _record_device_step(
        self, step: int, batch: list[Operation], outcome, result: ScenarioResult
    ) -> None:
        """Post-commit result accounting for one device step."""
        result.events_applied += len(batch)
        result.pods_scheduled += outcome.scheduled
        result.unschedulable_attempts += outcome.unschedulable
        result.steps.append(
            StepResult(
                step=step,
                ops_applied=len(batch),
                scheduled=outcome.scheduled,
                unschedulable=outcome.unschedulable,
                pending_after=outcome.pending_after,
            )
        )

    def _commit_segment(
        self, seg_keys, batches, seg, driver, result: ScenarioResult
    ) -> bool:
        """Reconcile one device-computed segment ALL-OR-NOTHING.

        Every store write of the segment — event ops, requeue patches,
        bind patches — stages inside one store transaction, the
        device-vs-store parity check runs against the staged state, and
        only then does the batch commit (watch events deliver at commit,
        in write order).  The service-side effects with no rollback story
        — featurizer slot advances, backoff/pass-count sync, result
        accumulation — run strictly AFTER the commit.

        An INJECTED fault mid-reconcile (the fault plane's
        InjectedFault) rolls the whole segment back and returns False:
        the store is byte-identical to the segment's start and the
        caller proceeds exactly as if the segment had never lowered —
        the window's head step runs per-pass, the remaining steps are
        retried on-device in the next window.  Everything else — ReplayParityError, store-integrity errors
        (NotFound/Conflict are device-decode bugs wearing a
        SimulatorError class), programming errors — still propagates
        LOUDLY, but now with the store rolled back rather than
        half-applied: a kernel bug must never be indistinguishable
        from an injected chaos fault."""
        from ksim_tpu_torch.faults import FAULTS, InjectedFault

        evictions: list = []
        step_nodes: list = []
        tags = {} if self._lane is None else {"lane": self._lane}
        try:
            with TRACE.span(
                "replay.reconcile", segment=driver.segment_seq, steps=len(seg.steps), **tags
            ), self.store.transaction(epoch_exempt=True):
                # epoch_exempt: the segment's own staged writes are the
                # deltas the driver's lower-cache already tracks; only
                # OUT-OF-BAND writes may move the store mutation epoch
                # (and thereby invalidate the cache).  A rollback takes
                # the explicit invalidation path (note_reconcile_fault).
                for batch, outcome in zip(batches, seg.steps):
                    # A cancel landing mid-segment aborts here: it is not
                    # an InjectedFault, so the transaction rolls back and
                    # it propagates.
                    self._check_cancelled()
                    FAULTS.check("replay.reconcile")
                    if self._lane_faults is not None:
                        # The lane's private plane: a fault here rolls
                        # back only this lane's segment.
                        self._lane_faults.check("replay.reconcile")
                    self._stage_device_step(batch, outcome, evictions)
                    # Captured per step for the deferred slot advance:
                    # live node dicts are frozen (replace-on-write), so
                    # the references stay valid after commit.
                    step_nodes.append(
                        self.store.list("nodes", copy_objs=False)
                        if outcome.eligible > 0
                        else None
                    )
                driver.verify_segment(seg)
        except InjectedFault as e:
            driver.note_reconcile_fault()
            logger.warning(
                "device segment reconcile aborted (%s: %s); store rolled "
                "back — the window's head step re-runs per-pass, the rest "
                "retries on-device",
                type(e).__name__, e,
            )
            return False
        self.service._notify_evictions(evictions)
        driver.advance_service_slots(step_nodes)
        driver.sync_service(seg)
        driver.device_steps += len(seg.steps)
        for step, batch, outcome in zip(seg_keys, batches, seg.steps):
            self._record_device_step(step, batch, outcome, result)
        return True

    def run(
        self,
        ops: Iterable[Operation],
        *,
        lane_ops: "dict[int, Iterable[Operation]] | None" = None,
        resume_cursor: int = 0,
        resume_result: "ScenarioResult | None" = None,
    ) -> ScenarioResult:
        """Apply operations grouped by step; one scheduling pass per step
        (every pending pod is attempted each pass, like the upstream
        queue's flush on cluster events).  With ``device_replay`` on,
        supported K-step segments run as single device dispatches (see
        engine/replay.py); everything else takes this per-pass loop.

        ``resume_cursor``/``resume_result`` are the incremental-resume
        entry: replay starts at sorted-step-key index ``resume_cursor``
        (the cursor a ``checkpoint_hook`` reported), accumulating into
        ``resume_result`` (the checkpoint's partial accounting) instead of
        a fresh result.  The caller restores the matching store and
        service state first; the suffix then replays exactly as the
        uninterrupted run's tail.  ``wall_seconds`` covers only this
        process's replay.

        With ``fleet=S`` the stream replays on every lane (``lane_ops``
        overrides individual lanes' streams: those lanes run the solo
        device path, outside the shared-universe cohort) and the result
        carries the per-lane results on ``.lanes``.

        A STREAMING source (``ops.streaming_ops`` — traces/stream.py)
        takes the windowed loop: operations are consumed as the producer
        emits them, never materialized whole, with ingest overlapping the
        in-flight device dispatch.  Streaming is the solo fresh-run path:
        fleet replays and incremental resume both need the full sorted
        step-key index up front."""
        streaming = getattr(ops, "streaming_ops", False)
        if streaming:
            if self._fleet is not None or lane_ops:
                raise ValueError(
                    "streaming ingest is the solo-run path (fleet replay "
                    "materializes its lanes)"
                )
            if resume_cursor or resume_result is not None:
                raise ValueError(
                    "incremental resume needs materialized operations "
                    "(a resume cursor indexes the full sorted step-key list)"
                )
            if self._checkpoint_hook is not None:
                raise ValueError(
                    "checkpoint_hook needs materialized operations (its "
                    "cursor must stay valid for a later resume)"
                )
        elif self._fleet is not None:
            if resume_cursor or resume_result is not None:
                raise ValueError(
                    "incremental resume is the solo-run path; fleet runs "
                    "restart from scratch (no per-lane cursor yet)"
                )
            return self._run_fleet(ops, lane_ops)
        elif lane_ops:
            raise ValueError("lane_ops requires fleet=S")
        result = resume_result if resume_result is not None else ScenarioResult()
        # Per-phase wall-clock split rides on the trace plane's latency
        # histograms; timing-only mode costs two clock reads per span at
        # segment/pass granularity and never touches scheduling state
        # (the behavior locks hold with it on — tests pin that).
        TRACE.ensure_timing()
        phase0 = TRACE.phase_totals()
        t0 = time.perf_counter()
        # One windowed loop for both sources: a streaming source fills the
        # feeder as the producer emits, a materialized one arrives grouped
        # and at EOF.  Committed step batches are evicted as the cursor
        # advances, so a stream holds a window and its lookahead in host
        # memory, not the whole trace.
        feeder = _StreamFeeder(ops) if streaming else _StreamFeeder.materialized(ops)
        driver = None
        try:
            if self._device_replay:
                from ksim_tpu_torch.engine.replay import SEGMENT_STEPS, ReplayDriver

                # The hook's prefetch target is re-aimed every iteration:
                # 4·k steps past the cursor bounds the opportunistic drain
                # the driver runs while each dispatch is in flight.
                target = [0]
                driver = ReplayDriver(
                    self.store,
                    self.service,
                    k=self._device_segment_steps or SEGMENT_STEPS,
                    requeue_on_node_delete=self._requeue,
                    lane_faults=self._lane_faults,
                    ingest_hook=(lambda: feeder.prefetch(target[0])) if streaming else None,
                )
                self.replay_driver = driver
            i = resume_cursor
            while True:
                self._check_cancelled()
                if driver is not None:
                    # Two windows' worth of batches ride along as LOOKAHEAD;
                    # blocking here is the backpressure point when replay
                    # outruns ingest.
                    feeder.ensure(i + 2 * driver.k)
                    target[0] = i + 4 * driver.k
                else:
                    feeder.ensure(i + 1)
                if i >= len(feeder.keys):
                    break
                if driver is not None:
                    # Tails shorter than K do not fall back: the driver
                    # consumes the supported PREFIX of the window (possibly
                    # shorter than K for mid-window vocabulary misses) and
                    # pads on-device to the segment's K.  While this
                    # window's dispatch runs on the watchdogged worker, the
                    # driver pre-parses the next window's store-independent
                    # prefix on this thread (engine/replay.py
                    # _prelower_next).  The batch lists are the same objects
                    # every iteration (feeder.by_step), so the prefix
                    # matches the window that runs next by identity alone.
                    batches = [feeder.by_step[s] for s in feeder.keys[i : i + 2 * driver.k]]
                    seg = driver.try_segment(batches)
                    if seg is not None and self._commit_segment(
                        feeder.keys[i : i + len(seg.steps)],
                        batches[: len(seg.steps)],
                        seg,
                        driver,
                        result,
                    ):
                        i += len(seg.steps)
                        feeder.release(i)
                        if self._checkpoint_hook is not None:
                            self._checkpoint_hook(i, driver, result)
                        continue
                step = feeder.keys[i]
                if driver is not None:
                    driver.fallback_steps += 1
                done = self._run_step(step, feeder.by_step[step], result)
                i += 1
                feeder.release(i)
                if done:
                    # KEP-140 DoneOperation: "when finish the step
                    # DoneOperation belongs, this Scenario changes its
                    # status to Succeeded" — later steps are not run.
                    result.succeeded = True
                    break
        finally:
            if streaming:
                # An abandoned producer blocked on a full queue would leak;
                # close() is idempotent and also covers clean exhaustion.
                ops.close()
        result.wall_seconds = time.perf_counter() - t0
        # The trace plane is process-global: diff its totals around this
        # run so concurrent earlier runs don't bleed into the split.
        for name, (total, count) in TRACE.phase_totals().items():
            prev_total, prev_count = phase0.get(name, (0.0, 0))
            if count > prev_count:
                result.phase_seconds[name] = round(total - prev_total, 6)
                result.phase_counts[name] = count - prev_count
        return result

    @staticmethod
    def _group_by_step(ops: Iterable[Operation]) -> tuple[dict, list]:
        by_step: dict[int, list[Operation]] = {}
        for op in ops:
            by_step.setdefault(op.step, []).append(op)
        return by_step, sorted(by_step)

    def _run_fleet(self, ops, lane_ops) -> ScenarioResult:
        """Fleet replay (engine/fleet.py): S independent trajectories, the
        shared universe lowered once per window, one launch per cohort
        window, per-lane reconcile into each lane's own store.  Parity
        contract: every lane's counts and annotations equal its solo
        ``device_replay=True`` run."""
        import os

        # A cancel that landed before the fleet was built; mid-run
        # cancels thread through every lane runner.
        self._check_cancelled()
        from ksim_tpu_torch.engine.fleet import FleetDriver, FleetLane, parse_fleet_faults
        from ksim_tpu_torch.engine.replay import SEGMENT_STEPS, ReplayDriver

        n = self._fleet
        if lane_ops:
            # A typoed index would silently replay the base stream on
            # every lane and the sweep would be vacuous.
            bad = sorted(k for k in lane_ops if not 0 <= k < n)
            if bad:
                raise ValueError(f"lane_ops lanes {bad} outside the fleet (0..{n - 1})")
            if any(getattr(v, "streaming_ops", False) for v in lane_ops.values()):
                raise ValueError(
                    "streaming ingest is the solo-run path (lane_ops streams "
                    "must be materialized)"
                )
        spec = self._fleet_faults
        if spec is None:
            spec = os.environ.get("KSIM_FLEET_FAULTS", "")
        planes = parse_fleet_faults(spec, n) if spec else {}
        base_by_step, base_keys = self._group_by_step(ops)
        k = self._device_segment_steps or SEGMENT_STEPS
        lanes: list[FleetLane] = []
        for idx in range(n):
            if idx == 0:
                lane_runner = ScenarioRunner(
                    store=self.store,
                    service=self.service,
                    requeue_on_node_delete=self._requeue,
                    device_replay=True,
                    device_segment_steps=self._device_segment_steps,
                    cancel=self._cancel,
                )
            else:
                lane_runner = ScenarioRunner(
                    requeue_on_node_delete=self._requeue,
                    device_replay=True,
                    device_segment_steps=self._device_segment_steps,
                    cancel=self._cancel,
                    **self._lane_cfg,
                )
            lane_runner._lane = idx
            lane_runner._lane_faults = planes.get(idx)
            lane_runner.service._trace_lane = idx
            own = lane_ops.get(idx) if lane_ops else None
            if own is not None:
                # A per-lane stream: divergent from the start, it rides
                # the solo device path.
                by_step, keys = self._group_by_step(own)
                shared = False
            else:
                by_step, keys = base_by_step, base_keys
                shared = True
            driver = ReplayDriver(
                lane_runner.store,
                lane_runner.service,
                k=k,
                requeue_on_node_delete=self._requeue,
                lane=idx,
                lane_faults=planes.get(idx),
            )
            lane_runner.replay_driver = driver
            lanes.append(
                FleetLane(
                    idx=idx,
                    runner=lane_runner,
                    driver=driver,
                    keys=keys,
                    by_step=by_step,
                    result=ScenarioResult(),
                    faults=planes.get(idx),
                    shared_stream=shared,
                    convergent=shared,
                )
            )
        fleet = FleetDriver(lanes)
        self.fleet_driver = fleet
        self.fleet_lanes = lanes
        self.replay_driver = lanes[0].driver
        TRACE.ensure_timing()
        phase0 = TRACE.phase_totals()
        t0 = time.perf_counter()
        fleet.run()
        wall = time.perf_counter() - t0
        agg = ScenarioResult(lanes=[ln.result for ln in lanes])
        for ln in lanes:
            ln.result.wall_seconds = wall  # fleet lanes finish together
            agg.events_applied += ln.result.events_applied
            agg.pods_scheduled += ln.result.pods_scheduled
            agg.unschedulable_attempts += ln.result.unschedulable_attempts
        # Solo semantics per lane: succeeded = a doneOperation completed.
        agg.succeeded = all(ln.result.succeeded for ln in lanes)
        agg.wall_seconds = wall
        for name, (total, count) in TRACE.phase_totals().items():
            prev_total, prev_count = phase0.get(name, (0.0, 0))
            if count > prev_count:
                agg.phase_seconds[name] = round(total - prev_total, 6)
                agg.phase_counts[name] = count - prev_count
        return agg
