"""Scenario runner: apply operations step-by-step, schedule, collect.

KEP-140 semantics (reference keps/140-scenario-based-simulation/README.md):
operations carry a step number; all operations of a step are applied,
then the scheduler runs, then results are recorded.

The port of ``ksim_tpu/scenario/runner.py``: the per-pass loop and the
solo ``device_replay=True`` loop (engine/replay.py, kernel D on a card).
Not ported, each refused with an error: fleet replay (``fleet=``),
streaming ingest (an ``ops`` with ``streaming_ops``), and the Scenario
document loaders of ``scenario/spec.py`` (only its merge patch, which the
``patch`` op applies, is kept here).
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


class ScenarioSpecError(ValueError):
    """Invalid Scenario operation (the KEP's 'the scenario will fail')."""


def merge_patch(target: JSON, patch: Any) -> Any:
    """RFC 7386 JSON merge patch: dicts merge recursively, null deletes,
    everything else replaces (``ksim_tpu/scenario/spec.py``)."""
    if not isinstance(patch, dict):
        return patch
    out = dict(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k, {}), v)
    return out


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

    @property
    def events_per_second(self) -> float:
        return self.events_applied / self.wall_seconds if self.wall_seconds else 0.0


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
        exact: bool = True,
        device: "str | torch.device | None" = None,
    ) -> None:
        """``device_replay=True`` routes supported step segments through
        the device-resident path (engine/replay.py): K steps of event
        application + scheduling per kernel launch, host reconcile at
        segment boundaries, byte-identical scheduling counts.  Steps
        containing ops outside the tensor vocabulary (patch/update/done,
        non-pod/node kinds, pods with host ports or volumes, ...) fall
        back to this per-pass path automatically, as do record="full"
        runs and windows that need DefaultPreemption's victim search
        (their own fallback reasons: the streamed records and the
        on-device search are not in kernel D yet).  ``exact`` and
        ``device`` configure the service the runner builds
        (SchedulerService).

        ``fleet=S`` (S lanes in one vmapped dispatch) is not ported and
        raises NotImplementedError, as does ``fleet_faults``."""
        if fleet is not None or fleet_faults is not None:
            raise NotImplementedError(
                "fleet replay (engine/fleet.py) is not ported to ksim_tpu_torch"
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
            )
        )
        self._requeue = requeue_on_node_delete
        self._drained_nodes: set[str] = set()
        self._device_replay = device_replay
        self._device_segment_steps = device_segment_steps
        # The last run's ReplayDriver (evidence counters: device_steps,
        # fallback_steps, device_round_trips, unsupported reasons).
        self.replay_driver = None

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
        with TRACE.span("runner.step", step=step, ops=len(batch)):
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

    def _stage_device_step(self, batch: list[Operation], outcome) -> None:
        """Stage one device-computed step's STORE writes: the step's ops
        (+ requeue), then the pass's binds in commit order.  Runs inside
        the segment transaction: store-only, no service/result effects."""
        self._apply_batch(batch)
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

        step_nodes: list = []
        try:
            with TRACE.span(
                "replay.reconcile", segment=driver.segment_seq, steps=len(seg.steps)
            ), self.store.transaction(epoch_exempt=True):
                # epoch_exempt: the segment's own staged writes are the
                # deltas the driver's lower-cache already tracks; only
                # OUT-OF-BAND writes may move the store mutation epoch
                # (and thereby invalidate the cache).  A rollback takes
                # the explicit invalidation path (note_reconcile_fault).
                for batch, outcome in zip(batches, seg.steps):
                    FAULTS.check("replay.reconcile")
                    self._stage_device_step(batch, outcome)
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
    ) -> ScenarioResult:
        """Apply operations grouped by step; one scheduling pass per step
        (every pending pod is attempted each pass, like the upstream
        queue's flush on cluster events).  With ``device_replay`` on,
        supported K-step segments run as single device dispatches (see
        engine/replay.py); everything else takes this per-pass loop.

        A STREAMING source (``ops.streaming_ops``) and ``lane_ops`` (per-
        lane fleet streams) are not ported and raise NotImplementedError."""
        if getattr(ops, "streaming_ops", False):
            raise NotImplementedError(
                "streaming ingest (traces/stream.py) is not ported to ksim_tpu_torch"
            )
        if lane_ops:
            raise NotImplementedError("lane_ops: fleet replay is not ported to ksim_tpu_torch")
        result = ScenarioResult()
        # Per-phase wall-clock split rides on the trace plane's latency
        # histograms; timing-only mode costs two clock reads per span at
        # segment/pass granularity and never touches scheduling state
        # (the behavior locks hold with it on — tests pin that).
        TRACE.ensure_timing()
        phase0 = TRACE.phase_totals()
        t0 = time.perf_counter()
        by_step, keys = self._group_by_step(ops)
        driver = None
        if self._device_replay:
            from ksim_tpu_torch.engine.replay import SEGMENT_STEPS, ReplayDriver

            driver = ReplayDriver(
                self.store,
                self.service,
                k=self._device_segment_steps or SEGMENT_STEPS,
                requeue_on_node_delete=self._requeue,
            )
            self.replay_driver = driver
        i = 0
        while i < len(keys):
            if driver is not None:
                # Tails shorter than K do not fall back: the driver
                # consumes the supported PREFIX of the window (possibly
                # shorter than K for mid-window vocabulary misses) and
                # pads on-device to the segment's K.
                batches = [by_step[s] for s in keys[i : i + driver.k]]
                seg = driver.try_segment(batches)
                if seg is not None and self._commit_segment(
                    keys[i : i + len(seg.steps)],
                    batches[: len(seg.steps)],
                    seg,
                    driver,
                    result,
                ):
                    i += len(seg.steps)
                    continue
            step = keys[i]
            if driver is not None:
                driver.fallback_steps += 1
            done = self._run_step(step, by_step[step], result)
            i += 1
            if done:
                # KEP-140 DoneOperation: "when finish the step
                # DoneOperation belongs, this Scenario changes its status
                # to Succeeded" — later steps are not run.
                result.succeeded = True
                break
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
