"""Device-resident churn replay: K scheduling passes per kernel launch.

The port of ``ksim_tpu/engine/replay.py``, the solo driver.  The per-pass
replay path (scenario/runner.py + scheduler/service.py) runs one
scheduling pass per scenario step, and each pass's placements mutate the
host ClusterStore before the next step's events can apply.  This module
removes that serialization for the common churn vocabulary (pod create /
pod delete / node drain / node replace): a SEGMENT of K scenario steps is
lowered on the host into padded tensor event streams over a pod/node
UNIVERSE (every object alive during the segment, including ones created
mid-segment), and one launch of kernel D (kernels/replay_segment.py,
csrc/replay_segment.cu) runs all K steps — event application, backoff
bookkeeping, queue compaction and the sequential-commit scheduling scan —
with the cluster's tensor state carried on the device.  The host store
stays the source of truth: placements come back once per segment and are
reconciled into the store step by step (scenario/runner.py).

Parity contract (the behavior locks): the device path reproduces the
per-pass path's scheduled/unschedulable counts exactly.  The design
choices that guarantee it are the reference's:

- **Universe row order is queue order.**  Pod rows are pre-sorted by the
  exact ``queue_sort_key`` (priority desc, creationTimestamp, namespace,
  name), so per-step queue compaction keeps the per-pass order.
- **Rank-based selectHost.**  The per-pass tie-break is "lowest node
  index" in the persistent featurizer's slot order, which evolves by
  swap-remove under churn.  The lowering simulates that slot history step
  by step (``_SlotSim``) and ships a per-step rank tensor; the kernel
  selects the max-score feasible node with minimal rank.
- **Integer-space deltas.**  Event application changes only additive
  integer state, so the scoring sees bit-identical inputs.
- **Local accumulators for InterPodAffinity.**  The segment carries
  per-node local term sums and re-derives the domain view each step
  (``derive_interpod``), checked at lowering time against the
  featurizer's own aggregation.

Anything outside the vocabulary makes the lowering raise ``_Unsupported``
and the window's head step falls back to the per-pass path under a named
reason (``FALLBACK_REASONS``).  Beyond the reference's reasons, two
configurations that the reference lowers run per-pass here: record="full"
(``record_full``) and a window that needs DefaultPreemption's victim
search (``preemption``); neither is in kernel D yet.  Also not ported:
the dispatch watchdog and circuit breaker, the speculative prelower, the
AOT executable cache, device-buffer reuse, the tp mesh and fleet lanes.
"""

from __future__ import annotations

import bisect
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from ksim_tpu_torch.engine.core import _Program, _pull_tree_to_host, _to_device, device_aux
from ksim_tpu_torch.errors import ReplayFallback, SimulatorError
from ksim_tpu_torch.faults import FAULTS
from ksim_tpu_torch.kernels.replay_segment import SegmentStatics as _SegmentStatics
from ksim_tpu_torch.kernels.replay_segment import replay_segment
from ksim_tpu_torch.obs import TRACE, register_provider
from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of

logger = logging.getLogger(__name__)

#: Every fallback/discard reason ``ReplayDriver._reject`` can record.
FALLBACK_REASONS: frozenset[str] = frozenset(
    {
        # service/profile configuration outside the vocabulary
        "record_mode", "record_full", "pnts_emulation",
        "featurizer_override", "multi_profile", "no_profile",
        "queue_hooks", "permit_waiters", "plugin_extender",
        # object vocabulary misses
        "scheduling_gates", "foreign_scheduler", "terminal_phase",
        "host_ports", "volumes", "volume_objects", "node_images",
        "create_bound_pod", "bound_to_unknown_node", "inexact_units",
        # stream-shape misses
        "pod_name_reuse", "backoff_name_reuse", "node_name_reuse",
        "delete_unknown_pod", "delete_unknown_node",
        "drain_without_requeue", "duplicate_pod_keys",
        # lowering-time guards
        "interpod_local_mismatch", "preemption",
        # post-dispatch validation discard
        "featurize_prediction",
        # classified faults
        "lowering_fault", "device_error", "reconcile_fault",
    }
)

#: Dynamic reason families (``op:<op>/<kind>``, ``host_hook:<attr>``).
FALLBACK_REASON_PREFIXES: tuple[str, ...] = ("op:", "host_hook:")

# Steps per kernel launch.  The host lowering and reconcile amortize over
# it; 8-32 is the useful range (beyond that the universe grows stale and
# the first fallback forces a re-lower anyway).
SEGMENT_STEPS = int(os.environ.get("KSIM_REPLAY_K", "16"))

_I32_MAX = np.iinfo(np.int32).max


def _backoff_constants() -> tuple[int, int]:
    """(MAX_BACKOFF_PASSES, FLUSH_CAP_PASSES) from the one source of truth,
    the per-pass scheduler (lazy import: scheduler.service imports the
    engine)."""
    from ksim_tpu_torch.scheduler.service import SchedulerService

    return SchedulerService.MAX_BACKOFF_PASSES, SchedulerService.FLUSH_CAP_PASSES


class ReplayParityError(RuntimeError):
    """Device-resident replay state diverged from the host store — a bug
    in the delta application.  Deliberately NOT a SimulatorError: it must
    never be absorbed into a silent per-pass fallback.  The store it fired
    against has been rolled back (the reconcile is one transaction)."""


def _pod_key(pod: JSON) -> str:
    """The SERVICE's pod key scheme (`namespace/name`, namespace
    defaulted): op-created objects may lack metadata.namespace until the
    store defaults it, so every universe/event/backoff key goes through
    this one normalization."""
    return f"{namespace_of(pod) or 'default'}/{name_of(pod)}"


# ---------------------------------------------------------------------------
# Canonical slot simulation (the per-pass featurizer's NodeSlots history)
# ---------------------------------------------------------------------------


class _SlotSim:
    """Name-only replica of boundagg.NodeSlots' swap-remove assignment.

    The per-pass path's node tie-break order is the persistent
    featurizer's slot order, which depends on the entire churn history
    (a delete moves the LAST slot's node into the freed slot).  The
    lowering replays that exact evolution one step ahead of the store to
    produce the per-step rank tensors."""

    def __init__(self, slot_of: dict[str, int] | None = None, names: list[str] | None = None) -> None:
        self.slot_of: dict[str, int] = dict(slot_of or {})
        self.names: list[str] = list(names or [])

    def sync(
        self, current_names: Sequence[str]
    ) -> tuple[list[str], list[tuple[str, int]]]:
        """Mirror NodeSlots.sync for a post-step node-name set, in the
        store's name-sorted list order (what featurize receives).

        Returns ``(removed_names, changed_assignments)`` — the per-step
        delta, so the lowering maintains its rank row incrementally.
        Entries in ``changed_assignments`` apply in order (a name moved
        twice within one sync keeps its last slot)."""
        present = set(current_names)
        removed: list[str] = []
        changed: list[tuple[str, int]] = []
        gone = [s for nm, s in self.slot_of.items() if nm not in present]
        for s in sorted(gone, reverse=True):
            nm = self.names[s]
            last = len(self.names) - 1
            del self.slot_of[nm]
            removed.append(nm)
            if s != last:
                moved = self.names[last]
                self.names[s] = moved
                self.slot_of[moved] = s
                changed.append((moved, s))
            self.names.pop()
        for nm in current_names:
            if nm not in self.slot_of:
                self.slot_of[nm] = len(self.names)
                self.names.append(nm)
                changed.append((nm, len(self.names) - 1))
        return removed, changed


# ---------------------------------------------------------------------------
# Window parse (the store-independent prefix of segment lowering)
# ---------------------------------------------------------------------------


@dataclass
class _StepParse:
    """One step's net object events, window-locally validated."""

    pc: list[str] = field(default_factory=list)  # created pod keys
    pd: list[str] = field(default_factory=list)  # deleted pod keys
    nc: list[str] = field(default_factory=list)  # created node names
    nd: list[str] = field(default_factory=list)  # deleted node names
    flush: bool = False


@dataclass
class _WindowSpec:
    """The store-independent prefix of one window's lowering: event
    parsing, op-vocabulary screening, window-local name bookkeeping and
    created-object support checks.

    Store-membership validation (delete-of-unknown, name reuse against
    live objects, backoff-entry reuse) cannot run here; those checks are
    recorded in op order in ``checks`` and replayed against the live
    store/service sets by ``_lower``.  A window-local vocabulary miss
    stops the parse and lands in ``err_step``/``err_reason``: the
    consumer lowers only the supported prefix, and the erroring step
    heads the next window, which head-rejects it (prefix-granular
    fallback)."""

    sched_names: tuple[str, ...]  # service config the support checks used
    n: int = 0  # op-screen prefix length (steps fully parsed)
    head_reason: str | None = None  # op-vocabulary reject of step 0
    err_step: int = _I32_MAX  # step where a window-local miss stopped parse
    err_reason: str | None = None
    steps: list[_StepParse] = field(default_factory=list)
    # (step, kind, key) store-membership checks, in op order; kind in
    # {"create_pod", "delete_pod", "create_node", "delete_node"}.
    checks: list[tuple[int, str, str]] = field(default_factory=list)
    created_pods: list[tuple[int, str, JSON]] = field(default_factory=list)
    created_nodes: list[tuple[int, JSON]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Persistent lowered-universe cache
# ---------------------------------------------------------------------------


class _LowerCache:
    """Lowered-universe state reused across CONSECUTIVE committed
    segments, making per-segment host lowering O(delta) instead of
    O(universe): the queue-sorted universe (cleaned pod objects + their
    static ``queue_sort_key`` tuples), the priority resolution, and — by
    keeping the surviving objects' IDENTITY stable — every per-pod
    featurizer memo row behind them.

    Valid exactly when nothing touched the store except committed device
    segments, which ``ClusterStore.mutation_epoch`` certifies (segment
    reconciles run in an epoch-exempt transaction).  Any per-pass
    fallback, a segment rollback or an epoch mismatch flushes the whole
    cache; ``verify_segment``'s store-vs-device check anchors the cached
    survivor view to the real store contents."""

    def __init__(self) -> None:
        self.valid = False
        self.epoch = -1
        self.keys: list[str] = []  # queue-sort order
        self.sort_keys: list[tuple] = []  # parallel queue_sort_key tuples
        self.clean_pods: list[JSON] = []  # parallel cleaned pending objects
        self.priority_of = None
        self.prio_gen = 0  # memo token for resolver-dependent per-pod keys
        self.sched_names = None  # profile set the survivors were screened against
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def invalidate(self, reason: str) -> None:
        if not self.valid:
            return
        self.valid = False
        self.invalidations += 1
        self.keys = []
        self.sort_keys = []
        self.clean_pods = []
        self.priority_of = None
        self.sched_names = None
        TRACE.event("replay.cache_invalidate", reason=reason)

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "invalidations": self.invalidations,
        }


# ---------------------------------------------------------------------------
# Lowered trees -> the kernel's tensors
# ---------------------------------------------------------------------------

_NODE_KEYS = ("allocatable", "allowed_pods", "unschedulable")
_POD_KEYS = ("requests", "nonzero_requests", "tolerates_unschedulable", "has_requests")
_EV_KEYS = ("rank", "flush", "active", "pod_create", "pod_delete", "node_create", "node_delete")
_STATE_KEYS = (
    "valid", "requested", "nonzero_requested", "pod_count", "alive", "bound",
    "attempts", "retry_at", "nominated", "spread", "ip_cnt", "ip_eat", "ip_vw",
    "pass_count",
)


def segment_from_arrays(const: dict, ev: dict, state0: dict, *, device="cpu"):
    """The kernel's tensors from a lowered segment's numpy trees:
    ``const`` (``node``, ``pods`` and ``aux``, the featurizer's aux
    families), ``ev`` and ``state0``, as this module's ``_lower`` builds
    them — or as ``ksim_tpu``'s lowering does (duck-typed, never
    imported: its aux dataclasses are matched field by field, and the
    trees' extra preemption keys are left out).  Returns
    ``(const, ev, state0)`` on ``device``, every tensor a fresh copy."""
    from ksim_tpu_torch.state.featurizer import _aux_from_arrays

    dev = torch.device(device)
    n_padded = int(np.asarray(const["node"]["allocatable"]).shape[0])
    const_t = {
        "node": {k: _to_device(np.asarray(const["node"][k]), dev) for k in _NODE_KEYS},
        "pods": {k: _to_device(np.asarray(const["pods"][k]), dev) for k in _POD_KEYS},
        "aux": device_aux(_aux_from_arrays(const["aux"]), n_padded, dev),
    }
    ev_t = {k: _to_device(np.asarray(ev[k]), dev) for k in _EV_KEYS}
    state_t = {k: _to_device(np.asarray(state0[k]), dev) for k in _STATE_KEYS}
    return const_t, ev_t, state_t


# ---------------------------------------------------------------------------
# Host driver: segment lowering, dispatch, reconcile
# ---------------------------------------------------------------------------


@dataclass
class StepOutcome:
    """One device-computed scheduling pass, ready for store reconcile."""

    scheduled: int
    unschedulable: int
    pending_after: int
    eligible: int  # queue size before the cap (0 = the pass never featurized)
    # (namespace, name, node_name) in queue (commit) order.
    binds: list[tuple[str, str, str]] = field(default_factory=list)


@dataclass
class SegmentOutcome:
    steps: list[StepOutcome]
    pass_count: int
    # namespace/name -> (attempts, retry_at) for the service backoff sync.
    backoff: dict[str, tuple[int, int]]
    # Device end-of-segment views for the store parity check.
    bound_view: dict[str, str]  # pod key -> node name
    pending_view: set[str]  # pod keys


def _cleaned_pending(pod: JSON) -> JSON:
    """The pod as the per-pass path would featurize it when PENDING
    (node-drain requeue shape: spec.nodeName and status.phase cleared) —
    identity-cached per source object so the featurizer's per-pod memo
    rows survive across segments."""
    from ksim_tpu_torch.state import objcache

    def build() -> JSON:
        spec = dict(pod.get("spec") or {})
        spec.pop("nodeName", None)
        status = dict(pod.get("status") or {})
        status.pop("phase", None)
        return dict(pod, spec=spec, status=status)

    if not pod.get("spec", {}).get("nodeName") and not pod.get("status", {}).get(
        "phase"
    ):
        return pod
    return objcache.cached("replay_clean", pod, build)


@dataclass
class _SegmentPlan:
    statics: _SegmentStatics
    prog: Any
    const: dict  # node / pods / aux (the featurizer's aux dataclasses)
    ev: dict
    state0: dict
    universe_keys: list[str]
    universe_row_of: dict[str, int]
    node_names: list[str]
    n_steps: int  # REAL steps (the segment's K may be tail-padded longer)
    pred_featurizes: list[bool]
    initial_pass_count: int
    step_node_event: list = field(default_factory=list)
    # Lower-cache seed (ReplayDriver._advance_cache filters it to the
    # committed segment's survivors) + the store epoch the lowering read.
    lower_epoch: int = -1
    sort_keys: list = field(default_factory=list)
    clean_pods: list = field(default_factory=list)
    priority_of: Any = None
    prio_gen: int = 0
    sched_names: Any = None  # profile set the lowering screened against


class _Unsupported(ReplayFallback):
    """Lowering found an op/object outside the tensor vocabulary (str(e)
    is the histogram reason)."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)


class ReplayDriver:
    """Segment-batched device replay over a ClusterStore + SchedulerService.

    One instance per ScenarioRunner run.  ``try_segment`` lowers up to K
    steps against the CURRENT store state and runs them in one launch;
    ``None`` means the segment's head step is outside the supported
    vocabulary and the caller falls back to the per-pass path for it.
    The kernel runs on the service's device (CUDA, or the plain version
    on the CPU)."""

    def __init__(
        self,
        store,
        service,
        *,
        k: int = SEGMENT_STEPS,
        requeue_on_node_delete: bool = True,
    ) -> None:
        self.store = store
        self.service = service
        self.k = max(int(k), 1)
        # The segment program bakes the runner's drain-requeue semantics
        # in; a no-requeue runner takes the per-pass path for any segment
        # containing node deletes.
        self._requeue = requeue_on_node_delete
        self._featurizer = None  # persistent lowering featurizer
        self._sched_name: str | None = None
        # Evidence counters.
        self.device_steps = 0
        self.fallback_steps = 0
        self.device_round_trips = 0
        self.device_errors = 0
        self.unsupported: dict[str, int] = {}
        # Kernel time of the dispatches on a CUDA device (CUDA events),
        # milliseconds; stays 0.0 on the CPU.
        self.kernel_ms = 0.0
        self._segment_seq = 0
        self._cache = _LowerCache()
        self._last_plan: "_SegmentPlan | None" = None
        self._prio_gen = 0
        import weakref

        ref = weakref.ref(self)

        def _stats() -> dict:
            drv = ref()
            return drv.stats() if drv is not None else {"collected": True}

        register_provider("replay", _stats)

    @property
    def segment_seq(self) -> int:
        """Segments lowered so far (the trace-correlation counter)."""
        return self._segment_seq

    def stats(self) -> dict:
        feat = self._featurizer
        return {
            "device_steps": self.device_steps,
            "fallback_steps": self.fallback_steps,
            "device_round_trips": self.device_round_trips,
            "device_errors": self.device_errors,
            "kernel_ms": self.kernel_ms,
            "unsupported": dict(self.unsupported),
            "lower_cache": self._cache.stats(),
            "featurize_calls": feat.pod_rows_built if feat is not None else 0,
            "featurize_reused": feat.pod_rows_reused if feat is not None else 0,
            "featurize_passes": feat.featurize_passes if feat is not None else 0,
        }

    # -- support checks ------------------------------------------------------

    def _reject(self, reason: str) -> None:
        self.unsupported[reason] = self.unsupported.get(reason, 0) + 1
        TRACE.event("replay.fallback", reason=reason, segment=self._segment_seq)

    def service_supported(self) -> bool:
        svc = self.service
        if svc._record not in ("selection", "full"):
            self._reject("record_mode")
            return False
        if svc._record == "full":
            # The streamed per-attempt records are not in kernel D yet.
            self._reject("record_full")
            return False
        if svc._pnts_emulation:
            self._reject("pnts_emulation")
            return False
        if svc._featurizer_override is not None:
            self._reject("featurizer_override")
            return False
        names = svc._scheduler_names
        if len(names) != 1:
            self._reject("multi_profile")
            return False
        prof = None
        if svc._plugins_factory is None:
            prof = svc._profiles.get(names[0])
            if prof is None:
                self._reject("no_profile")
                return False
            if prof.pre_enqueue_hooks or prof.queue_sort_plugin is not None:
                self._reject("queue_hooks")
                return False
        if svc._waiting:
            self._reject("permit_waiters")
            return False
        self._sched_name = names[0]
        preempt = bool(svc._preemption)
        if preempt and prof is not None and "DefaultPreemption" in prof.postfilter_disabled:
            preempt = False
        self._preempt_active = preempt
        return True

    _OP_KINDS = frozenset({"pods", "nodes"})

    def _parse_window(self, batches: list[list[Any]]) -> _WindowSpec:
        """The store-independent lowering prefix for up to one window of
        batches: op-vocabulary screening, per-step net object events
        (same-step create+delete cancels), window-local name
        bookkeeping, and support checks on CREATED objects.  Vocabulary
        misses never propagate: they stop the parse and land in the
        spec's ``head_reason`` / ``err_step``+``err_reason`` fields for
        the consumer to raise (or ignore, when its clamped window ends
        before the erroring step)."""
        spec = _WindowSpec(sched_names=self.service._scheduler_names)
        # (The op screen below is also run — head batch only, pre-span —
        # by _batch_ops_ok; keep the two in sync.)
        win_pod_seen: set[str] = set()  # keys ever used by window creates
        win_pod_live: set[str] = set()  # window-created keys still alive
        ext_del_pods: set[str] = set()  # pre-window keys deleted in-window
        win_node_seen: set[str] = set()
        win_node_live: set[str] = set()
        ext_del_nodes: set[str] = set()
        try:
            for k, batch in enumerate(batches):
                for op in batch:
                    if op.kind not in self._OP_KINDS or op.op not in (
                        "create",
                        "delete",
                    ):
                        if k == 0:
                            spec.head_reason = f"op:{op.op}/{op.kind}"
                        return spec  # op-screen prefix ends here
                st = _StepParse(
                    flush=any(
                        op.kind == "nodes"
                        or (op.op == "delete" and op.kind == "pods")
                        for op in batch
                    )
                )
                for op in batch:
                    if op.kind == "pods":
                        if op.op == "create":
                            key = _pod_key(op.obj)
                            if key in win_pod_seen or key in ext_del_pods:
                                raise _Unsupported("pod_name_reuse")
                            # Against the live store + the service's
                            # backoff table: deferred (_lower).
                            spec.checks.append((k, "create_pod", key))
                            if op.obj.get("spec", {}).get("nodeName") or op.obj.get(
                                "status", {}
                            ).get("phase"):
                                raise _Unsupported("create_bound_pod")
                            reason = self._pod_supported(op.obj, spec.sched_names)
                            if reason is not None:
                                raise _Unsupported(reason)
                            win_pod_seen.add(key)
                            win_pod_live.add(key)
                            st.pc.append(key)
                            spec.created_pods.append((k, key, op.obj))
                        else:
                            key = f"{op.namespace or 'default'}/{op.name}"
                            if key in win_pod_live:
                                if key in st.pc:
                                    st.pc.remove(key)  # same-step net no-op
                                else:
                                    st.pd.append(key)
                                win_pod_live.discard(key)
                            elif key in win_pod_seen or key in ext_del_pods:
                                # Window-locally provable double delete.
                                raise _Unsupported("delete_unknown_pod")
                            else:
                                # Must exist in the store: deferred.
                                spec.checks.append((k, "delete_pod", key))
                                ext_del_pods.add(key)
                                st.pd.append(key)
                    else:  # nodes
                        if op.op == "create":
                            nm = name_of(op.obj)
                            if nm in win_node_seen or nm in ext_del_nodes:
                                raise _Unsupported("node_name_reuse")
                            spec.checks.append((k, "create_node", nm))
                            if op.obj.get("status", {}).get("images"):
                                raise _Unsupported("node_images")
                            win_node_seen.add(nm)
                            win_node_live.add(nm)
                            st.nc.append(nm)
                            spec.created_nodes.append((k, op.obj))
                        else:
                            if not self._requeue:
                                raise _Unsupported("drain_without_requeue")
                            nm = op.name
                            if nm in win_node_live:
                                if nm in st.nc:
                                    st.nc.remove(nm)
                                else:
                                    st.nd.append(nm)
                                win_node_live.discard(nm)
                            elif nm in win_node_seen or nm in ext_del_nodes:
                                raise _Unsupported("delete_unknown_node")
                            else:
                                spec.checks.append((k, "delete_node", nm))
                                ext_del_nodes.add(nm)
                                st.nd.append(nm)
                spec.steps.append(st)
                spec.n = len(spec.steps)
        except _Unsupported as e:
            spec.err_step = len(spec.steps)
            spec.err_reason = str(e)
        return spec

    def _batch_ops_ok(self, batch: Sequence[Any], record: bool) -> bool:
        """Cheap op-vocabulary screen for ONE step's batch (no store
        access).  ``record`` counts the reject reason — only the batch
        that actually forces a fallback (the segment head) should."""
        for op in batch:
            if op.kind not in self._OP_KINDS or op.op not in ("create", "delete"):
                if record:
                    self._reject(f"op:{op.op}/{op.kind}")
                return False
        return True

    @staticmethod
    def _pod_supported(pod: JSON, sched_names: tuple[str, ...]) -> str | None:
        """None when the pod fits the tensor vocabulary, else the reason."""
        from ksim_tpu_torch.scheduler.profile import DEFAULT_SCHEDULER_NAME
        from ksim_tpu_torch.state.extras import _host_ports
        from ksim_tpu_torch.state.volumes import _pod_has_volumes

        spec = pod.get("spec", {})
        if spec.get("schedulingGates"):
            return "scheduling_gates"
        name = spec.get("schedulerName") or DEFAULT_SCHEDULER_NAME
        if name not in sched_names:
            return "foreign_scheduler"
        if pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            return "terminal_phase"
        if _host_ports(pod):
            return "host_ports"
        if _pod_has_volumes(pod):
            return "volumes"
        return None

    # -- lowering ------------------------------------------------------------

    def try_segment(self, batches: list[list[Any]]):
        """Lower + run up to one window of steps; returns a SegmentOutcome
        (whose ``steps`` may be SHORTER than the window: the supported
        prefix, tail-padded on the device to K) or None (the FIRST step
        is unsupported — the caller falls back for it).  Must be called
        BEFORE the steps' ops touch the store.

        Failure taxonomy (classified, never a bare catch-all):

        - ``ReplayFallback`` (vocabulary misses, validation discards) ->
          per-pass fallback under its stable reason;
        - any other ``SimulatorError`` during lowering -> fallback as
          ``lowering_fault``; during the dispatch (an injected fault) ->
          ``device_error``;
        - everything else — a kernel that fails to build or launch, a
          TypeError — RE-RAISES: silent fallback must never mask a bug.

        Any None return strictly invalidates the lowered-universe cache:
        the per-pass path is about to mutate store and service state the
        incremental bookkeeping cannot track."""
        plan = self.prepare_segment(batches)
        out = self.dispatch_segment(plan) if plan is not None else None
        if out is None:
            self._cache.invalidate("fallback")
            self._last_plan = None
        return out

    def prepare_segment(self, batches: list[list[Any]]) -> "_SegmentPlan | None":
        """The lowering half of ``try_segment``: support / op screens plus
        the classified lowering taxonomy, ending in a dispatch-ready
        ``_SegmentPlan`` or None with the reason recorded."""
        if not self.service_supported():
            return None
        # Pre-span head screen: a window whose FIRST step is outside the
        # op vocabulary never lowers (no replay.lower span, no fault slot).
        if not batches or not self._batch_ops_ok(batches[0], record=True):
            return None
        self._segment_seq += 1
        try:
            with TRACE.span(
                "replay.lower", segment=self._segment_seq, steps=min(len(batches), self.k)
            ) as sp:
                FAULTS.check("replay.lower")
                spec = self._parse_window(batches[: self.k])
                m = min(spec.n, self.k)
                if m == 0:
                    raise _Unsupported(spec.head_reason or spec.err_reason)
                sp.set(steps=m)
                return self._lower(list(batches[:m]), spec)
        except ReplayFallback as e:
            self._reject(str(e))
            return None
        except SimulatorError as e:
            logger.warning(
                "segment lowering failed (%s: %s); falling back per-pass",
                type(e).__name__, e,
            )
            self._reject("lowering_fault")
            return None

    def dispatch_segment(self, plan: "_SegmentPlan"):
        """The dispatch half of ``try_segment``: the kernel launch, the
        pull of its outputs and their decode.  Returns the SegmentOutcome
        or None (reason recorded)."""
        try:
            with TRACE.span("replay.dispatch", segment=self._segment_seq, steps=plan.n_steps):
                res = self._run(plan)
        except ReplayFallback as e:
            self._reject(str(e))
            return None
        except SimulatorError as e:
            self.device_errors += 1
            logger.warning("segment dispatch failed (%s: %s); falling back per-pass", type(e).__name__, e)
            self._reject("device_error")
            return None
        self.device_round_trips += 1
        if isinstance(res, str):
            # Post-dispatch validation discard: store untouched, fall back.
            self._reject(res)
            return None
        # device_steps is counted by the caller once the segment COMMITS.
        self._last_plan = plan
        return res

    def _service_featurizer(self):
        """The canonical per-pass featurizer (created exactly as the
        service would, so a later fallback pass sees the same instance
        and the same NodeSlots history)."""
        svc = self.service
        name = self._sched_name
        feat = svc._featurizers.get(name)
        if feat is None:
            from ksim_tpu_torch.state.featurizer import Featurizer

            if svc._plugins_factory is not None:
                feat = Featurizer(pod_bucket_min=svc._pod_bucket_min)
            else:
                feat = svc._profiles[name].featurizer(pod_bucket_min=svc._pod_bucket_min)
            svc._featurizers[name] = feat
        return feat

    def _lower(self, batches: list[list[Any]], spec: _WindowSpec) -> "_SegmentPlan":
        from ksim_tpu_torch.scheduler.service import queue_sort_key
        from ksim_tpu_torch.state.featurizer import bucket_size, vocab_pad
        from ksim_tpu_torch.state.priorities import build_priority_resolver

        svc = self.service
        store = self.store
        for kind in ("persistentvolumes", "persistentvolumeclaims", "storageclasses"):
            if store.list(kind, copy_objs=False):
                raise _Unsupported("volume_objects")

        m_steps = len(batches)
        lower_epoch = store.mutation_epoch
        cur_pods = store.list("pods", copy_objs=False)
        cur_nodes = store.list("nodes", copy_objs=False)
        node_names = {name_of(n) for n in cur_nodes}
        sched_names = svc._scheduler_names
        cache = self._cache
        use_cache = (
            cache.valid
            and cache.epoch == lower_epoch
            and cache.sched_names == sched_names
        )
        if cache.valid and not use_cache:
            # An out-of-band store write moved the mutation epoch, or a
            # scheduler reconfiguration changed the profile set the
            # cached survivors were screened against: strict flush.
            cache.invalidate(
                "epoch_mismatch" if cache.epoch != lower_epoch else "sched_config"
            )

        # Store-dependent half of the window validation: the parse's
        # deferred membership checks against the live store and the
        # service backoff table, in recorded op order.
        with svc._backoff_lock:
            backoff_keys = set(svc._backoff)
        for stp, check, key in spec.checks:
            if stp >= m_steps:
                break
            if check == "create_pod":
                ns, _, nm = key.partition("/")
                if store.contains("pods", nm, ns):
                    raise _Unsupported("pod_name_reuse")
                if key in backoff_keys:
                    # A stale backoff entry for a DEAD same-name pod: the
                    # per-pass path would let the new pod inherit it
                    # (_in_backoff is key-based), which a fresh universe
                    # row cannot model.
                    raise _Unsupported("backoff_name_reuse")
            elif check == "delete_pod":
                ns, _, nm = key.partition("/")
                if not store.contains("pods", nm, ns):
                    raise _Unsupported("delete_unknown_pod")
            elif check == "create_node":
                if key in node_names:
                    raise _Unsupported("node_name_reuse")
            else:  # delete_node
                if key not in node_names:
                    raise _Unsupported("delete_unknown_node")
        # A parse error can only sit AT or PAST the lowered prefix's end:
        # the erroring step heads the NEXT window, which head-rejects it.
        assert spec.err_step >= m_steps, spec.err_reason

        steps = spec.steps[:m_steps]
        step_pod_creates = [list(s.pc) for s in steps]
        step_pod_deletes = [list(s.pd) for s in steps]
        step_node_creates = [list(s.nc) for s in steps]
        step_node_deletes = [list(s.nd) for s in steps]
        step_flush = [s.flush for s in steps]
        created_pod_entries = [e for e in spec.created_pods if e[0] < m_steps]
        created_nodes = [obj for stp, obj in spec.created_nodes if stp < m_steps]

        # Tail padding: segments shorter than K extend with inactive no-op
        # steps.
        k_pad = self.k
        step_active = [True] * m_steps + [False] * (k_pad - m_steps)
        for _ in range(k_pad - m_steps):
            step_pod_creates.append([])
            step_pod_deletes.append([])
            step_node_creates.append([])
            step_node_deletes.append([])
            step_flush.append(False)

        # Universe pods, globally sorted by the exact per-pass queue key
        # (static per pod), so slot order IS queue order every step.  On
        # a cache hit survivors keep their cached order and sort keys (the
        # key is total over distinct pod keys, so a bisect merge of the
        # window's creates equals a full sort); only created objects
        # compute keys.  The universe holds the CLEANED PENDING objects:
        # equal to the store's in every lowered field, and identity-stable
        # across segments, which keeps the per-pod featurizer memo rows.
        if use_cache:
            cache.hits += 1
            priority_of = cache.priority_of
            prio_gen = cache.prio_gen
            uni_keys = list(cache.keys)
            uni_sort = list(cache.sort_keys)
            uni_clean = list(cache.clean_pods)
        else:
            cache.misses += 1
            priority_of = build_priority_resolver(
                store.list("priorityclasses", copy_objs=False)
            )
            self._prio_gen += 1
            prio_gen = self._prio_gen
            for p in cur_pods:
                reason = self._pod_supported(p, sched_names)
                if reason is not None:
                    raise _Unsupported(reason)
            for n in cur_nodes:
                if n.get("status", {}).get("images"):
                    raise _Unsupported("node_images")
            decorated = sorted(
                (queue_sort_key(p, priority_of), _pod_key(p), _cleaned_pending(p))
                for p in cur_pods
            )
            uni_sort = [d[0] for d in decorated]
            uni_keys = [d[1] for d in decorated]
            uni_clean = [d[2] for d in decorated]
        for _stp, key, obj in created_pod_entries:
            sk = queue_sort_key(obj, priority_of)
            j = bisect.bisect_left(uni_sort, sk)
            uni_sort.insert(j, sk)
            uni_keys.insert(j, key)
            uni_clean.insert(j, obj)

        universe_pods = uni_clean
        universe_keys = uni_keys
        row_of = {k: j for j, k in enumerate(universe_keys)}
        if len(row_of) != len(universe_pods):
            raise _Unsupported("duplicate_pod_keys")

        # DefaultPreemption's victim search is not in kernel D.  A
        # PRIORITY-FLAT selection window can never enter it (a candidate
        # node needs a bound pod of strictly lower priority, and no pod
        # holds a nomination), so such a window lowers preempt-free, as in
        # the reference; any other window with preemption on runs
        # per-pass.
        if self._preempt_active:
            prios = [priority_of(p) for p in universe_pods]
            flat = not any(
                p.get("status", {}).get("nominatedNodeName") for p in cur_pods
            ) and (not prios or prios.count(prios[0]) == len(prios))
            if not flat:
                raise _Unsupported("preemption")

        # Featurize the universe once (persistent featurizer: per-pod rows
        # memoize, bound aggregates update by delta).
        if self._featurizer is None:
            if svc._plugins_factory is not None:
                from ksim_tpu_torch.state.featurizer import Featurizer

                self._featurizer = Featurizer()
            else:
                self._featurizer = svc._profiles[self._sched_name].featurizer()
        universe_nodes = list(cur_nodes) + created_nodes
        bound_pods = store.pods_with_node()
        feats = self._featurizer.featurize(
            universe_nodes,
            (),
            queue_pods=universe_pods,
            bound_pods=bound_pods,
            namespaces=store.list("namespaces", copy_objs=False),
        )
        if not feats.exact:
            raise _Unsupported("inexact_units")
        slot_of = dict(self._featurizer._slots.slot_of)

        factory = (
            svc._plugins_factory
            if svc._plugins_factory is not None
            else svc._profiles[self._sched_name].plugins
        )
        plugins = tuple(factory(feats))
        for sp in plugins:
            if sp.extender is not None:
                raise _Unsupported("plugin_extender")
            for attr in (
                "reserve", "unreserve", "permit", "pre_bind", "bind", "post_bind", "post_filter",
            ):
                if hasattr(sp.plugin, attr):
                    raise _Unsupported(f"host_hook:{attr}")
        prog = _Program(plugins, "selection", svc._exact)

        N = feats.nodes.padded
        P = feats.pods.requests.shape[0]
        K = k_pad
        ipa = feats.aux["interpod"]
        spread = feats.aux["spread"]

        # Initial dynamic state.
        valid0 = np.zeros(N, bool)
        for n in cur_nodes:
            valid0[slot_of[name_of(n)]] = True
        alive0 = np.zeros(P, bool)
        bound0 = np.full(P, -1, np.int32)
        cur_keys = {_pod_key(p) for p in cur_pods}
        for p in cur_pods:
            j = row_of[_pod_key(p)]
            alive0[j] = True
            nn = p.get("spec", {}).get("nodeName")
            if nn:
                ns = slot_of.get(nn)
                if ns is None:
                    raise _Unsupported("bound_to_unknown_node")
                bound0[j] = ns
        attempts0 = np.zeros(P, np.int32)
        retry0 = np.zeros(P, np.int32)
        for key, (a, r) in svc._backoff.items():
            j = row_of.get(key)
            if j is not None and key in cur_keys:
                attempts0[j] = a
                retry0[j] = r

        # Inter-pod local per-node accumulators from the bound population
        # (the linear pre-aggregation the segment re-derives each step).
        T = ipa.pod_term_match.shape[1]
        ip_cnt0 = np.zeros((N, T), np.int32)
        ip_eat0 = np.zeros((N, T), np.int32)
        ip_vw0 = np.zeros((N, T), np.int32)
        b_rows = [row_of[_pod_key(p)] for p in bound_pods]
        b_slots = [int(bound0[j]) for j in b_rows]
        if b_rows:
            rows = np.asarray(b_rows)
            slots = np.asarray(b_slots)
            np.add.at(ip_cnt0, slots, ipa.pod_term_match[rows].astype(np.int32))
            np.add.at(ip_eat0, slots, ipa.pod_eat[rows])
            np.add.at(ip_vw0, slots, ipa.pod_vw[rows])
        n_dom_pad = vocab_pad(int(ipa.n_domains) + 1)
        if not self._check_interpod_locals(ipa, ip_cnt0, ip_eat0, ip_vw0, n_dom_pad):
            raise _Unsupported("interpod_local_mismatch")

        # Per-step event index tensors (-1 padded) + canonical ranks.
        # Widths bucket like every other axis.
        def pad(lists: list[list[int]]) -> np.ndarray:
            width = vocab_pad(max((len(x) for x in lists), default=1))
            out = np.full((K, width), -1, np.int32)
            for k, xs in enumerate(lists):
                out[k, : len(xs)] = xs
            return out

        pod_create = pad([[row_of[k] for k in xs] for xs in step_pod_creates])
        pod_delete = pad([[row_of[k] for k in xs] for xs in step_pod_deletes])
        node_create = pad([[slot_of[n] for n in xs] for xs in step_node_creates])
        node_delete = pad([[slot_of[n] for n in xs] for xs in step_node_deletes])

        # The canonical featurizer advances its slot assignment ONLY on
        # passes that featurize — an empty eligible queue skips the sync.
        # Queue emptiness depends on scheduling outcomes, so the lowering
        # PREDICTS it (a step with pod creates always has an eligible
        # queue: fresh pods carry no backoff) and the decode validates the
        # prediction against the device-computed eligible counts,
        # discarding the segment on a mismatch that matters.
        pred_featurizes = [len(xs) > 0 for xs in step_pod_creates]
        sim_feat = self._service_featurizer()
        # No getattr default: if NodeSlots' internals change shape this
        # must fail loudly — a silently empty seed would give wrong ranks.
        sim = _SlotSim(sim_feat._slots.slot_of, sim_feat._slots._names)
        ranks = np.full((K, N), _I32_MAX, np.int32)
        step_node_event = [
            bool(step_node_creates[k] or step_node_deletes[k]) for k in range(K)
        ]
        # Rank rows are maintained incrementally: each sync applies only
        # the slots it changed, and the sorted live-name list evolves by
        # bisect insert/remove.
        rank_row = np.full(N, _I32_MAX, np.int32)
        for nm, slot in sim.slot_of.items():
            # .get: a dead node's name can linger in the service
            # featurizer's slot map (an empty-queue pass skips the sync);
            # it has no universe slot and the kernel never reads its rank.
            j = slot_of.get(nm)
            if j is not None:
                rank_row[j] = slot
        live_sorted: list[str] = sorted(node_names)
        for k in range(K):
            for nm in step_node_deletes[k]:
                live_sorted.pop(bisect.bisect_left(live_sorted, nm))
            for nm in step_node_creates[k]:
                live_sorted.insert(bisect.bisect_left(live_sorted, nm), nm)
            if pred_featurizes[k]:
                removed, changed = sim.sync(live_sorted)
                for nm in removed:
                    j = slot_of.get(nm)
                    if j is not None:
                        rank_row[j] = _I32_MAX
                for nm, slot in changed:
                    rank_row[slot_of[nm]] = slot
            ranks[k] = rank_row

        # Queue width: pending(now) + creates + requeue-able bounds the
        # pending population at any step (overflow-free by construction).
        pending_now = int(np.sum(alive0 & (bound0 < 0)))
        drained = set().union(*step_node_deletes) if step_node_deletes else set()
        drained_bound = sum(
            1 for p in bound_pods if p.get("spec", {}).get("nodeName") in drained
        )
        hard_bound = pending_now + sum(len(x) for x in step_pod_creates) + drained_bound
        cap = svc._max_pods_per_pass or (1 << 30)
        q = bucket_size(max(min(cap, hard_bound), 1))

        max_backoff, flush_cap = _backoff_constants()
        statics = _SegmentStatics(
            k=K,
            q=q,
            cap=cap,
            n_tk=ipa.node_dom.shape[1],
            n_dom=n_dom_pad,
            max_backoff=max_backoff,
            flush_cap=flush_cap,
        )
        const = {
            "node": dict(
                allocatable=feats.nodes.allocatable,
                allowed_pods=feats.nodes.allowed_pods,
                unschedulable=feats.nodes.unschedulable,
            ),
            "pods": dict(
                requests=feats.pods.requests,
                nonzero_requests=feats.pods.nonzero_requests,
                tolerates_unschedulable=feats.pods.tolerates_unschedulable,
                has_requests=feats.pods.has_requests,
            ),
            "aux": feats.aux,
        }
        ev = {
            "rank": ranks,
            "flush": np.asarray(step_flush, bool),
            "active": np.asarray(step_active, bool),
            "pod_create": pod_create,
            "pod_delete": pod_delete,
            "node_create": node_create,
            "node_delete": node_delete,
        }
        nominated0 = np.zeros(P, bool)
        for p in cur_pods:
            if p.get("status", {}).get("nominatedNodeName"):
                nominated0[row_of[_pod_key(p)]] = True
        state0 = {
            "valid": valid0,
            "requested": feats.nodes.requested,
            "nonzero_requested": feats.nodes.nonzero_requested,
            "pod_count": feats.nodes.pod_count,
            "alive": alive0,
            "bound": bound0,
            "attempts": attempts0,
            "retry_at": retry0,
            "nominated": nominated0,
            "spread": spread.init_counts,
            "ip_cnt": ip_cnt0,
            "ip_eat": ip_eat0,
            "ip_vw": ip_vw0,
            "pass_count": np.asarray(svc._pass_count, np.int32),
        }
        return _SegmentPlan(
            statics=statics,
            prog=prog,
            const=const,
            ev=ev,
            state0=state0,
            universe_keys=universe_keys,
            universe_row_of=row_of,
            node_names=list(feats.nodes.names),
            n_steps=m_steps,
            pred_featurizes=pred_featurizes,
            initial_pass_count=int(svc._pass_count),
            step_node_event=step_node_event,
            lower_epoch=lower_epoch,
            sort_keys=uni_sort,
            clean_pods=uni_clean,
            priority_of=priority_of,
            prio_gen=prio_gen,
            sched_names=sched_names,
        )

    @staticmethod
    def _check_interpod_locals(ipa, cnt, eat, vw, n_dom_pad: int) -> bool:
        """Verify the local accumulators re-derive the featurizer's own
        domain-aggregated carry init (numpy mirror of derive_interpod) —
        the lowering-time guard against delta/aggregation skew."""
        node_dom = ipa.node_dom  # [N, TK]
        term_tk = ipa.term_tk  # [T]
        dom_t = ipa.dom_t
        expect = {"cnt": ipa.cnt_node, "ecnt": ipa.ecnt_node, "ew": ipa.ew_node}
        got = {}
        for name, arr in (("cnt", cnt), ("ecnt", eat), ("ew", vw)):
            acc = np.zeros_like(arr)
            for k in range(node_dom.shape[1]):
                ids = node_dom[:, k]
                safe = np.where(ids >= 0, ids, n_dom_pad)
                seg = np.zeros((n_dom_pad + 1, arr.shape[1]), arr.dtype)
                np.add.at(seg, safe, arr)
                derived = np.where(ids[:, None] >= 0, seg[safe], 0)
                acc = np.where((term_tk == k)[None, :], derived, acc)
            got[name] = acc
        total = np.sum(np.where(dom_t >= 0, cnt, 0), axis=0, dtype=np.int64)
        ok = all(np.array_equal(got[k], expect[k]) for k in expect) and np.array_equal(
            total.astype(np.int32), ipa.total
        )
        if not ok:
            logger.warning(
                "device replay: inter-pod local accumulators disagree with "
                "the featurizer's aggregation; falling back to per-pass"
            )
        return ok

    # -- dispatch + decode ---------------------------------------------------

    def _run(self, plan: "_SegmentPlan") -> "SegmentOutcome | str":
        """Launch the lowered segment and decode its outputs: the
        SegmentOutcome, or a DISCARD REASON string when post-dispatch
        validation rejects the results (store untouched either way)."""
        FAULTS.check("replay.dispatch")
        device = self.service._device
        const, ev, state0 = segment_from_arrays(plan.const, plan.ev, plan.state0, device=device)
        timed = device.type == "cuda"
        if timed:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        final, outs = replay_segment(plan.statics, plan.prog, const, ev, state0)
        if timed:
            t1.record()
        pulled_state = _pull_tree_to_host(
            {k: final[k] for k in ("alive", "bound", "attempts", "retry_at", "pass_count")}
        )
        pulled = _pull_tree_to_host(outs)
        if timed:
            self.kernel_ms += t0.elapsed_time(t1)
        return self._decode_outputs(plan, pulled_state, pulled)

    def _decode_outputs(self, plan: "_SegmentPlan", pulled_state, pulled) -> "SegmentOutcome | str":
        """The host half of a dispatch: validate the featurize prediction
        and decode the pulled tensors into a SegmentOutcome (or a
        discard-reason string)."""
        eligible = np.asarray(pulled["eligible"])
        for k in range(plan.n_steps):
            if bool(eligible[k] > 0) != plan.pred_featurizes[k]:
                # The sync-schedule prediction missed (a create-free step
                # still had eligible pods, or every eligible pod vanished).
                # That matters only when the divergent sync schedules can
                # see DIFFERENT node sets: the slot sim is a pure function
                # of the live-node sequence, and a sync over an unchanged
                # set is a no-op.  If no node event happened after the
                # last predicted sync, every later sync in either schedule
                # is a no-op and the shipped rank tensors are identical —
                # the window stays.  With a node event past that sync the
                # ranks may assume the wrong slot history: discard (the
                # store is untouched) and fall back.
                last_sync = max(
                    (j for j in range(k) if plan.pred_featurizes[j]), default=-1
                )
                if any(plan.step_node_event[last_sync + 1 : plan.n_steps]):
                    return "featurize_prediction"
                break

        sel = np.asarray(pulled["sel"])  # [K, Q]
        idx = np.asarray(pulled["idx"])  # [K, Q]
        P = len(plan.universe_keys)
        steps: list[StepOutcome] = []
        for k in range(plan.n_steps):
            binds = []
            for qq in np.nonzero((idx[k] < P) & (sel[k] >= 0))[0]:
                key = plan.universe_keys[int(idx[k, qq])]
                ns, _, nm = key.partition("/")
                binds.append((ns, nm, plan.node_names[int(sel[k, qq])]))
            steps.append(
                StepOutcome(
                    scheduled=int(pulled["scheduled"][k]),
                    unschedulable=int(pulled["unschedulable"][k]),
                    pending_after=int(pulled["pending_after"][k]),
                    eligible=int(eligible[k]),
                    binds=binds,
                )
            )
        alive = np.asarray(pulled_state["alive"])[:P]
        bound = np.asarray(pulled_state["bound"])[:P]
        attempts = np.asarray(pulled_state["attempts"])[:P]
        retry = np.asarray(pulled_state["retry_at"])[:P]
        # Per-pass keeps DEAD pods' backoff entries too (until its
        # shedding valve prunes them), so export every universe row's
        # entry — device flushes already updated the dead ones — and fold
        # in pre-segment entries for keys outside the universe, applying
        # the flush cap the per-pass path would have (one min against the
        # FIRST flush step's pre-pass count is exactly the running minimum
        # over all of them).
        backoff = {
            plan.universe_keys[j]: (int(attempts[j]), int(retry[j]))
            for j in np.nonzero(attempts > 0)[0]
        }
        pcs = np.asarray(pulled["pass_count"]).reshape(-1)
        _max_backoff, flush_cap = _backoff_constants()
        flush = np.asarray(plan.ev["flush"])
        first_flush_pc = None
        for k in range(plan.n_steps):
            if bool(flush[k]):
                first_flush_pc = int(pcs[k - 1]) if k else plan.initial_pass_count
                break
        with self.service._backoff_lock:
            svc_backoff = dict(self.service._backoff)
        for key, (a, r) in svc_backoff.items():
            if key in backoff or key in plan.universe_row_of:
                continue
            if first_flush_pc is not None:
                r = min(r, first_flush_pc + min(a - 1, flush_cap))
            backoff[key] = (a, r)
        bound_view = {
            plan.universe_keys[j]: plan.node_names[int(bound[j])]
            for j in np.nonzero(alive & (bound >= 0))[0]
        }
        pending_view = {
            plan.universe_keys[j] for j in np.nonzero(alive & (bound < 0))[0]
        }
        return SegmentOutcome(
            steps=steps,
            pass_count=int(np.asarray(pulled_state["pass_count"]).ravel()[0]),
            backoff=backoff,
            bound_view=bound_view,
            pending_view=pending_view,
        )

    # -- reconcile -----------------------------------------------------------

    def advance_service_slots(self, step_nodes: "Sequence[Any]") -> None:
        """Roll the canonical featurizer's slot history forward one entry
        per reconciled step (``None`` = the pass never featurized: empty
        eligible queue — the per-pass path skips the sync too), so a LATER
        fallback pass sees exactly the node order the per-pass history
        would have produced.  Called AFTER the segment transaction
        commits: the featurizer has no rollback."""
        feat = self._service_featurizer()
        for nodes in step_nodes:
            if nodes is not None:
                feat.advance_slots(nodes)

    def verify_segment(self, seg: SegmentOutcome) -> None:
        """Verify the staged store converged to the device's view of the
        cluster.  Runs INSIDE the segment transaction: a mismatch raises
        ReplayParityError and the transaction rolls every staged write
        back."""
        store_bound = {
            _pod_key(p): p["spec"]["nodeName"] for p in self.store.pods_with_node()
        }
        store_pending = {_pod_key(p) for p in self.store.pods_without_node()}
        if store_bound != seg.bound_view or store_pending != seg.pending_view:
            extra = set(store_bound) ^ set(seg.bound_view)
            raise ReplayParityError(
                "device-resident replay diverged from the store after "
                f"reconcile: {len(extra)} pod(s) differ (e.g. "
                f"{sorted(extra)[:3]}); bound {len(store_bound)} vs "
                f"{len(seg.bound_view)}, pending {len(store_pending)} vs "
                f"{len(seg.pending_view)}"
            )

    def sync_service(self, seg: SegmentOutcome) -> None:
        """Sync service bookkeeping (pass counter, backoff table) to the
        committed device outcome — post-commit only."""
        svc = self.service
        svc._pass_count = seg.pass_count
        with svc._backoff_lock:
            svc._backoff = dict(seg.backoff)
        self._advance_cache(seg)

    def _advance_cache(self, seg: SegmentOutcome) -> None:
        """Roll the lowered-universe cache forward to the committed
        segment's end state: the lowered universe filtered to the pods the
        device left alive (``verify_segment`` proved that view equal to
        the store).  Refuses and invalidates if the store epoch moved
        since the lowering read it."""
        plan = self._last_plan
        cache = self._cache
        if plan is None:
            cache.invalidate("no_plan")
            return
        if self.store.mutation_epoch != plan.lower_epoch:
            cache.invalidate("epoch_raced")
            return
        surv = set(seg.bound_view) | set(seg.pending_view)
        keep = [j for j, k in enumerate(plan.universe_keys) if k in surv]
        cache.keys = [plan.universe_keys[j] for j in keep]
        cache.sort_keys = [plan.sort_keys[j] for j in keep]
        cache.clean_pods = [plan.clean_pods[j] for j in keep]
        cache.priority_of = plan.priority_of
        cache.prio_gen = plan.prio_gen
        cache.sched_names = plan.sched_names
        cache.epoch = plan.lower_epoch
        cache.valid = True

    def note_reconcile_fault(self) -> None:
        """Account one rolled-back segment reconcile (the runner's
        atomic-commit fallback); the lowered-universe cache is flushed:
        the rolled-back window's head step is about to re-run per-pass."""
        self._reject("reconcile_fault")
        self._cache.invalidate("rollback")
        self._last_plan = None
