"""The debuggable-scheduler loop over an in-memory cluster.

The reference runs a real kube-scheduler whose wrapped plugins record
results, then a store reflector copies them onto the Pod's annotations
(reference simulator/scheduler/plugin/wrappedplugin.go,
simulator/scheduler/storereflector/storereflector.go:78-146).  Here the
whole cycle is one service over the ClusterStore:

- watch pods/nodes; on relevant changes collect the pending queue
  (no ``spec.nodeName``, non-terminal, matching schedulerName — upstream
  only schedules pods addressed to one of its profiles);
- sort by priority desc then creation/name (upstream PrioritySort
  queue-sort semantics);
- featurize the snapshot, run the Engine's sequential-commit scan;
- for each pod, bind (set ``spec.nodeName``, phase Running — what KWOK's
  fake kubelet would do in the reference topology, compose.yml
  simulator-cluster) and write the 13 result annotations + result-history
  (engine/annotations.py), exactly as the reflector does.

The port of ``ksim_tpu/scheduler/service.py`` onto the port's Engine.
``exact`` stands in for the reference's process-wide ``jax_enable_x64``
and ``device`` for its default backend: the engines run on CUDA unless
the caller passes ``device="cpu"`` (the plain PyTorch versions).  A
profile with scheduler extenders is evaluated pod by pod through kernel B
(``_schedule_queue_with_extenders``); the device profiler is
``torch.profiler`` (``start_profiling`` / ``stop_profiling``).
``shard_mesh`` (engine/sharding.py ``make_mesh``) lays every per-pass
engine out over a device mesh (``Engine.shard``).

Self-triggering guard: our own pod updates emit MODIFIED events; the run
loop skips events whose resourceVersion we just wrote, so an unschedulable
pod doesn't retrigger an identical cycle forever (the upstream analogue is
the scheduling queue's backoff, not event-driven retry).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, Sequence

import copy

import torch

from ksim_tpu_torch.engine.annotations import RenderCtx, apply_results_to_pod, render_pod_results
from ksim_tpu_torch.engine.core import Engine, ScoredPlugin
from ksim_tpu_torch.faults import FAULTS
from ksim_tpu_torch.scheduler.profile import (
    DEFAULT_SCHEDULER_NAME,
    Builder,
    CompiledProfile,
    compile_configuration,
)
from ksim_tpu_torch.scheduler.permit import (
    REJECT,
    SUCCESS,
    WAIT,
    PermitResult,
    go_duration_str,
)
from ksim_tpu_torch.errors import NotFoundError
from ksim_tpu_torch.obs import TRACE
from ksim_tpu_torch.state.cluster import ClusterStore, WatchEvent
from ksim_tpu_torch.state.featurizer import FeaturizedSnapshot, Featurizer
from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of
from ksim_tpu_torch.util import Metrics

logger = logging.getLogger(__name__)

PluginsFactory = Callable[[FeaturizedSnapshot], Sequence[ScoredPlugin]]

# Self-triggered-event suppression set cap (resourceVersions are numeric
# strings from ClusterStore; keep the newest).
_OWN_RV_LIMIT = 4096


def queue_sort_key(pod: JSON, priority_of=None):
    """Upstream PrioritySort: priority desc, then creation time asc; name
    breaks exact ties deterministically.  ``priority_of`` resolves
    PriorityClass names (state/priorities.py); bare spec.priority
    otherwise."""
    if priority_of is not None:
        prio = priority_of(pod)
    else:
        prio = int(pod.get("spec", {}).get("priority") or 0)
    created = pod.get("metadata", {}).get("creationTimestamp") or ""
    return (-prio, created, namespace_of(pod), name_of(pod))


from dataclasses import dataclass, field


@dataclass
class _WaitingPod:
    """A pod parked by Permit Wait (upstream framework waitingPod)."""

    name: str
    namespace: str
    node_name: str
    # plugin name -> monotonic deadline; emptied by allow() calls.
    pending: dict[str, float]
    # Pre-rendered result annotations (written at resolution).
    anno: dict[str, str] = field(default_factory=dict)
    # The pass's plugin tuple + compiled profile: the PreBind/Bind/
    # PostBind chains run at allow time (upstream: after WaitOnPermit).
    plugins: tuple = ()
    prof: object = None


class SchedulerService:
    """Batch-evaluating scheduler bound to a ClusterStore."""

    def __init__(
        self,
        store: ClusterStore,
        *,
        plugins_factory: PluginsFactory | None = None,
        config: JSON | None = None,
        registry: dict[str, Builder] | None = None,
        record: str = "full",
        featurizer: Featurizer | None = None,
        preemption: bool = True,
        max_pods_per_pass: int | None = None,
        pod_bucket_min: int | None = None,
        config_path: str | None = None,
        allow_plugin_imports: bool | None = None,
        shard_mesh=None,
        exact: bool = True,
        device: "str | torch.device | None" = None,
    ) -> None:
        # Optional engine/sharding.py Mesh: every per-pass engine this
        # service builds is laid out over it (node axis over "tp").  The
        # sequential scan runs on the mesh's first row, so a dp == 1 mesh
        # (make_mesh(n, dp=1)) is the scheduling path's.  The device replay
        # falls back per pass under a dp > 1 mesh, as the reference does,
        # and refuses a dp == 1 mesh with tp > 1 (engine/replay.py).
        self._shard_mesh = shard_mesh
        self._device = torch.device("cuda" if device is None else device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch versions"
            )
        self._exact = bool(exact)
        self._store = store
        # Preemption-eviction observers (add_eviction_listener): notified
        # with (namespace, name) right AFTER a victim's successful store
        # delete, so a live write-back can distinguish engine evictions
        # (which must propagate to the real cluster) from reset/user
        # deletes (which must never touch it).
        self._eviction_listeners: list = []
        # builderImport in runtime-applied configs (HTTP / snapshot load)
        # executes arbitrary imports; off unless the operator opts in.
        if allow_plugin_imports is None:
            allow_plugin_imports = (
                os.environ.get("KSIM_ALLOW_PLUGIN_IMPORTS") == "1"
            )
        self._allow_plugin_imports = allow_plugin_imports
        # Deferred below: the boot-time apply must NOT rewrite the user's
        # file (the reference only rewrites on update calls).
        self._config_path = None
        self._registry = registry or {}
        self._record = record
        self._preemption = preemption
        # Fleet-lane attribution (engine/fleet.py): when this service
        # belongs to one trajectory of an S-lane fleet, its scheduling
        # spans carry the lane id.
        self._trace_lane: "int | None" = None
        # Upstream schedules ONE pod per cycle; a pass here batches the
        # queue.  Capping the batch bounds featurize/scan cost per pass
        # under churn saturation — excess pods are simply deeper in the
        # queue, exactly as upstream's one-at-a-time loop would leave them.
        self._max_pods_per_pass = max_pods_per_pass
        # Coarser pod buckets bound the number of distinct compiled scan
        # shapes (each new padded shape is an XLA compile).
        self._pod_bucket_min = pod_bucket_min
        # Direct-factory mode (library use) bypasses profile compilation.
        self._plugins_factory = plugins_factory
        self._featurizer_override = featurizer
        self._initial_config = copy.deepcopy(config) or {}
        self._config: JSON = {}
        self._profiles: dict[str, CompiledProfile] = {}
        from ksim_tpu_torch.state.priorities import build_priority_resolver

        self._priority_of = build_priority_resolver(())
        # Featurizers persist per profile across passes: they carry the
        # incremental bound-pod aggregates (state/boundagg.py) keyed to
        # an evolving cluster; a config change drops them (re-compile =
        # the reference's scheduler restart).
        self._featurizers: dict[str, Featurizer] = {}
        # The constructor config is operator-owned (code/CLI), so plugin
        # imports are trusted here, like the reference's boot-time wasm
        # registration from the mounted scheduler.yaml.
        self.apply_scheduler_config(copy.deepcopy(self._initial_config), trusted=True)
        self._config_path = config_path
        self._own_rvs: set[str] = set()
        self._own_rvs_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Unschedulable-pod backoff (the upstream scheduling queue's
        # backoff/unschedulable pools, measured in scheduling passes
        # instead of wall-clock): an unschedulable pod skips
        # min(2^(attempts-1), MAX) passes; cluster events that could make
        # it schedulable flush the backoff (QueueingHint analogue).
        self._backoff: dict[str, tuple[int, int]] = {}  # key -> (attempts, retry_at)
        self._backoff_lock = threading.Lock()
        # Pods parked by a Permit plugin's Wait status (the upstream
        # framework's waitingPodsMap): key -> _WaitingPod.  While waiting,
        # a pod is neither pending nor bound; featurization charges its
        # requests to the selected node (the upstream assumed-pod cache).
        self._waiting: dict[str, "_WaitingPod"] = {}
        self._waiting_lock = threading.Lock()
        self._pass_waits = 0
        # Serializes scheduling passes against waiting-pod resolution:
        # allow/reject bind on the CALLER's thread, and doing that while a
        # pass holds a stale pod snapshot could schedule the pod twice.
        # RLock: _expire_waiting runs both inside a pass and standalone.
        self._pass_lock = threading.RLock()
        # Signals the watch loop to run a pass for state changes whose
        # events are rv-suppressed (a rejected waiter returning to the
        # queue).
        self._poke = threading.Event()
        self._pass_count = 0
        self.metrics = Metrics()
        # percentageOfNodesToScore emulation (opt-in replay-fidelity
        # mode, KSIM_PNTS_EMULATION=1): per-profile rotating start index
        # — upstream's sched.nextStartNodeIndex lives on the scheduler,
        # one per profile binary.
        self._pnts_emulation = (
            os.environ.get("KSIM_PNTS_EMULATION", "") == "1"
        )
        self._pnts_start: dict[str, int] = {}

    MAX_BACKOFF_PASSES = 16
    # An event-triggered flush caps the remaining wait instead of zeroing
    # it: upstream cluster events move pods from the indefinite
    # unschedulable pool into the BACKOFF queue — the pod still serves a
    # backoff before retrying (podInitialBackoff).  First-attempt pods
    # retry immediately; repeat offenders keep an attempts-proportional
    # wait, so a churn stream (deletes nearly every step) can't make the
    # whole saturated backlog retry every single pass.
    FLUSH_CAP_PASSES = 4

    def flush_backoff(self) -> None:
        """Accelerate backed-off pods (a node was added/removed or
        capacity freed): remaining wait drops to min(attempts-1, cap)."""
        with self._backoff_lock:
            self._backoff = {
                k: (
                    attempts,
                    min(
                        retry_at,
                        self._pass_count
                        + min(attempts - 1, self.FLUSH_CAP_PASSES),
                    ),
                )
                for k, (attempts, retry_at) in self._backoff.items()
            }

    def _in_backoff(self, pod: JSON) -> bool:
        # _pass_count was already incremented for the pass being built, so
        # a retry_at of P skips passes up to and including P (delay=1 ->
        # exactly one skipped pass).
        key = f"{namespace_of(pod)}/{name_of(pod)}"
        with self._backoff_lock:
            entry = self._backoff.get(key)
            return entry is not None and entry[1] >= self._pass_count

    def _record_attempts(self, placements: dict[str, str | None]) -> None:
        with self._backoff_lock:
            for key, node in placements.items():
                if node is None:
                    # A pod that preemption just nominated expects to
                    # schedule as soon as its victims are gone — upstream
                    # reactivates it on the delete events; never back it
                    # off.
                    ns, _, name = key.partition("/")
                    try:
                        pod = self._store.get("pods", name, ns)
                    except Exception:
                        continue
                    if pod.get("status", {}).get("nominatedNodeName"):
                        self._backoff.pop(key, None)
                        continue
                    attempts = self._backoff.get(key, (0, 0))[0] + 1
                    delay = min(2 ** (attempts - 1), self.MAX_BACKOFF_PASSES)
                    self._backoff[key] = (attempts, self._pass_count + delay)
                else:
                    self._backoff.pop(key, None)

    def _featurizer_for(self, sched_name: str, prof=None) -> Featurizer:
        """The profile's persistent featurizer, created lazily on the
        first pass that needs it — or eagerly by a checkpoint restore
        seeding slot order before any pass has run.  ``prof`` skips the
        profile lookup when the caller already resolved it; an unknown
        profile name raises (the restore path treats that as an
        unusable checkpoint and falls back)."""
        feat = self._featurizers.get(sched_name)
        if feat is None:
            if self._plugins_factory is not None:
                feat = Featurizer(pod_bucket_min=self._pod_bucket_min)
            else:
                if prof is None:
                    prof = self._profiles[sched_name]
                feat = prof.featurizer(pod_bucket_min=self._pod_bucket_min)
            self._featurizers[sched_name] = feat
        return feat

    # -- job-plane checkpoint carries (incremental resume) -------------------

    def checkpoint_carries(self) -> dict:
        """The scheduling-visible carry state a segment checkpoint must
        record for a byte-identical resume (ksim_tpu/jobs/manager.py):
        the pass counter (backoff ``retry_at`` values are measured in
        passes), the unschedulable-backoff map, the pnts rotating start
        indexes, and each persistent featurizer's node-slot ORDER
        (selectHost breaks score ties by lowest slot index, and the
        swap-remove slot order is history-dependent — a fresh
        featurizer's first-seen order would schedule differently).
        ``waiting`` is evidence only: a non-empty Permit waiting map is
        not restorable and makes the caller SKIP the checkpoint."""
        with self._backoff_lock:
            backoff = {k: [a, r] for k, (a, r) in self._backoff.items()}
        with self._waiting_lock:
            waiting = len(self._waiting)
        return {
            "pass_count": self._pass_count,
            "backoff": backoff,
            "pnts_start": dict(self._pnts_start),
            "slots": {
                name: f.slot_names() for name, f in self._featurizers.items()
            },
            "waiting": waiting,
        }

    def restore_carries(self, carry: dict) -> None:
        """Install ``checkpoint_carries`` output on a FRESH service
        (the job worker's restore path, before any pass runs).
        Featurizers for the recorded profiles are created eagerly and
        slot-seeded; the additive bound-pod families start empty and
        rebuild on the first pass — cold but consistent, exactly like
        the replay lower-caches against the restored mutation epoch."""
        self._pass_count = int(carry.get("pass_count", 0))
        with self._backoff_lock:
            self._backoff = {
                str(k): (int(a), int(r))
                for k, (a, r) in (carry.get("backoff") or {}).items()
            }
        self._pnts_start = {
            str(k): int(v) for k, v in (carry.get("pnts_start") or {}).items()
        }
        for name, names in (carry.get("slots") or {}).items():
            self._featurizer_for(name).seed_slots([str(n) for n in names])

    # -- scheduler configuration (reference scheduler.go Service) -----------

    def get_scheduler_config(self) -> JSON:
        """Current KubeSchedulerConfiguration as a typed document.  When
        nothing was ever applied this returns the scheme-defaulted shape
        (kind/apiVersion + the default profile), like the reference's
        DefaultSchedulerConfig (scheduler/config/config.go:19-26) feeding
        the GET handler (handler/schedulerconfig.go:26-40)."""
        cfg = copy.deepcopy(self._config)
        cfg.setdefault("apiVersion", "kubescheduler.config.k8s.io/v1")
        cfg.setdefault("kind", "KubeSchedulerConfiguration")
        if not cfg.get("profiles"):
            # Mirror compile_configuration's falsy test: an explicit empty
            # list also compiles to the default profile, so report it.
            cfg["profiles"] = [
                {"schedulerName": name} for name in sorted(self._profiles)
            ]
        return cfg

    def apply_scheduler_config(self, cfg: JSON, *, trusted: bool = False) -> None:
        """Compile-and-swap — the reference's RestartScheduler with
        rollback (scheduler.go:90-111): a config that fails to compile
        leaves the previous profiles in place and raises."""
        from ksim_tpu_torch.scheduler.extender import ExtenderService

        profiles = compile_configuration(
            cfg,
            registry=self._registry,
            allow_plugin_imports=trusted or self._allow_plugin_imports,
        )
        extenders = ExtenderService((cfg or {}).get("extenders"))
        self._profiles = {p.scheduler_name: p for p in profiles}
        # New kernel set -> fresh featurizers (drops incremental state).
        if getattr(self, "_featurizers", None):
            self._featurizers.clear()
        self._extenders = extenders
        self._config = copy.deepcopy(cfg) or {}
        # Persist the applied config like the reference rewrites the
        # mounted scheduler.yaml (scheduler/config/config.go:33-60
        # UpdateSchedulerConfig) — a restart then boots with it.  An
        # empty config is persisted too (a reset must not resurrect the
        # pre-reset file on restart).  Atomic: dump to a sibling temp
        # file then replace, so a mid-write failure can't truncate the
        # real file.
        if self._config_path:
            try:
                import os
                import yaml

                tmp = f"{self._config_path}.tmp"
                with open(tmp, "w") as f:
                    yaml.safe_dump(self._config, f, sort_keys=False)
                os.replace(tmp, self._config_path)
            except (OSError, yaml.YAMLError):
                logger.exception("failed to write scheduler config")

    def reset_scheduler_config(self) -> None:
        """Back to the boot-time config (reference di.go initial cfg)."""
        self.apply_scheduler_config(copy.deepcopy(self._initial_config), trusted=True)

    @property
    def extender_service(self):
        return self._extenders

    @property
    def _scheduler_names(self) -> tuple[str, ...]:
        if self._plugins_factory is not None:
            return (DEFAULT_SCHEDULER_NAME,)
        return tuple(self._profiles)

    # -- queue --------------------------------------------------------------

    def _is_pending(self, pod: JSON) -> bool:
        if pod.get("spec", {}).get("nodeName"):
            return False
        if pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            return False
        # Waiting on Permit: parked, not re-queued (upstream keeps the
        # pod assumed while its waitingPod entry exists).  Unlocked empty
        # check first: this runs once per pod per queue build, and the
        # map is almost always empty.
        if self._waiting:
            with self._waiting_lock:
                if f"{namespace_of(pod)}/{name_of(pod)}" in self._waiting:
                    return False
        # SchedulingGates (upstream PreEnqueue): gated pods never enter
        # the scheduling queue until every gate is removed.
        if pod.get("spec", {}).get("schedulingGates"):
            return False
        name = pod.get("spec", {}).get("schedulerName") or DEFAULT_SCHEDULER_NAME
        return name in self._scheduler_names

    def pending_pods(self) -> list[JSON]:
        """The sorted pending queue (deep copies — callers may mutate).
        Public API (the reference UI lists it); hot loops wanting only
        the size use pending_count()."""
        return copy.deepcopy(self._pending_pods_live())

    def pending_count(self) -> int:
        """Number of pending pods (no copies — the hot-loop counter).
        The store's nodeName partition bounds the walk to the unbound
        side (every bound pod fails _is_pending's first check)."""
        return sum(
            1
            for p in self._store.pods_without_node()
            if self._is_pending(p)
        )

    def _pending_pods_live(self) -> list[JSON]:
        """Internal read-only variant over the store's live dicts."""
        return sorted(
            (p for p in self._store.pods_without_node() if self._is_pending(p)),
            key=lambda p: queue_sort_key(p, self._priority_of),
        )

    # -- one scheduling pass ------------------------------------------------

    def start_profiling(self, log_dir: str) -> None:
        """Start a ``torch.profiler`` trace (CPU and, on a card, CUDA
        activities: every kernel launch and its device time) with a
        "scheduling-pass" range per ``schedule_pending`` pass, its pass
        number as the range's argument — the counterpart of the
        reference's ``jax.profiler.start_trace`` with a
        ``StepTraceAnnotation`` per pass.  ``stop_profiling`` writes the
        Chrome trace into ``log_dir``."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self._device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        self._profiler = prof
        self._profile_dir = log_dir
        self._profiling = True

    def stop_profiling(self) -> str | None:
        """Stop the trace ``start_profiling`` started and write it to
        ``<log_dir>/ksim_tpu_torch.<pid>.<n>.pt.trace.json``; returns the
        file's path (None when no trace was running)."""
        if not getattr(self, "_profiling", False):
            return None
        import os

        prof = self._profiler
        self._profiling = False
        self._profiler = None
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        self._profile_traces = getattr(self, "_profile_traces", 0) + 1
        path = os.path.join(
            self._profile_dir, f"ksim_tpu_torch.{os.getpid()}.{self._profile_traces}.pt.trace.json"
        )
        prof.export_chrome_trace(path)
        return path

    def schedule_pending(self) -> dict[str, str | None]:
        """Schedule every pending pod once (per profile group); returns
        namespace/name -> node name (None = unschedulable this pass).
        Results are recorded on the pods' annotations either way (the
        reference records every attempt; history accumulates)."""
        if getattr(self, "_profiling", False):
            with torch.profiler.record_function("scheduling-pass", str(self._pass_count)):
                return self._schedule_pending_inner()
        return self._schedule_pending_inner()

    # Machine-checked acquisition order (tools/ksimlint lock-order —
    # docs/lint.md "Lock order"): one pass takes the pass lock
    # OUTERMOST, then everything it needs under it; the backoff lock
    # nests a read-only store lookup; the planes are leaves.
    # ksimlint: lock-order(SchedulerService._pass_lock<SchedulerService._backoff_lock<ClusterStore._lock)
    # ksimlint: lock-order(SchedulerService._pass_lock<SchedulerService._waiting_lock)
    # ksimlint: lock-order(SchedulerService._pass_lock<SchedulerService._own_rvs_lock)
    # ksimlint: lock-order(SchedulerService._pass_lock<ClusterStore._lock)
    # ksimlint: lock-order(SchedulerService._pass_lock<FaultPlane._lock)
    # ksimlint: lock-order(SchedulerService._pass_lock<Metrics._lock)
    # ksimlint: lock-order(SchedulerService._pass_lock<TracePlane._lock)
    def _schedule_pending_inner(self) -> dict[str, str | None]:
        with self._pass_lock:
            # The span covers the pass body only (not the lock wait):
            # queue-contention latency would otherwise masquerade as
            # scheduling latency in the histogram.  A fleet-lane service
            # (scenario/runner.py sets _trace_lane) stamps its lane id so a
            # per-pass fallback pass is attributable to its trajectory.
            tags = {} if self._trace_lane is None else {"lane": self._trace_lane}
            with TRACE.span("service.schedule", pass_num=self._pass_count + 1, **tags):
                return self._schedule_pending_locked()

    def _schedule_pending_locked(self) -> dict[str, str | None]:
        # Fault-plane site: an injected fault aborts the pass BEFORE any
        # bookkeeping mutates (pass counter, placements) — the watch
        # loop's containment (its except around schedule_pending) and
        # the runner's step retry are what a schedule here exercises.
        FAULTS.check("service.schedule")
        nodes = self._store.list("nodes", copy_objs=False)
        namespaces = self._store.list("namespaces", copy_objs=False)
        volume_kw = dict(
            pvs=self._store.list("persistentvolumes", copy_objs=False),
            pvcs=self._store.list("persistentvolumeclaims", copy_objs=False),
            storage_classes=self._store.list("storageclasses", copy_objs=False),
        )
        from ksim_tpu_torch.state.priorities import build_priority_resolver

        self._priority_of = build_priority_resolver(
            self._store.list("priorityclasses", copy_objs=False)
        )
        if not nodes:
            return {}
        self._pass_count += 1
        placements: dict[str, str | None] = {}
        self._expire_waiting()
        # Permit-WAIT placements carry a node name (the assumed node) but
        # nothing bound yet; _finalize_waiting counts the eventual bind.
        self._pass_waits = 0
        for sched_name in self._scheduler_names:
            # Fresh pod snapshot per profile: earlier profiles' bindings
            # must charge their nodes before the next profile evaluates.
            # The store's nodeName partition replaces the O(all pods)
            # walk: queue candidates come from the without-node side
            # (permit-assumed pods gain a nodeName in the wrap and fall
            # out via _is_pending, exactly as they did from the full
            # list), bound pods from the with-node side.
            without = self._assume_waiting(self._store.pods_without_node())
            bound_pods = self._store.pods_with_node()
            assumed = [p for p in without if p.get("spec", {}).get("nodeName")]
            if assumed:
                bound_pods = bound_pods + assumed
            queue = [
                p
                for p in without
                if self._is_pending(p)
                and not self._in_backoff(p)
                and (p.get("spec", {}).get("schedulerName") or DEFAULT_SCHEDULER_NAME)
                == sched_name
            ]
            if not queue:
                continue
            prof = (
                self._profiles.get(sched_name)
                if self._plugins_factory is None
                else None
            )
            # PreEnqueue gates (upstream wrappedplugin.go:376; structural
            # SchedulingGates already filtered in _is_pending): any hook
            # returning a message keeps the pod out of this pass's queue.
            if prof is not None and prof.pre_enqueue_hooks:
                queue = [p for p in queue if self._pre_enqueue_admits(prof, p)]
                if not queue:
                    continue
            # Custom QueueSort replaces PrioritySort's order
            # (wrappedplugin.go:750-765).
            if prof is not None and prof.queue_sort_plugin is not None:
                _qs_name, qs_key = prof.queue_sort_plugin
                queue.sort(key=lambda p: qs_key(p, self._priority_of))
            else:
                queue.sort(key=lambda p: queue_sort_key(p, self._priority_of))
            if self._max_pods_per_pass is not None:
                queue = queue[: self._max_pods_per_pass]
            featurizer = self._featurizer_override
            if featurizer is None:
                featurizer = self._featurizer_for(sched_name, prof)
            if self._plugins_factory is not None:
                factory: PluginsFactory = self._plugins_factory
            else:
                factory = prof.plugins
            if self._extenders:
                # Webhook extenders need per-pod HTTP round-trips between
                # filtering and scoring — exact upstream semantics require
                # pod-at-a-time evaluation (the reference's scheduler is
                # per-pod anyway; extenders are the slow path by design).
                if self._pnts_emulation and not getattr(
                    self, "_pnts_extender_warned", False
                ):
                    # Sampling emulation does not apply on this path (it
                    # lives in the scan program) — say so once instead of
                    # silently scoring every node under the flag.
                    self._pnts_extender_warned = True
                    logger.warning(
                        "KSIM_PNTS_EMULATION=1 is inert for profiles "
                        "with extenders (per-pod evaluation path scores "
                        "all nodes)"
                    )
                self._schedule_queue_with_extenders(
                    queue, featurizer, factory, namespaces, volume_kw, placements,
                    prof=prof,
                )
                continue
            with self.metrics.timer("featurize"):
                feats = featurizer.featurize(
                    nodes,
                    (),
                    queue_pods=queue,
                    bound_pods=bound_pods,
                    namespaces=namespaces,
                    **volume_kw,
                )
            plugins = tuple(factory(feats))
            sampling_k = self._sampling_k_for(prof, len(nodes))
            with self.metrics.timer("engine"):
                eng = Engine(
                    feats,
                    plugins,
                    record=self._record,
                    sampling_k=sampling_k,
                    exact=self._exact,
                    device=self._device,
                )
                if self._shard_mesh is not None:
                    eng.shard(self._shard_mesh)
                res, _ = eng.schedule(
                    pull_state=False,
                    sampling_start=self._pnts_start.get(sched_name, 0),
                )
            if sampling_k is not None and res.sampling_next_start is not None:
                self._pnts_start[sched_name] = res.sampling_next_start
            with self.metrics.timer("bind"):
                self._bind_results(queue, feats, plugins, res, placements, prof=prof)
        # Bound _own_rvs growth for library use (schedule_pending without
        # the watch loop draining events).  The limit scales with the pass
        # size so one large pass never trims its own still-queued events
        # out of the suppression set (that would retrigger endless passes).
        with self._own_rvs_lock:
            limit = max(_OWN_RV_LIMIT, 2 * len(placements))
            if len(self._own_rvs) > limit:
                for rv in sorted(self._own_rvs, key=int)[:-limit]:
                    self._own_rvs.discard(rv)
        self._record_attempts(placements)
        if TRACE.active:
            TRACE.event(
                "service.pass",
                pass_num=self._pass_count,
                attempts=len(placements),
                scheduled=sum(1 for v in placements.values() if v is not None),
                unschedulable=sum(1 for v in placements.values() if v is None),
            )
        self.metrics.inc("scheduling_passes")
        self.metrics.inc("scheduling_attempts", len(placements))
        self.metrics.inc(
            "pods_scheduled",
            sum(1 for v in placements.values() if v is not None) - self._pass_waits,
        )
        self.metrics.inc(
            "pods_unschedulable", sum(1 for v in placements.values() if v is None)
        )
        with self._backoff_lock:
            if len(self._backoff) > 2 * len(placements) + 64:
                alive = {
                    f"{namespace_of(p)}/{name_of(p)}"
                    for p in self._store.list("pods", copy_objs=False)
                }
                self._backoff = {
                    k: v for k, v in self._backoff.items() if k in alive
                }
        return placements

    def _schedule_queue_with_extenders(
        self, queue, featurizer, factory, namespaces, volume_kw, placements,
        prof=None,
    ) -> None:
        """Per-pod cycle with extender webhooks (upstream
        findNodesThatPassExtenders + prioritizeNodes extender scores):
        engine filters/scores the pod batch-style against all nodes, then
        each configured extender filters the feasible set and adds
        prioritize scores before selectHost.  Each pod's evaluation is one
        ``evaluate_batch`` (kernel B on a card).  The service's metrics
        time "featurize", "engine" (the Engine and its evaluation,
        transfers included) and "extender_http" (each webhook round trip)
        per pod."""
        import numpy as np

        for pod in queue:
            nodes = self._store.list("nodes", copy_objs=False)
            pods = self._assume_waiting(self._store.list("pods", copy_objs=False))
            with self.metrics.timer("featurize"):
                feats = featurizer.featurize(
                    nodes, pods, queue_pods=[pod], namespaces=namespaces, **volume_kw
                )
            plugins = tuple(factory(feats))
            with self.metrics.timer("engine"):
                eng = Engine(feats, plugins, record="full", exact=self._exact, device=self._device)
                res = eng.evaluate_batch()
            n_valid = feats.nodes.count
            ok = np.asarray(res.reason_bits[0] == 0).all(axis=0)[:n_valid]
            feasible = [feats.nodes.names[i] for i in range(n_valid) if ok[i]]
            node_objs = {name_of(n): n for n in nodes}
            failed = False
            for idx, ext in enumerate(self._extenders.extenders):
                if not feasible:
                    break
                if not ext.filter_verb:
                    continue
                # managedResources gate (extender.go:99-112): extenders
                # managing specific resources only see pods requesting them.
                if not ext.is_interested(pod):
                    continue
                args = {"pod": pod}
                if ext.node_cache_capable:
                    args["nodenames"] = list(feasible)
                else:
                    args["nodes"] = {"items": [node_objs[n] for n in feasible]}
                try:
                    with self.metrics.timer("extender_http"):
                        result = self._extenders.filter(idx, args)
                except Exception:
                    logger.exception("extender %s filter failed", ext.name)
                    if ext.ignorable:
                        continue
                    failed = True
                    break
                if result.get("error"):
                    if ext.ignorable:
                        continue
                    failed = True
                    break
                if result.get("nodenames") is not None:
                    keep = set(result["nodenames"])
                    feasible = [n for n in feasible if n in keep]
                elif result.get("nodes") is not None:
                    keep = {
                        name_of(item) for item in result["nodes"].get("items") or []
                    }
                    feasible = [n for n in feasible if n in keep]
            selected = None
            if feasible and not failed:
                feasible_set = set(feasible)
                totals = {
                    feats.nodes.names[i]: int(res.total[0, i])
                    for i in range(n_valid)
                    if feats.nodes.names[i] in feasible_set
                }
                for idx, ext in enumerate(self._extenders.extenders):
                    if not ext.prioritize_verb:
                        continue
                    if not ext.is_interested(pod):
                        continue
                    args = {"pod": pod}
                    if ext.node_cache_capable:
                        args["nodenames"] = list(feasible)
                    else:
                        args["nodes"] = {"items": [node_objs[n] for n in feasible]}
                    try:
                        with self.metrics.timer("extender_http"):
                            prioritized = self._extenders.prioritize(idx, args)
                        for hp in prioritized:
                            host = hp.get("host")
                            if host in totals:
                                totals[host] += int(hp.get("score") or 0)
                    except Exception:
                        logger.exception("extender %s prioritize failed", ext.name)
                # selectHost: max score, lowest node index on ties.
                order = {n: i for i, n in enumerate(feats.nodes.names)}
                selected = max(feasible, key=lambda n: (totals[n], -order[n]))
            # PostFilter still runs when nothing fit (the batch path's
            # preemption applies identically; extenders may further have a
            # preemptVerb — the proxy route records it when an external
            # scheduler drives it).
            nominated, victims, postfilter = None, [], None
            # An aborted cycle (non-ignorable extender error) never runs
            # PostFilter — upstream gives up on the pod for this pass.
            if selected is None and not failed:
                nominated, victims, postfilter = self._run_post_filter(
                    pod, feats, plugins, res, 0, prof=prof
                )
            # Reserve -> Permit -> PreBind/Bind on this path too
            # (upstream's cycle is identical with or without extenders).
            reserve_extra: dict[str, str] = {}
            reserve_failed = False
            if selected is not None:
                reserve_extra, reserve_failed = self._run_reserve(
                    plugins, pod, selected
                )
                if reserve_failed:
                    self._run_unreserve(plugins, pod, selected)
            permit_maps = None
            permit_verdict = SUCCESS
            wait_deadlines: dict[str, float] = {}
            if selected is not None and not reserve_failed:
                permit_verdict, permit_maps, wait_deadlines = self._run_permit(
                    plugins, pod, selected
                )
                if permit_verdict == REJECT:
                    self._run_unreserve(plugins, pod, selected)
            prebind_extra: dict[str, str] = {}
            bind_map = None
            bind_ok = not reserve_failed
            if selected is not None and not reserve_failed and permit_verdict == SUCCESS:
                prebind_extra, prebind_failed = self._run_pre_bind(
                    plugins, pod, selected
                )
                if prebind_failed:
                    bind_ok = False
                    bind_map = {}
                else:
                    bind_map, bind_ok = self._run_bind(
                        plugins, pod, selected, prof=prof
                    )
                if not bind_ok:
                    self._run_unreserve(plugins, pod, selected)
            anno = render_pod_results(
                feats,
                plugins,
                res,
                0,
                postfilter=postfilter,
                permit=permit_maps,
                bound=permit_verdict != REJECT and bind_ok,
                reserve_extra=reserve_extra,
                prebind_extra=prebind_extra,
                bind_map=bind_map,
                visited=None if res.visited is None else res.visited[0],
            )
            anno.update(self._extenders.store.get_stored_result(pod))
            selected_settle = None if reserve_failed else selected
            selected, parked = self._settle_permit(
                pod, selected_settle, permit_verdict, wait_deadlines, anno,
                placements, plugins=plugins, prof=prof,
            )
            if parked:
                self._extenders.store.delete_data(pod)
                continue
            if not bind_ok:
                selected = None

            def mutate(obj: JSON) -> None:
                annos = obj.setdefault("metadata", {}).setdefault("annotations", {})
                apply_results_to_pod(annos, anno)
                if selected:
                    obj.setdefault("spec", {})["nodeName"] = selected
                    obj.setdefault("status", {})["phase"] = "Running"
                    obj.get("status", {}).pop("nominatedNodeName", None)
                elif nominated:
                    obj.setdefault("status", {})["nominatedNodeName"] = nominated

            try:
                updated = self._store.patch(
                    "pods", name_of(pod), namespace_of(pod), mutate
                )
            except NotFoundError:
                # Deleted mid-cycle: fail just this pod (see _bind_results).
                logger.info(
                    "pod %s/%s deleted mid-cycle; skipping its bind",
                    namespace_of(pod), name_of(pod),
                )
                self._extenders.store.delete_data(pod)
                continue
            self._extenders.store.delete_data(pod)
            with self._own_rvs_lock:
                self._own_rvs.add(updated["metadata"]["resourceVersion"])
            if selected is not None:
                self._run_post_bind(plugins, updated, selected)
            for v in victims:
                self._evict_victim(v)
            placements[f"{namespace_of(pod)}/{name_of(pod)}"] = selected

    # Upstream sampling constants (schedule_one.go).
    _MIN_FEASIBLE_NODES_TO_FIND = 100
    _MIN_FEASIBLE_PERCENTAGE = 5

    def _sampling_k_for(self, prof, n_nodes: int) -> int | None:
        """numFeasibleNodesToFind (schedule_one.go): None = score all
        nodes (emulation off, small cluster, or percentage resolves to
        everything).  A per-profile percentageOfNodesToScore overrides
        the global field; 0/unset means the adaptive formula
        50 - n/125, floored at 5%."""
        if not self._pnts_emulation:
            return None
        if n_nodes < self._MIN_FEASIBLE_NODES_TO_FIND:
            return None
        pct = None
        if prof is not None and prof.percentage_of_nodes_to_score is not None:
            pct = prof.percentage_of_nodes_to_score
        if pct is None:
            v = (self._config or {}).get("percentageOfNodesToScore")
            pct = v if isinstance(v, int) else 0
        if pct == 0:
            pct = max(50 - n_nodes // 125, self._MIN_FEASIBLE_PERCENTAGE)
        if pct >= 100:
            return None
        k = max(n_nodes * pct // 100, self._MIN_FEASIBLE_NODES_TO_FIND)
        return None if k >= n_nodes else k

    def add_eviction_listener(self, fn) -> None:
        """Register a (namespace, name) callback fired right after each
        preemption victim's SUCCESSFUL store delete (see __init__ note;
        the victim is already gone from the store when it fires)."""
        self._eviction_listeners.append(fn)

    def _evict_victim(self, v: JSON, *, listener_sink=None) -> None:
        """Preemption eviction (the debuggable scheduler deletes victims
        via the apiserver; KWOK terminates immediately).  Listeners run
        only AFTER the store delete succeeded — a mark for a delete that
        never happened would leak and misclassify a LATER plain delete
        of a same-named pod as an eviction (the write-back's DELETED
        handler rechecks once to absorb the mark-after-event race).

        ``listener_sink`` defers the listener callbacks: the successful
        eviction appends ``(namespace, name)`` there instead of firing,
        and the caller replays the sink through ``_notify_evictions``
        once its batch is durable — the device replay's atomic segment
        reconcile stages evictions inside a store transaction and must
        not announce one that could still roll back."""
        try:
            self._store.delete("pods", name_of(v), namespace_of(v))
        except Exception:
            logger.exception("failed to evict victim %s", name_of(v))
            return
        ev = (namespace_of(v) or "default", name_of(v))
        if listener_sink is not None:
            listener_sink.append(ev)
            return
        self._notify_evictions([ev])

    def _notify_evictions(self, evictions) -> None:
        """Fire eviction listeners for ``(namespace, name)`` tuples in
        order (each listener isolated — one failing must not starve the
        rest)."""
        for ns, nm in evictions:
            for fn in self._eviction_listeners:
                try:
                    fn(ns, nm)
                except Exception:
                    logger.exception("eviction listener failed")

    def _bind_results(self, queue, feats, plugins, res, placements, prof=None) -> None:
        render_ctx = RenderCtx(feats, plugins) if self._record == "full" else None
        for j, pod in enumerate(queue):
            sel = int(res.selected[j])
            node_name = feats.nodes.names[sel] if sel >= 0 else None
            nominated, victims, postfilter = None, [], None
            if node_name is None:
                nominated, victims, postfilter = self._run_post_filter(
                    pod, feats, plugins, res, j, prof=prof
                )
            # Reserve runs first on a selected node (upstream cycle
            # order: Reserve -> Permit -> WaitOnPermit -> PreBind ->
            # Bind); its failure unreserves and fails the cycle.
            reserve_extra: dict[str, str] = {}
            reserve_failed = False
            if node_name is not None:
                reserve_extra, reserve_failed = self._run_reserve(
                    plugins, pod, node_name
                )
                if reserve_failed:
                    self._run_unreserve(plugins, pod, node_name)
            # Permit runs after selection (upstream RunPermitPlugins is
            # post-Reserve, wrappedplugin.go:582-611).
            permit_maps = None
            permit_verdict = SUCCESS
            wait_deadlines: dict[str, float] = {}
            if node_name is not None and not reserve_failed:
                permit_verdict, permit_maps, wait_deadlines = self._run_permit(
                    plugins, pod, node_name
                )
                if permit_verdict == REJECT:
                    self._run_unreserve(plugins, pod, node_name)
            # PreBind/Bind chains (upstream: post-WaitOnPermit; for
            # permit-parked pods they run at allow time instead,
            # _finalize_waiting).
            prebind_extra: dict[str, str] = {}
            bind_map = None
            bind_ok = not reserve_failed
            if node_name is not None and not reserve_failed and permit_verdict == SUCCESS:
                prebind_extra, prebind_failed = self._run_pre_bind(
                    plugins, pod, node_name
                )
                if prebind_failed:
                    bind_ok = False
                    bind_map = {}
                else:
                    bind_map, bind_ok = self._run_bind(
                        plugins, pod, node_name, prof=prof
                    )
                if not bind_ok:
                    self._run_unreserve(plugins, pod, node_name)
            anno = (
                render_pod_results(
                    feats,
                    plugins,
                    res,
                    j,
                    postfilter=postfilter,
                    permit=permit_maps,
                    bound=permit_verdict != REJECT and bind_ok,
                    reserve_extra=reserve_extra,
                    prebind_extra=prebind_extra,
                    bind_map=bind_map,
                    ctx=render_ctx,
                    visited=None if res.visited is None else res.visited[j],
                )
                if self._record == "full"
                else {}
            )
            node_name_settle = None if reserve_failed else node_name
            node_name, parked = self._settle_permit(
                pod, node_name_settle, permit_verdict, wait_deadlines, anno,
                placements, plugins=plugins, prof=prof,
            )
            if parked:
                continue
            if not bind_ok:
                # A Reserve/PreBind/Bind failure fails the cycle: the pod
                # stays pending (upstream unreserves and requeues), the
                # attempt is recorded.
                node_name = None

            def rebuild(obj: JSON) -> JSON:
                # Shallow re-wrap (store.rewrap contract): share the
                # unchanged substructures, never mutate the old object —
                # deep-copying megabytes of accumulated result-history
                # per attempt dominated the record="full" product path.
                new = dict(obj)
                md = dict(obj.get("metadata") or {})
                annos = dict(md.get("annotations") or {})
                if anno:
                    apply_results_to_pod(annos, anno)
                md["annotations"] = annos
                new["metadata"] = md
                spec = dict(obj.get("spec") or {})
                status = dict(obj.get("status") or {})
                if node_name:
                    spec["nodeName"] = node_name
                    status["phase"] = "Running"
                    # The apiserver clears any earlier nomination on bind.
                    status.pop("nominatedNodeName", None)
                elif nominated:
                    status["nominatedNodeName"] = nominated
                new["spec"] = spec
                new["status"] = status
                return new

            try:
                updated = self._store.rewrap(
                    "pods", name_of(pod), namespace_of(pod), rebuild
                )
            except NotFoundError:
                # The pod was deleted while this pass ran (a reset or an
                # external delete during a long compile): upstream's Bind
                # fails just THAT pod; the rest of the batch still binds.
                logger.info(
                    "pod %s/%s deleted mid-pass; skipping its bind",
                    namespace_of(pod), name_of(pod),
                )
                continue
            with self._own_rvs_lock:
                self._own_rvs.add(updated["metadata"]["resourceVersion"])
            if node_name is not None:
                self._run_post_bind(plugins, updated, node_name)
            # Evict the victims (the debuggable scheduler deletes them via
            # the apiserver; KWOK terminates immediately).  The DELETED
            # events trigger the next pass, which schedules the preemptor.
            for v in victims:
                self._evict_victim(v)
            placements[f"{namespace_of(pod)}/{name_of(pod)}"] = node_name

    # -- host extension points (PreEnqueue/PostFilter/PreBind/Bind/PostBind) -

    def _pre_enqueue_admits(self, prof, pod: JSON) -> bool:
        """All PreEnqueue hooks must return None (upstream: any
        non-success status keeps the pod out of the queue; an erroring
        gate blocks, like an upstream Error status)."""
        for name, hook in prof.pre_enqueue_hooks:
            try:
                msg = hook(pod)
            except Exception as e:
                logger.exception("pre-enqueue hook %s failed", name)
                msg = f"pre-enqueue error: {e}"
            if msg is not None:
                return False
        return True

    @staticmethod
    def _host_hooks(sp, hook_attr: str):
        """(hook, before, after) for one host extension point: the
        plugin's own ``hook_attr`` method plus the extender pair named
        ``before_<hook_attr>`` / ``after_<hook_attr>`` (PluginExtender
        host fields — the reference's Before/After extender interfaces,
        wrappedplugin.go:47-171).  All None when nothing is implemented."""
        hook = getattr(sp.plugin, hook_attr, None)
        ext = getattr(sp, "extender", None)
        before = getattr(ext, f"before_{hook_attr}", None) if ext else None
        after = getattr(ext, f"after_{hook_attr}", None) if ext else None
        return hook, before, after

    @staticmethod
    def _call_hook(point: str, name: str, fn, *args):
        """Run one hook under the shared error contract: an exception is
        logged and maps to the point's error status string (upstream
        converts plugin panics to Error statuses).  Returns
        (value, error_message) — exactly one is meaningful."""
        try:
            return fn(*args), None
        except Exception as e:
            logger.exception("%s hook of plugin %s failed", point, name)
            return None, f"{point} error: {e}"

    def _run_post_filter(self, pod, feats, plugins, res, j, prof=None):
        """The PostFilter chain: DefaultPreemption (structural) first in
        its default-config position, then out-of-tree ``post_filter``
        hooks in plugin order until one nominates a node — upstream
        RunPostFilterPlugins stops at the first success
        (wrappedplugin.go:550-577 wraps each).  Returns
        (nominated, victims, postfilter_annotation_map)."""
        nominated, victims, post = None, [], None
        default_on = self._preemption and (
            prof is None or "DefaultPreemption" not in prof.postfilter_disabled
        )
        if default_on:
            nominated, victims, post = self._attempt_preemption(
                pod, feats, plugins, res, j
            )
        if nominated is not None:
            return nominated, victims, post
        # Built lazily: with no custom PostFilter hooks registered (the
        # common case — 42829 unschedulable attempts per 50k churn
        # replay), materializing the full node-name list per attempt was
        # pure overhead (~3.5 s of the replay).
        failed_nodes: list[str] | None = None
        ran_custom = False
        for sp in plugins:
            if not getattr(sp, "postfilter_enabled", False):
                continue
            hook, before, after = self._host_hooks(sp, "post_filter")
            if hook is None and before is None and after is None:
                # plugins_factory-built sets carry default-True flags;
                # only a real hook makes this a PostFilter plugin.
                continue
            ran_custom = True
            if failed_nodes is None:
                failed_nodes = [
                    feats.nodes.names[i] for i in range(feats.nodes.count)
                ]
            name = sp.plugin.name
            msg = None
            nom = None
            if before is not None:
                msg, err = self._call_hook("postfilter extender", name, before, pod)
                msg = err if err is not None else msg
            if msg is None:
                if hook is not None:
                    nom, _err = self._call_hook(
                        "postfilter", name, hook, pod, list(failed_nodes)
                    )
                if after is not None:
                    pair, err = self._call_hook(
                        "postfilter extender", name, after, pod, nom, msg
                    )
                    if err is not None or not (
                        isinstance(pair, tuple) and len(pair) == 2
                    ):
                        nom, msg = None, err or (
                            f"postfilter extender {name} returned {pair!r}"
                        )
                    else:
                        nom, msg = pair
            if nom is not None and nom in set(failed_nodes):
                from ksim_tpu_torch.scheduler.preemption import NOMINATED_MESSAGE

                if post is None:
                    post = {n: {} for n in failed_nodes}
                post[nom] = {name: NOMINATED_MESSAGE}
                return nom, victims, post
        if post is None and ran_custom:
            post = {n: {} for n in failed_nodes}
        return nominated, victims, post

    def _run_status_chain(
        self,
        plugins,
        pod: JSON,
        node_name: str,
        *,
        hook_attr: str,
        point: str,
        enabled_attr: str,
    ):
        """Shared shape of the Reserve and PreBind chains (upstream runs
        both in order and stops at the first failure, which fails the
        cycle): before may short-circuit with a message, the original
        hook returns a message on failure, after may replace it.
        Returns ({plugin: success-or-message}, failed)."""
        from ksim_tpu_torch.engine.annotations import SUCCESS_MESSAGE

        extra: dict[str, str] = {}
        for sp in plugins:
            hook, before, after = self._host_hooks(sp, hook_attr)
            if hook is None and before is None and after is None:
                continue
            if not getattr(sp, enabled_attr, True):
                continue
            name = sp.plugin.name
            msg = None
            if before is not None:
                msg, err = self._call_hook(f"{point} extender", name, before, pod, node_name)
                msg = err if err is not None else msg
            if msg is None and hook is not None:
                msg, err = self._call_hook(f"{point} plugin", name, hook, pod, node_name)
                msg = err if err is not None else msg
            if after is not None:
                out, err = self._call_hook(
                    f"{point} extender", name, after, pod, node_name, msg
                )
                msg = err if err is not None else out
            extra[name] = SUCCESS_MESSAGE if msg is None else str(msg)
            if msg is not None:
                return extra, True
        return extra, False

    def _run_notify_chain(
        self,
        plugins,
        pod: JSON,
        node_name: str,
        *,
        hook_attr: str,
        point: str,
        enabled_attr: str,
        enabled_default: bool,
        reverse: bool = False,
    ) -> None:
        """Shared shape of the void notification chains (PostBind, and
        Unreserve which runs in REVERSE order — upstream
        wrappedplugin.go:650-668, :728-746): a non-None Before skips the
        original hook; all errors are logged, never propagated."""
        ordered = reversed(list(plugins)) if reverse else plugins
        for sp in ordered:
            if not getattr(sp, enabled_attr, enabled_default):
                continue
            hook, before, after = self._host_hooks(sp, hook_attr)
            if hook is None and before is None and after is None:
                continue
            name = sp.plugin.name
            if before is not None:
                msg, err = self._call_hook(
                    f"{point} extender", name, before, pod, node_name
                )
                if msg is not None or err is not None:
                    logger.warning(
                        "%s extender %s blocked the original hook", point, name
                    )
                    continue
            if hook is not None:
                self._call_hook(f"{point} plugin", name, hook, pod, node_name)
            if after is not None:
                self._call_hook(f"{point} extender", name, after, pod, node_name)

    def _run_reserve(self, plugins, pod: JSON, node_name: str):
        """The Reserve chain (upstream RunReservePlugins; the wrapper
        also records the selected node there, wrappedplugin.go:616-648 —
        this codebase does that via the selected-node annotation)."""
        return self._run_status_chain(
            plugins, pod, node_name,
            hook_attr="reserve", point="reserve", enabled_attr="reserve_enabled",
        )

    def _run_unreserve(self, plugins, pod: JSON, node_name: str) -> None:
        """Unreserve on every post-Reserve failure (wrappedplugin.go:650-668)."""
        self._run_notify_chain(
            plugins, pod, node_name,
            hook_attr="unreserve", point="unreserve",
            enabled_attr="reserve_enabled", enabled_default=True, reverse=True,
        )

    def _run_pre_bind(self, plugins, pod: JSON, node_name: str):
        """Out-of-tree PreBind hooks (upstream RunPreBindPlugins stops at
        the first failure; a failure fails the scheduling cycle)."""
        return self._run_status_chain(
            plugins, pod, node_name,
            hook_attr="pre_bind", point="prebind", enabled_attr="prebind_enabled",
        )

    def _run_bind(self, plugins, pod: JSON, node_name: str, prof=None):
        """The Bind chain (upstream RunBindPlugins: plugins in order; Skip
        falls through, the first non-Skip handles the bind;
        wrappedplugin.go:699-726 records per-binder results).  A custom
        ``bind(pod, node_name)`` returns None to skip, True when it
        accepts the bind (the store write — the simulated apiserver — is
        still the service's, exactly as the reference's wrapped binder
        ultimately binds through the simulator's apiserver), or a message
        string on failure.  Returns ({binder: status}, ok)."""
        from ksim_tpu_torch.engine.annotations import SUCCESS_MESSAGE

        for sp in plugins:
            if not getattr(sp, "bind_enabled", False):
                continue
            hook, before, after = self._host_hooks(sp, "bind")
            name = sp.plugin.name
            outcome = None
            if before is not None:
                outcome, err = self._call_hook("bind extender", name, before, pod, node_name)
                outcome = err if err is not None else outcome
            if outcome is None and hook is not None:
                outcome, err = self._call_hook("bind plugin", name, hook, pod, node_name)
                outcome = err if err is not None else outcome
            if after is not None:
                out, err = self._call_hook(
                    "bind extender", name, after, pod, node_name, outcome
                )
                outcome = err if err is not None else out
            if outcome is None:
                continue  # Skip: next bind plugin
            if outcome is True:
                return {name: SUCCESS_MESSAGE}, True
            return {name: str(outcome)}, False
        if prof is not None and "DefaultBinder" in prof.bind_disabled:
            # No binder handled the pod (upstream: "no Bind plugin" error).
            return {}, False
        return {"DefaultBinder": SUCCESS_MESSAGE}, True

    def _run_post_bind(self, plugins, pod: JSON, node_name: str) -> None:
        """PostBind notifications after a successful bind (upstream
        RunPostBindPlugins is void; wrappedplugin.go:728-746 — a
        non-success BeforePostBind skips the original hook)."""
        self._run_notify_chain(
            plugins, pod, node_name,
            hook_attr="post_bind", point="postbind",
            enabled_attr="postbind_enabled", enabled_default=False,
        )

    # -- Permit (upstream RunPermitPlugins + waitingPodsMap) ----------------

    def _run_permit(
        self, plugins, pod: JSON, node_name: str
    ) -> tuple[str, tuple[dict, dict], dict[str, float]]:
        """Run every permit-capable plugin for the selected (pod, node).

        Returns (verdict, ({plugin: status_msg}, {plugin: timeout_str}),
        {plugin: monotonic_deadline}).  Verdict: REJECT if any plugin
        rejected/errored, else WAIT if any asked to wait, else SUCCESS —
        upstream RunPermitPlugins merges statuses the same way."""
        import time as _time

        statuses: dict[str, str] = {}
        timeouts: dict[str, str] = {}
        deadlines: dict[str, float] = {}
        verdict = SUCCESS
        for sp in plugins:
            hook, before, after = self._host_hooks(sp, "permit")
            if (hook is None and before is None and after is None) or not getattr(
                sp, "permit_enabled", True
            ):
                continue
            name = sp.plugin.name
            result = None
            if before is not None:
                # A non-success BeforePermit skips the original hook and
                # becomes the point's status (extender iface semantics,
                # wrappedplugin.go:47-171).
                msg, err = self._call_hook("permit extender", name, before, pod, node_name)
                msg = err if err is not None else msg
                if msg is not None:
                    result = PermitResult.reject(str(msg))
            if result is None:
                if hook is not None:
                    # An erroring plugin rejects (upstream Error status).
                    result, err = self._call_hook("permit plugin", name, hook, pod, node_name)
                    if err is not None:
                        result = PermitResult.reject(err)
                else:
                    # Extender-only entry: a nil original permit succeeds
                    # (the wrapped plugin returns success when the
                    # original is absent).
                    result = PermitResult.allow()
                if after is not None:
                    result, err = self._call_hook(
                        "permit extender", name, after, pod, node_name, result
                    )
                    if err is not None:
                        result = PermitResult.reject(err)
            if not isinstance(result, PermitResult):
                result = PermitResult.reject(f"permit plugin {name} returned {result!r}")
            # Recorded message: success/wait keywords, otherwise the
            # status message (wrappedplugin.go:596-602).
            if result.status == SUCCESS:
                statuses[name] = SUCCESS
                timeouts[name] = go_duration_str(0)
            elif result.status == WAIT:
                # Clamp at the RUN site like upstream RunPermitPlugins
                # (maxTimeout 15 min) — plugins constructing PermitResult
                # directly must not park pods beyond it.
                from ksim_tpu_torch.scheduler.permit import MAX_WAIT_SECONDS

                timeout_s = min(result.timeout_seconds, MAX_WAIT_SECONDS)
                statuses[name] = WAIT
                timeouts[name] = go_duration_str(timeout_s)
                deadlines[name] = _time.monotonic() + timeout_s
                if verdict == SUCCESS:
                    verdict = WAIT
            else:
                statuses[name] = result.message or "rejected by permit plugin"
                timeouts[name] = go_duration_str(0)
                verdict = REJECT
                # Upstream RunPermitPlugins returns on the first non-wait
                # failure — later plugins never run or record.
                break
        return verdict, (statuses, timeouts), deadlines

    def _settle_permit(
        self,
        pod: JSON,
        node_name: str | None,
        verdict: str,
        deadlines: dict[str, float],
        anno: dict[str, str],
        placements: dict,
        plugins: Sequence[ScoredPlugin] = (),
        prof=None,
    ) -> tuple[str | None, bool]:
        """Resolve a permit verdict for a selected pod: WAIT parks it
        (returns (None, True) — caller skips the bind), REJECT clears the
        selection (upstream Unreserve, no PostFilter), SUCCESS binds.
        ``plugins``/``prof`` ride into the parked entry so the
        PreBind/Bind/PostBind chains can run at allow time."""
        if node_name is not None and verdict == WAIT:
            self._park_waiting(
                pod, node_name, deadlines, anno, placements,
                plugins=plugins, prof=prof,
            )
            return None, True
        if node_name is not None and verdict == REJECT:
            return None, False
        return node_name, False

    def _park_waiting(
        self,
        pod: JSON,
        node_name: str,
        deadlines: dict[str, float],
        anno: dict[str, str],
        placements: dict,
        plugins: Sequence[ScoredPlugin] = (),
        prof=None,
    ) -> None:
        """Park a Permit-WAIT pod: no bind, no pod write yet; the waiting
        entry keeps it out of the queue and charges its node in
        featurization until allow/reject/timeout resolves it."""
        key = f"{namespace_of(pod)}/{name_of(pod)}"
        with self._waiting_lock:
            self._waiting[key] = _WaitingPod(
                name=name_of(pod),
                namespace=namespace_of(pod),
                node_name=node_name,
                pending=deadlines,
                anno=anno,
                plugins=tuple(plugins),
                prof=prof,
            )
        placements[key] = node_name
        self._pass_waits += 1
        self.metrics.inc("pods_waiting_on_permit")

    def _assume_waiting(self, pods: list[JSON]) -> list[JSON]:
        """Charge permit-waiting pods to their selected nodes for
        featurization (the upstream assumed-pod cache: a waiting pod's
        resources are visible to every later scheduling decision)."""
        with self._waiting_lock:
            if not self._waiting:
                return pods
            waiting = dict(self._waiting)
        out = []
        for p in pods:
            wp = waiting.get(f"{namespace_of(p)}/{name_of(p)}")
            if wp is None:
                out.append(p)
            else:
                out.append(
                    dict(p, spec=dict(p.get("spec") or {}, nodeName=wp.node_name))
                )
        return out

    def get_waiting_pods(self) -> list[JSON]:
        """Snapshot of permit-waiting pods (upstream Handle.IterateOverWaitingPods)."""
        with self._waiting_lock:
            return [
                {
                    "name": wp.name,
                    "namespace": wp.namespace,
                    "nodeName": wp.node_name,
                    "pendingPlugins": sorted(wp.pending),
                }
                for wp in self._waiting.values()
            ]

    def allow_waiting_pod(
        self, name: str, namespace: str = "default", plugin: str | None = None
    ) -> bool:
        """Allow a waiting pod for ``plugin`` (or all); binds when no
        pending plugin remains (upstream WaitingPod.Allow).  Serialized
        against scheduling passes (_pass_lock): binding mid-pass could
        let the pass's stale snapshot schedule the pod a second time."""
        key = f"{namespace}/{name}"
        with self._pass_lock:
            with self._waiting_lock:
                wp = self._waiting.get(key)
                if wp is None:
                    return False
                if plugin is None:
                    wp.pending.clear()
                else:
                    wp.pending.pop(plugin, None)
                if wp.pending:
                    return True
                del self._waiting[key]
            self._finalize_waiting(wp, bind=True)
        return True

    def reject_waiting_pod(
        self, name: str, namespace: str = "default", message: str = "rejected"
    ) -> bool:
        """Reject a waiting pod (upstream WaitingPod.Reject): unreserve —
        the pod returns to the pending queue as unschedulable."""
        key = f"{namespace}/{name}"
        with self._pass_lock:
            with self._waiting_lock:
                wp = self._waiting.pop(key, None)
            if wp is None:
                return False
            self._finalize_waiting(wp, bind=False, message=message)
        # The rejection write is rv-suppressed; wake the watch loop so
        # the now-pending pod gets a pass without an unrelated event.
        self._poke.set()
        return True

    def _expire_waiting(self) -> int:
        """Reject waiting pods whose any plugin timer fired (upstream: a
        waiting pod is rejected when one pending plugin's timeout ends).
        Returns the number of pods rejected."""
        import time as _time

        now = _time.monotonic()
        with self._pass_lock:
            expired: list[_WaitingPod] = []
            with self._waiting_lock:
                for key, wp in list(self._waiting.items()):
                    if any(dl <= now for dl in wp.pending.values()):
                        expired.append(wp)
                        del self._waiting[key]
            for wp in expired:
                self._finalize_waiting(
                    wp, bind=False, message="pod rejected: permit wait timed out"
                )
        return len(expired)

    def _finalize_waiting(
        self, wp: _WaitingPod, *, bind: bool, message: str = ""
    ) -> None:
        from ksim_tpu_torch.engine.annotations import (
            BIND_RESULT_KEY,
            PRE_BIND_RESULT_KEY,
            _marshal,
        )
        from ksim_tpu_torch.errors import NotFoundError

        if bind:
            # The assumed node may have been deleted while the pod waited
            # — upstream's Bind would fail and unreserve; do the same.
            try:
                self._store.get("nodes", wp.node_name)
            except NotFoundError:
                bind = False
                message = f"node {wp.node_name} deleted while waiting on permit"

        anno = dict(wp.anno)
        chains_recorded = False
        # The real pod object for the hook chains (both the bind-time
        # PreBind/Bind run and any failure path's Unreserve — hooks key
        # reservations on uid/spec, not just the name).
        pod_obj = {"metadata": {"name": wp.name, "namespace": wp.namespace}}
        try:
            pod_obj = self._store.get("pods", wp.name, wp.namespace)
        except NotFoundError:
            pass
        if bind and wp.plugins:
            # The PreBind/Bind chains run now (upstream: after
            # WaitOnPermit returns success), with the pass's plugin set.
            import json as _json

            prebind_extra, prebind_failed = self._run_pre_bind(
                wp.plugins, pod_obj, wp.node_name
            )
            if prebind_failed:
                bind = False
                message = "prebind failed: " + next(
                    (v for v in reversed(list(prebind_extra.values()))), ""
                )
            bind_map = {} if prebind_failed else None
            if bind:
                bind_map, bind_ok = self._run_bind(
                    wp.plugins, pod_obj, wp.node_name, prof=wp.prof
                )
                if not bind_ok:
                    bind = False
                    message = "bind failed: " + ", ".join(bind_map.values())
            if anno:
                # The chains RAN — their results (including failure
                # messages, wrappedplugin.go AddBindResult) are the
                # record; the rejected-waiter reset below must not wipe
                # them (the inline _bind_results path keeps them too).
                chains_recorded = True
                if prebind_extra and anno.get(PRE_BIND_RESULT_KEY):
                    merged = _json.loads(anno[PRE_BIND_RESULT_KEY])
                    merged.update(prebind_extra)
                    anno[PRE_BIND_RESULT_KEY] = _marshal(merged)
                if bind_map is not None:
                    anno[BIND_RESULT_KEY] = _marshal(bind_map)
        if not bind and anno and not chains_recorded:
            # Bind/PreBind never ran for a rejected waiter.
            anno[BIND_RESULT_KEY] = _marshal({})
            anno[PRE_BIND_RESULT_KEY] = _marshal({})
        if not bind and wp.plugins:
            # Any post-Reserve failure unreserves (upstream Unreserve on
            # permit rejection/timeout and bind failures alike).
            self._run_unreserve(wp.plugins, pod_obj, wp.node_name)

        def rebuild(obj: JSON) -> JSON:
            new = dict(obj)
            md = dict(obj.get("metadata") or {})
            annos = dict(md.get("annotations") or {})
            if anno:
                apply_results_to_pod(annos, anno)
            md["annotations"] = annos
            new["metadata"] = md
            if bind:
                new["spec"] = dict(obj.get("spec") or {}, nodeName=wp.node_name)
                status = dict(obj.get("status") or {}, phase="Running")
                status.pop("nominatedNodeName", None)
                new["status"] = status
            return new

        try:
            updated = self._store.rewrap("pods", wp.name, wp.namespace, rebuild)
        except NotFoundError:
            return  # deleted while waiting
        # Suppress our own write either way: an unsuppressed rejection
        # event would hit _relevant's backoff-clearing branch and erase
        # the backoff recorded below (undamped retry hot loop); the
        # retry pass comes from the explicit _poke instead.
        with self._own_rvs_lock:
            self._own_rvs.add(updated["metadata"]["resourceVersion"])
        if bind:
            self.metrics.inc("pods_scheduled")
            if wp.plugins:
                self._run_post_bind(wp.plugins, updated, wp.node_name)
        else:
            logger.info("permit: pod %s/%s rejected: %s", wp.namespace, wp.name, message)
            key = f"{wp.namespace}/{wp.name}"
            with self._backoff_lock:
                attempts = self._backoff.get(key, (0, 0))[0] + 1
                delay = min(2 ** (attempts - 1), self.MAX_BACKOFF_PASSES)
                self._backoff[key] = (attempts, self._pass_count + delay)
            self.metrics.inc("pods_permit_rejected")

    def _attempt_preemption(self, pod, feats, plugins, res, j):
        """DefaultPreemption for one unschedulable pod (PostFilter).
        Returns (nominated_node, victims, postfilter_annotation_map)."""
        from ksim_tpu_torch.scheduler import preemption as pre

        n_valid = feats.nodes.count
        failed_nodes = feats.nodes.names[:n_valid]
        live_mask = None
        if res.reason_bits is not None:
            mask = self._resolvable_mask(plugins, res.reason_bits[j], n_valid)
            if not mask.any():
                return None, [], pre.render_postfilter_result(failed_nodes, None)
            # feats node order == store list order at featurize time; nodes
            # may have changed since — map the mask by name.
            mask_by_name = {
                feats.nodes.names[i]: bool(mask[i]) for i in range(n_valid)
            }
        # Preemption dry-runs against the LIVE store (upstream uses the
        # live cache in PostFilter) — earlier preemptions in this pass
        # already removed their victims.
        nodes = self._store.list("nodes", copy_objs=False)
        cluster_pods = self._store.list("pods", copy_objs=False)
        namespaces = self._store.list("namespaces", copy_objs=False)
        volumes = dict(
            pvs=self._store.list("persistentvolumes", copy_objs=False),
            pvcs=self._store.list("persistentvolumeclaims", copy_objs=False),
            storage_classes=self._store.list("storageclasses", copy_objs=False),
        )
        if res.reason_bits is not None:
            live_mask = [mask_by_name.get(name_of(n), False) for n in nodes]
        decision = pre.find_preemption(
            pod, nodes, cluster_pods, candidate_mask=live_mask,
            namespaces=namespaces, volumes=volumes,
            priority_of=self._priority_of,
        )
        post = pre.render_postfilter_result(failed_nodes, decision.nominated_node)
        return decision.nominated_node, decision.victims, post

    @staticmethod
    def _resolvable_mask(plugins, bits, n_valid):
        """bool [N]: nodes whose FIRST failing filter plugin (upstream
        Filter chains stop there) reports a preemption-resolvable failure."""
        import numpy as np

        filter_plugins = [sp for sp in plugins if sp.filter_enabled]
        failing = bits != 0  # [F, N]
        fail_any = failing.any(axis=0)
        first = np.argmax(failing, axis=0)
        mask = np.zeros(bits.shape[1], dtype=bool)
        for fi, sp in enumerate(filter_plugins):
            sel = fail_any & (first == fi)
            if not sel.any():
                continue
            rule = getattr(sp.plugin, "failure_unresolvable", None)
            if rule is None:
                continue  # unknown plugin: conservatively unresolvable
            resolvable = {
                int(b): not rule(int(b)) for b in np.unique(bits[fi, sel])
            }
            mask[sel] = [resolvable[int(b)] for b in bits[fi, sel]]
        mask[n_valid:] = False
        return mask

    # -- watch loop ---------------------------------------------------------

    def start(self) -> "SchedulerService":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: "float | None" = 5.0) -> None:
        """Stop the watch loop.  ``timeout=None`` joins indefinitely.  A
        thread that outlives a finite timeout (likely parked in an XLA
        compile; it notices _stop on return) is KEPT on self._thread so a
        later stop() can join it for real — exiting the process with it
        alive risks heap corruption during runtime teardown."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                logger.warning(
                    "scheduler loop still busy after %.0fs; call "
                    "stop(timeout=None) before process exit", timeout or 0
                )
            else:
                self._thread = None

    # Kinds whose changes can make a pending pod schedulable.
    WATCH_KINDS = (
        "pods",
        "nodes",
        "persistentvolumes",
        "persistentvolumeclaims",
        "storageclasses",
    )

    def _relevant(self, ev: WatchEvent) -> bool:
        if ev.kind == "nodes":
            self.flush_backoff()  # topology changed: retry everything
            return True
        if ev.kind in ("persistentvolumes", "persistentvolumeclaims", "storageclasses"):
            # Volume objects gate VolumeBinding/Zone/Limits: retry
            # (upstream requeues on PV/PVC events via QueueingHints).
            self.flush_backoff()
            return True
        if ev.kind != "pods":
            return False
        rv = ev.obj.get("metadata", {}).get("resourceVersion")
        with self._own_rvs_lock:
            if rv in self._own_rvs:
                self._own_rvs.discard(rv)
                return False
        self._flush_extender_results(ev)
        from ksim_tpu_torch.state.cluster import DELETED

        # Drop the pod's backoff either way: a user-driven create/update
        # (self-writes were filtered above) may have made THIS pod
        # schedulable — e.g. editing its requests through the UI — and a
        # deleted pod's entry is garbage (upstream Pod-event QueueingHints
        # move the pod out of the unschedulable pool immediately).
        key = f"{namespace_of(ev.obj)}/{name_of(ev.obj)}"
        with self._backoff_lock:
            self._backoff.pop(key, None)
        if ev.event_type == DELETED:
            # A deleted permit-waiter's entry must die with it — a stale
            # entry would block a re-created same-name pod and write the
            # old pod's annotations onto it at timer expiry.
            with self._waiting_lock:
                self._waiting.pop(key, None)
            self.flush_backoff()  # capacity freed: retry everything
        # A delete frees capacity; an add/update may need scheduling.
        return True

    def _run(self) -> None:  # ksimlint: thread-role(service-loop)
        stream = self._store.watch(self.WATCH_KINDS)
        try:
            try:
                self.schedule_pending()
            except Exception:  # pragma: no cover - keep the loop alive
                # An initial-pass failure (fault injection found an
                # unprotected call here) must not kill the loop: the
                # periodic idle pass retries pending pods.
                logger.exception("initial scheduling pass failed")
            idle_ticks = 0
            while not self._stop.is_set():
                ev = stream.next(timeout=0.1)
                if ev is None:
                    # Idle tick: permit-wait timers fire here, poked
                    # rejections (whose rv-suppressed MODIFIED events the
                    # loop never sees) get their retry pass, and — because
                    # backoff is measured in PASSES — an idle cluster
                    # still advances backed-off pending pods with a
                    # periodic pass (~1s cadence; an empty eligible queue
                    # makes the pass nearly free), the analogue of
                    # upstream's wall-clock backoff queue draining on
                    # timers rather than on cluster events.
                    poked = self._poke.is_set()
                    if poked:
                        self._poke.clear()
                    idle_ticks += 1
                    periodic = idle_ticks >= 10 and self.pending_count() > 0
                    if self._expire_waiting() or poked or periodic:
                        idle_ticks = 0
                        try:
                            self.schedule_pending()
                        except Exception:  # pragma: no cover
                            logger.exception("scheduling pass failed")
                    continue
                idle_ticks = 0
                if not self._relevant(ev):
                    continue
                # Drain whatever queued behind this event before one pass.
                while True:
                    nxt = stream.next(timeout=0.02)
                    if nxt is None:
                        break
                    self._relevant(nxt)
                try:
                    self.schedule_pending()
                except Exception:  # pragma: no cover - keep the loop alive
                    logger.exception("scheduling pass failed")
        finally:
            stream.close()

    def _flush_extender_results(self, ev: WatchEvent) -> None:
        """Reflector behavior for proxy-driven EXTERNAL schedulers
        (reference storereflector.go:78-146 merges extender stores onto
        the pod on update events): the in-process path flushes
        synchronously, so anything left here came through the HTTP proxy
        routes."""
        if not self._extenders:
            return
        from ksim_tpu_torch.state.cluster import DELETED

        pod = ev.obj
        if ev.event_type == DELETED:
            self._extenders.store.delete_data(pod)
            return
        anno = self._extenders.store.get_stored_result(pod)
        if not anno:
            return
        from ksim_tpu_torch.errors import ConflictError, NotFoundError
        from ksim_tpu_torch.util import retry_with_exponential_backoff

        try:
            # Conflict-retried like the reference's reflector writes
            # (storereflector.go:124-136 + util/retry.go).  Scoped to
            # ConflictError only: ClusterStore.patch is an atomic RMW so
            # conflicts can't actually occur in-process, and a NotFound
            # (pod deleted meanwhile) must drop straight through instead
            # of stalling the watch loop through the backoff sleeps.
            updated = retry_with_exponential_backoff(
                lambda: self._store.patch(
                    "pods",
                    name_of(pod),
                    namespace_of(pod),
                    lambda obj: obj.setdefault("metadata", {})
                    .setdefault("annotations", {})
                    .update(anno),
                ),
                retriable=(ConflictError,),
            )
        except NotFoundError:
            self._extenders.store.delete_data(pod)
            return
        except Exception:
            logger.exception("failed to flush extender results")
            return
        with self._own_rvs_lock:
            self._own_rvs.add(updated["metadata"]["resourceVersion"])
        self._extenders.store.delete_data(pod)
