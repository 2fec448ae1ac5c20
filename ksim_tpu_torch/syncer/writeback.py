"""Live-cluster write-back: the store reflector's apiserver side.

The reference's headline SDK promise is running the debuggable scheduler
against a REAL cluster: its scheduler binds live pods through a clientset
and the store reflector writes every recorded result back onto them as
annotations (reference simulator/docs/debuggable-scheduler.md:64,
pkg/debuggablescheduler/debuggable_scheduler.go:157-173,
scheduler/storereflector/storereflector.go:78-146).

The port schedules a live cluster by composition: ``Syncer`` mirrors the
apiserver into the in-memory store, ``SchedulerService`` schedules the
mirror (in-store binds give the engine its sequential-commit semantics),
and this module closes the loop — it subscribes to the STORE's watch
stream (the same signal the reference's reflector takes from its pod
informer) and pushes each scheduling outcome to the apiserver:

- a pod that gained ``spec.nodeName`` is bound live via the binding
  subresource (POST .../binding — upstream DefaultBinder's verb; 409
  means someone else bound it first and is treated as settled);
- recorded result annotations (the ``kube-scheduler-simulator.sigs.k8s.io/``
  keys, including on UNSCHEDULABLE pods) are merge-patched onto the live
  pod with bounded conflict retry.

Termination is structural: the syncer's mandatory pod filter never
mirrors updates to already-scheduled live pods (syncer.py _filter_pod,
reference resource.go:103-123), so the authoritative MODIFIED our own
writes produce cannot re-enter the store and re-trigger a push; a
last-pushed cache additionally dedupes annotation-only churn.

Opt-in: writing to a user's cluster is a side effect the simulator must
never produce implicitly — gate on ``KSIM_ALLOW_LIVE_WRITEBACK=1`` (the
same pattern as exec credential plugins), or construct LiveWriteBack
explicitly in library use.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from ksim_tpu_torch.faults import FAULTS
from ksim_tpu_torch.obs import TRACE
from ksim_tpu_torch.state.cluster import ADDED, DELETED, MODIFIED, ClusterStore
from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of
from ksim_tpu_torch.syncer.kubeapi import KubeApiError, KubeApiSource

logger = logging.getLogger(__name__)

RESULT_PREFIX = "kube-scheduler-simulator.sigs.k8s.io/"


def _pod_key(pod: JSON) -> str:
    return f"{namespace_of(pod) or 'default'}/{name_of(pod)}"


def _source_uid(pod: JSON) -> str:
    """The pod's LIVE cluster UID, recorded by the syncer at mirror time
    (syncer.SOURCE_UID_ANNOTATION — the mandatory mutators strip
    metadata.uid, so the store's own uid never matches the live one).
    Empty for store-local pods that never existed live."""
    from ksim_tpu_torch.syncer.syncer import SOURCE_UID_ANNOTATION

    ann = pod.get("metadata", {}).get("annotations") or {}
    return ann.get(SOURCE_UID_ANNOTATION) or ""


def writeback_enabled() -> bool:
    return os.environ.get("KSIM_ALLOW_LIVE_WRITEBACK", "") == "1"


class LiveWriteBack:
    """Mirror scheduling outcomes from ``store`` onto the live cluster
    behind ``source``.  One daemon thread; errors are logged and never
    propagate into the scheduling loop (the reference's reflector
    likewise only logs, storereflector.go:139-142)."""

    #: transient-failure retry policy: a bind/patch that dies on a
    #: non-404/409 error (apiserver blip) re-runs up to this many times
    #: with linear backoff — without it the write would be lost forever,
    #: because the syncer never re-mirrors scheduled pods (no future
    #: store event retriggers the push) and the store would silently
    #: diverge from the live cluster.
    RETRY_ATTEMPTS = 5
    RETRY_DELAY_S = 2.0
    #: parking delay for a DELETED event that arrives before its
    #: eviction mark (note_eviction runs after the store delete returns,
    #: so the event can race ahead by a few µs).
    RECHECK_DELAY_S = 0.2

    def __init__(self, source: KubeApiSource, store: ClusterStore) -> None:
        self._source = source
        self._store = store
        self._stream = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # ns/name -> node already bound live; ns/name -> last annotation
        # set pushed (the sorted item tuple itself — equality comparison,
        # no hash fingerprint whose collision would silently skip a
        # push); ns/name set that 404ed (local-only pods — logged once,
        # then ignored).
        self._bound: dict[str, str] = {}
        self._pushed: dict[str, tuple] = {}
        self._missing: set[str] = set()
        # ns/name keys whose store delete is a PREEMPTION EVICTION
        # (note_eviction, fed by SchedulerService.add_eviction_listener).
        # Only these propagate as live deletes: a reset or a user delete
        # through the simulator API must never remove real workloads.
        # Keys stay until the live delete succeeds, so a transient
        # failure's retry still knows to evict.
        self._evictions: set[str] = set()
        # ns/name keys another scheduler bound to a DIFFERENT node than
        # the store says (the 409-reconcile outcome): later MODIFIED
        # events for them must not re-attempt the guaranteed-409 bind.
        self._diverged: set[str] = set()
        # (due_monotonic, etype, pod, attempt) pending transient retries.
        self._retries: list[tuple[float, str, JSON, int]] = []

    def note_eviction(self, namespace: str, name: str) -> None:
        """Mark the next store delete of this pod as a preemption
        eviction (wire via SchedulerService.add_eviction_listener)."""
        self._evictions.add(f"{namespace or 'default'}/{name}")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "LiveWriteBack":
        # list_first replays current pods as ADDED — _handle uses the
        # replay to SEED the bound/pushed caches (state that predates us
        # is treated as settled; only MODIFIED events write).
        self._stream = self._store.watch(("pods",), list_first=("pods",))
        self._thread = threading.Thread(
            target=self._run, name="live-writeback", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._stream is not None:
            self._stream.close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- event loop ----------------------------------------------------------

    def _run(self) -> None:  # ksimlint: thread-role(service-loop)
        try:
            while not self._stop.is_set():
                try:
                    event = self._stream.next(timeout=0.5)
                except Exception:
                    if not self._stop.is_set():
                        logger.exception("write-back watch failed; stopping")
                    return
                if event is not None:
                    self._dispatch(event.event_type, event.obj, attempt=0)
                # Due transient retries.
                if self._retries:
                    now = time.monotonic()
                    due = [r for r in self._retries if r[0] <= now]
                    self._retries = [r for r in self._retries if r[0] > now]
                    for _t, etype, pod, attempt in due:
                        self._dispatch(etype, pod, attempt=attempt)
        finally:
            # Exit (stop or watch failure) must not strand eviction
            # work — a marked eviction would otherwise never delete the
            # live victim (the overcommit this machinery exists to
            # prevent).  Two places can hold it: the stream queue
            # (events enqueued but not yet dispatched; close() only
            # stops NEW deliveries — already-enqueued events stay
            # readable, which is what makes this drain possible) and
            # the DELETED-recheck parking list.  Both drain with
            # final-attempt semantics (a failure logs PERMANENTLY
            # failed rather than re-queueing).  Events whose eviction
            # mark hasn't landed yet (a preemption mid-flight at stop
            # time: store delete done, note_eviction pending) get one
            # grace sleep before the final dispatch so the mark can
            # arrive.
            work: list[JSON] = []
            dropped: list[str] = []
            while True:
                try:
                    event = self._stream.next(timeout=0)
                except Exception:
                    break
                if event is None:
                    break
                if event.event_type == DELETED:
                    work.append(event.obj)
                elif event.event_type == MODIFIED:
                    dropped.append(f"queued {event.event_type} {_pod_key(event.obj)}")
            pending, self._retries = self._retries, []
            work.extend(pod for _t, et, pod, _a in pending if et == DELETED)
            dropped.extend(
                f"pending {et} retry (attempt {a}) {_pod_key(pod)}"
                for _t, et, pod, a in pending
                if et != DELETED
            )
            if dropped:
                # Only eviction (DELETED) work drains with final-attempt
                # semantics; everything else dies with the thread, and the
                # live cluster silently diverges from the store for those
                # pods — say which ones, so the operator can reconcile.
                logger.warning(
                    "write-back exiting with %d undelivered non-eviction "
                    "update(s) dropped (store/live divergence for these "
                    "pods): %s",
                    len(dropped),
                    "; ".join(dropped[:20])
                    + ("; ..." if len(dropped) > 20 else ""),
                )
            if any(_pod_key(p) not in self._evictions for p in work):
                # Bounded regardless of RECHECK_DELAY_S tuning: the
                # mark race is microseconds-scale, and stop()'s 5s
                # thread join must outlive this sleep plus the final
                # dispatches.
                time.sleep(min(self.RECHECK_DELAY_S + 0.05, 1.0))
            for pod in work:
                self._dispatch(DELETED, pod, attempt=self.RETRY_ATTEMPTS - 1)

    def _dispatch(self, etype: str, pod: JSON, *, attempt: int) -> None:
        if etype == DELETED and attempt == 0:
            key = _pod_key(pod)
            if key not in self._evictions:
                # Eviction marks are set right AFTER the store delete
                # returns, so a DELETED event can race a few µs ahead of
                # its mark.  One short recheck before treating it as a
                # plain (never-propagated) delete; a genuinely plain
                # delete just no-ops twice.
                self._retries.append(
                    (time.monotonic() + self.RECHECK_DELAY_S, DELETED, pod, 1)
                )
                return
        if attempt > 0 and etype != DELETED:
            # Retry with the pod's CURRENT store state, not the snapshot
            # captured at failure time — a newer pass may have pushed
            # fresher annotations in between, and replaying the stale
            # snapshot would overwrite them live and poison _pushed.
            from ksim_tpu_torch.errors import SimulatorError

            try:
                pod = self._store.get(
                    "pods", name_of(pod), namespace_of(pod) or "default"
                )
            except SimulatorError:
                return  # gone from the store: nothing left to push
        try:
            self._handle(etype, pod)
        except Exception:
            if attempt + 1 < self.RETRY_ATTEMPTS and not self._stop.is_set():
                logger.warning(
                    "write-back failed for pod %s (attempt %d/%d); will retry",
                    name_of(pod), attempt + 1, self.RETRY_ATTEMPTS,
                    exc_info=True,
                )
                self._retries.append(
                    (
                        time.monotonic() + self.RETRY_DELAY_S * (attempt + 1),
                        etype,
                        pod,
                        attempt + 1,
                    )
                )
            else:
                logger.exception(
                    "write-back PERMANENTLY failed for pod %s — the live "
                    "cluster now diverges from the store for this pod",
                    name_of(pod),
                )

    def _handle(self, etype: str, pod: JSON) -> None:
        with TRACE.span("writeback.push", etype=etype):
            self._handle_traced(etype, pod)

    def _handle_traced(self, etype: str, pod: JSON) -> None:
        # Fault-plane site: an injected failure here exercises the
        # transient-retry policy above exactly like an apiserver blip.
        FAULTS.check("writeback.push")
        ns = namespace_of(pod) or "default"
        key = _pod_key(pod)
        if etype == DELETED:
            self._bound.pop(key, None)
            self._pushed.pop(key, None)
            self._missing.discard(key)
            self._diverged.discard(key)
            if key in self._evictions:
                # A preemption victim (note_eviction provenance) must be
                # evicted live too — without it the node would carry both
                # the victim and the preemptor (overcommit).  Any OTHER
                # store delete (reset, user delete through the simulator
                # API) never touches the real cluster.  The key leaves
                # the set only on success/404/409, so a transient
                # failure's retry still evicts.  The victim's UID from
                # the store event rides as a delete precondition
                # (kubeapi.delete_pod): a same-name pod RECREATED live
                # since this event answers 409 and survives — closing
                # the delete-the-wrong-pod window the reference guards
                # with the same precondition (storereflector.go:94-96).
                try:
                    self._source.delete_pod(ns, name_of(pod), uid=_source_uid(pod))
                    logger.info("evicted live pod %s (preemption)", key)
                except KubeApiError as e:
                    if e.code == 409:
                        logger.warning(
                            "live pod %s has a different UID than the "
                            "evicted victim (recreated since); leaving it",
                            key,
                        )
                    elif e.code != 404:
                        raise
                self._evictions.discard(key)
            return
        if etype not in (ADDED, MODIFIED) or key in self._missing:
            return
        node = pod.get("spec", {}).get("nodeName") or ""
        ann = {
            k: v
            for k, v in (pod.get("metadata", {}).get("annotations") or {}).items()
            if k.startswith(RESULT_PREFIX)
        }
        if etype == ADDED:
            # ADDED events are state that predates us: the startup
            # list_first replay, or the syncer mirroring a live pod that
            # is ALREADY bound/annotated.  Seed the caches instead of
            # writing — a restart against a 5000-pod cluster must not
            # fire 5000 guaranteed-409 binds and identity patches.  Our
            # own scheduling outcomes always arrive as MODIFIED (the
            # reference reflector likewise reacts to pod UPDATE events
            # only, storereflector.go:78-80).
            if node:
                self._bound[key] = node
            if ann:
                self._pushed[key] = tuple(sorted(ann.items()))
            return
        if not node and not ann:
            return
        try:
            if node and key in self._diverged:
                return  # settled on another scheduler's node; stop pushing
            if node and self._bound.get(key) != node:
                try:
                    self._source.bind_pod(ns, name_of(pod), node)
                except KubeApiError as e:
                    if e.code != 409:
                        raise
                    # Another scheduler bound it first (or a previous
                    # life of this process did).  Learn the REAL node —
                    # pushing result annotations that name OUR node onto
                    # a pod running elsewhere would be authoritative-
                    # looking misinformation.
                    live = self._source.get_pod(ns, name_of(pod))
                    live_uid = live.get("metadata", {}).get("uid") or ""
                    our_uid = _source_uid(pod)
                    if live_uid and our_uid and live_uid != our_uid:
                        # Same name, DIFFERENT pod: the live one was
                        # recreated since our store mirrored it.  Its
                        # node is meaningless for us, and writing our
                        # result annotations onto it would label a
                        # stranger — stop pushing for this key.
                        logger.warning(
                            "live pod %s has UID %s, store has %s "
                            "(recreated); skipping write-back",
                            key, live_uid, our_uid,
                        )
                        self._diverged.add(key)
                        return
                    real = live.get("spec", {}).get("nodeName") or ""
                    self._bound[key] = real
                    if real != node:
                        logger.warning(
                            "pod %s bound live to %s, not our %s; "
                            "skipping result annotations",
                            key, real or "<none>", node,
                        )
                        self._diverged.add(key)
                        return
                self._bound[key] = node
            if ann:
                fp = tuple(sorted(ann.items()))
                if self._pushed.get(key) != fp:
                    self._source.patch_pod_annotations(ns, name_of(pod), ann)
                    self._pushed[key] = fp
        except KubeApiError as e:
            if e.code == 404:
                # Local-only pod (created through the simulator API, not
                # present on the live cluster): nothing to write back.
                logger.info("pod %s not on the live cluster; skipping", key)
                self._missing.add(key)
            else:
                raise
