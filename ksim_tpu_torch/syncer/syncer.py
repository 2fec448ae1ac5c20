"""Continuous cluster-resource mirroring (reference simulator/syncer/).

Semantics preserved from the reference:

- **Sync order matters on first import**: namespaces -> priorityclasses ->
  storageclasses -> pvcs -> nodes -> pvs -> pods (reference
  resource.go:18-26 DefaultGVRs, "this order matters").
- **Mandatory mutators** (users cannot opt out, resource.go:37-41):
  every resource loses uid/resourceVersion/generation before import
  (syncer.go:174-181 removeUnnecessaryMetadata); pods additionally lose
  serviceAccountName and ownerReferences (resource.go:83-99 mutatePods);
  a Bound PV's claimRef UID is re-resolved against the DESTINATION's PVC
  (resource.go:56-81 mutatePV).
- **Mandatory filters** (resource.go:44-47): pod UPDATE events for
  already-scheduled pods are never mirrored (resource.go:103-123
  filterPods) — the simulator's scheduler owns binding.
- **User extension**: additional mutating/filtering functions per kind
  (syncer.go Options), called after the mandatory set.
- NotFound on update/delete is tolerated (syncer.go:244-269 — the
  scheduler may have preempted the pod, or a user deleted it).
"""

from __future__ import annotations

import copy
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Protocol

from ksim_tpu_torch.errors import NotFoundError, SimulatorError
from ksim_tpu_torch.state.cluster import ADDED, DELETED, MODIFIED, ClusterStore
from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of

logger = logging.getLogger(__name__)

# Sync order (reference resource.go:18-26).
DEFAULT_KINDS = (
    "namespaces",
    "priorityclasses",
    "storageclasses",
    "persistentvolumeclaims",
    "nodes",
    "persistentvolumes",
    "pods",
)

# Event kinds passed to mutators/filters (reference resource.go Event).
ADD = "add"
UPDATE = "update"

# fn(resource, dest_store, event) -> resource | None
MutatingFunction = Callable[[JSON, ClusterStore, str], JSON]
# fn(resource, dest_store, event) -> bool (False = skip)
FilteringFunction = Callable[[JSON, ClusterStore, str], bool]


class SourceCluster(Protocol):
    """What the syncer needs from a source: ClusterStore's list/watch."""

    def list(self, kind: str, namespace: str = "") -> list[JSON]: ...

    def watch(self, kinds: tuple[str, ...] = ...) -> object: ...


@dataclass
class SyncerOptions:
    kinds: tuple[str, ...] | None = None
    additional_mutating: dict[str, MutatingFunction] = field(default_factory=dict)
    additional_filtering: dict[str, FilteringFunction] = field(default_factory=dict)


# Mirrored pods remember their LIVE cluster UID here (the mandatory
# mutators strip metadata.uid, and the store then assigns its own): the
# write-back's eviction DELETE sends it as a precondition so a same-name
# pod recreated live since the mirror is never the one deleted
# (kubeapi.delete_pod; reference storereflector.go:94-96 — the
# reference's store keeps the live UID, ours records it out-of-band).
# Deliberately NOT under the result-annotation prefix: result keys are
# what the write-back pushes onto live pods.
SOURCE_UID_ANNOTATION = "ksim-tpu/source-uid"


def _strip_metadata(obj: JSON) -> JSON:
    """removeUnnecessaryMetadata (syncer.go:174-181)."""
    obj = dict(obj)
    md = dict(obj.get("metadata") or {})
    for k in ("uid", "resourceVersion", "generation", "managedFields"):
        md.pop(k, None)
    obj["metadata"] = md
    return obj


def _mutate_pod(obj: JSON, dest: ClusterStore, event: str) -> JSON:
    obj = dict(obj)
    spec = dict(obj.get("spec") or {})
    spec.pop("serviceAccountName", None)
    spec.pop("serviceAccount", None)
    obj["spec"] = spec
    md = dict(obj.get("metadata") or {})
    md.pop("ownerReferences", None)
    obj["metadata"] = md
    return obj


def _mutate_pv(obj: JSON, dest: ClusterStore, event: str) -> JSON:
    if (obj.get("status") or {}).get("phase") != "Bound":
        return obj
    ref = (obj.get("spec") or {}).get("claimRef")
    if not ref or not ref.get("name"):
        return obj
    try:
        pvc = dest.get(
            "persistentvolumeclaims", ref["name"], ref.get("namespace", "default")
        )
        uid = pvc["metadata"].get("uid")
    except SimulatorError:
        uid = None
    obj = dict(obj)
    spec = dict(obj.get("spec") or {})
    spec["claimRef"] = {**ref, "uid": uid}
    obj["spec"] = spec
    return obj


def _filter_pod(obj: JSON, dest: ClusterStore, event: str) -> bool:
    if event == ADD:
        return True
    # Never mirror updates to already-scheduled pods (resource.go:103-123).
    return not obj.get("spec", {}).get("nodeName")


_MANDATORY_MUTATING: dict[str, MutatingFunction] = {
    "pods": _mutate_pod,
    "persistentvolumes": _mutate_pv,
}
_MANDATORY_FILTERING: dict[str, FilteringFunction] = {
    "pods": _filter_pod,
}


class Syncer:
    """Mirror a source cluster's resources into the destination store."""

    def __init__(
        self,
        source: SourceCluster,
        dest: ClusterStore,
        options: SyncerOptions | None = None,
    ) -> None:
        options = options or SyncerOptions()
        self._source = source
        self._dest = dest
        self._kinds = tuple(options.kinds or DEFAULT_KINDS)
        self._mutating: dict[str, list[MutatingFunction]] = {}
        self._filtering: dict[str, list[FilteringFunction]] = {}
        for kind, fn in _MANDATORY_MUTATING.items():
            self._mutating.setdefault(kind, []).append(fn)
        for kind, fn in options.additional_mutating.items():
            self._mutating.setdefault(kind, []).append(fn)
        for kind, fn in _MANDATORY_FILTERING.items():
            self._filtering.setdefault(kind, []).append(fn)
        for kind, fn in options.additional_filtering.items():
            self._filtering.setdefault(kind, []).append(fn)
        # Kinds with USER extension functions get a private deep copy per
        # event in _prepare (see there).
        self._user_touched: dict[str, bool] = {}
        for kind in (*options.additional_mutating, *options.additional_filtering):
            self._user_touched[kind] = True
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- one object ---------------------------------------------------------

    def _prepare(self, kind: str, obj: JSON, event: str) -> JSON | None:
        # Watch events share the SOURCE store's frozen dicts
        # (cluster.py _notify); USER filtering/mutating functions are
        # allowed to mutate what they receive, so give them a private
        # deep copy — corrupting the source store would also poison its
        # per-object featurization memos (state/objcache.py).  The
        # mandatory built-in fns are copy-on-write, so no copy is needed
        # when no user extension is registered for this kind.
        if self._user_touched.get(kind):
            obj = copy.deepcopy(obj)
        for fn in self._filtering.get(kind, ()):
            if not fn(obj, self._dest, event):
                return None
        src_uid = obj.get("metadata", {}).get("uid") if kind == "pods" else None
        obj = _strip_metadata(obj)
        for fn in self._mutating.get(kind, ()):
            obj = fn(obj, self._dest, event)
        if src_uid:
            md = obj["metadata"] = dict(obj.get("metadata") or {})
            md["annotations"] = dict(
                md.get("annotations") or {}, **{SOURCE_UID_ANNOTATION: src_uid}
            )
        return obj

    def _create(self, kind: str, obj: JSON) -> None:
        prepared = self._prepare(kind, obj, ADD)
        if prepared is None:
            return
        try:
            self._dest.apply(kind, prepared)
        except SimulatorError:
            logger.exception("failed to sync create %s/%s", kind, name_of(obj))

    def _update(self, kind: str, obj: JSON) -> None:
        prepared = self._prepare(kind, obj, UPDATE)
        if prepared is None:
            return
        try:
            self._dest.update(kind, prepared)
        except NotFoundError:
            # Tolerated: the scheduler may have preempted it, or a user
            # deleted it for debugging (syncer.go:244-250).
            logger.info("skip update of missing %s/%s", kind, name_of(obj))
        except SimulatorError:
            logger.exception("failed to sync update %s/%s", kind, name_of(obj))

    def _delete(self, kind: str, obj: JSON) -> None:
        try:
            self._dest.delete(kind, name_of(obj), namespace_of(obj))
        except NotFoundError:
            logger.info("skip delete of missing %s/%s", kind, name_of(obj))
        except SimulatorError:
            logger.exception("failed to sync delete %s/%s", kind, name_of(obj))

    # -- run ----------------------------------------------------------------

    def sync_once(self) -> None:
        """Initial LIST import in dependency order (the informer cache
        sync the reference does per-GVR before watching)."""
        for kind in self._kinds:
            for obj in self._source.list(kind):
                self._create(kind, obj)

    def run(self) -> "Syncer":
        """sync_once, then mirror watch events until stop()."""
        # Subscribe BEFORE listing so nothing between list and watch is
        # lost; duplicate ADDED events collapse through apply().
        stream = self._source.watch(self._kinds)
        try:
            self.sync_once()
        except BaseException:
            # A network-backed source's initial LIST can fail; the stream
            # already started reader threads that must not outlive us.
            stream.close()
            raise
        self._stop.clear()

        def loop() -> None:  # ksimlint: thread-role(service-loop)
            try:
                while not self._stop.is_set():
                    ev = stream.next(timeout=0.1)
                    if ev is None:
                        continue
                    if ev.event_type == ADDED:
                        self._create(ev.kind, ev.obj)
                    elif ev.event_type == MODIFIED:
                        self._update(ev.kind, ev.obj)
                    elif ev.event_type == DELETED:
                        self._delete(ev.kind, ev.obj)
            finally:
                stream.close()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
