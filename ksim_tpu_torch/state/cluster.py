"""In-memory watchable cluster store.

Replaces the reference's KWOK kube-apiserver + etcd pair (reference
compose.yml `simulator-cluster`, kwok.yaml) for library and server use: a
versioned object store for the 7 simulated resource kinds with
list/watch semantics (the reference's client-go RetryWatcher + SSE pipeline,
simulator/resourcewatcher/resourcewatcher.go:61-120, consumes exactly this
event shape), optimistic-concurrency updates (resourceVersion), and
snapshot/restore used by the reset service (reference
simulator/reset/reset.go:33-85 snapshots the etcd prefix the same way).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import copy
import itertools
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

from ksim_tpu_torch.errors import ConflictError, ExpiredError, NotFoundError
from ksim_tpu_torch.obs import TRACE
from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of

# Kind names follow the reference's watcher kinds
# (simulator/resourcewatcher/resourcewatcher.go:63-71).
KINDS = (
    "pods",
    "nodes",
    "persistentvolumes",
    "persistentvolumeclaims",
    "storageclasses",
    "priorityclasses",
    "namespaces",
)
NAMESPACED_KINDS = frozenset({"pods", "persistentvolumeclaims"})

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


#: pre-image marker for keys a transaction CREATED (nothing to restore).
_MISSING = object()


@dataclass
class _Txn:
    """Open-transaction state: first-touch pre-images + buffered events.

    Pre-images are the LIVE stored dicts (frozen contract: writes
    replace, never mutate), so recording them is O(1) per touched key —
    no copies.  Events buffer instead of delivering; commit replays
    them through the normal notify path, rollback drops them, so a
    watcher (the scheduler loop, the live write-back) can never observe
    a state the transaction did not commit."""

    pre: dict = field(default_factory=dict)  # (kind, key) -> obj | _MISSING
    events: list = field(default_factory=list)
    # True for the device-replay segment reconcile: its writes are the
    # segment's OWN deltas, which the replay lower-cache already tracks,
    # so they must not bump the mutation epoch (see ClusterStore
    # docstring / mutation_epoch).
    epoch_exempt: bool = False


@dataclass(frozen=True, slots=True)
class WatchEvent:
    """Mirrors the reference's streamwriter.WatchEvent
    (simulator/resourcewatcher/streamwriter/streamwriter.go:18-23)."""

    kind: str
    event_type: str
    obj: JSON

    def to_json(self) -> JSON:
        return {"Kind": self.kind, "EventType": self.event_type, "Obj": self.obj}


def _key(kind: str, obj_or_name: JSON | str, namespace: str = "") -> str:
    if isinstance(obj_or_name, str):
        name = obj_or_name
        ns = namespace
    else:
        name = name_of(obj_or_name)
        ns = namespace_of(obj_or_name)
    if kind in NAMESPACED_KINDS:
        return f"{ns or 'default'}/{name}"
    return name


class ClusterStore:
    """Thread-safe versioned store of cluster objects with watch streams."""

    # Watch-resume history depth: older lastResourceVersions trigger a
    # relist, like an etcd compaction would.
    HISTORY_DEPTH = 8192

    def __init__(self, *, strict: "bool | None" = None) -> None:
        self._lock = threading.RLock()
        # Sanitizer-lite (docs/lint.md "Lock discipline", docs/env.md):
        # strict mode makes every internal mutator assert the store
        # lock is held by the calling thread.  Debug-only, off by
        # default; KSIM_STORE_STRICT=1 flips the default (the
        # concurrency-stress tests and the make-faults matrix run with
        # it on).
        self._strict = (
            os.environ.get("KSIM_STORE_STRICT", "") == "1" if strict is None else strict
        )
        self._rv = itertools.count(1)  # guarded-by: _lock
        self._objects: dict[str, dict[str, JSON]] = {k: {} for k in KINDS}  # guarded-by: _lock
        self._watchers: list[tuple[queue.SimpleQueue, frozenset[str]]] = []  # guarded-by: _lock
        # guarded-by: _lock
        self._history: "collections.deque[tuple[int, WatchEvent]]" = (
            collections.deque(maxlen=self.HISTORY_DEPTH)
        )
        # Name-sorted (name, key) order per kind, maintained INCREMENTALLY
        # (bisect insert/remove on membership changes; updates keep their
        # key).  The scheduler lists every kind every pass and churn
        # replay mutates membership every step — re-sorting thousands of
        # unchanged objects per list() dominated churn-replay host time.
        self._sorted_keys: dict[str, list[tuple[str, str]]] = {k: [] for k in KINDS}  # guarded-by: _lock
        # Pod partition by spec.nodeName presence (phase-agnostic; the
        # consumers apply their own phase/queue predicates).  The
        # scheduler walks "all pods" several times per pass only to pick
        # one side of this split — at churn scale those O(pods) walks
        # over a 15k+ population dominated saturated host time.  Values
        # are the same live frozen dicts ``_objects`` holds.
        self._with_node: dict[str, JSON] = {}  # guarded-by: _lock
        self._without_node: dict[str, JSON] = {}  # guarded-by: _lock
        # Secondary index: nodeName -> {pod key -> live obj}.  Node-drain
        # requeue asks "which pods are bound to THESE nodes" — walking
        # the whole bound side per drained node (~10s of the 50k churn
        # replay) against a dict-bucket lookup.
        self._by_node: dict[str, dict[str, JSON]] = {}  # guarded-by: _lock
        self._node_of: dict[str, str] = {}  # guarded-by: _lock
        # Open transaction (``transaction()``); None outside one.
        self._txn: _Txn | None = None  # guarded-by: _lock
        # Mutation epoch: bumped by EVERY write except those staged in an
        # ``epoch_exempt`` transaction (the device-replay segment
        # reconcile, whose deltas the ReplayDriver's lower-cache tracks
        # itself).  The cache keys its validity on this counter: any
        # out-of-band write — a server handler, the write-back loop, a
        # per-pass fallback step, test scaffolding — moves the epoch and
        # strictly invalidates the cached lowered universe at the next
        # segment lower (engine/replay.py _LowerCache).
        self._mutation_epoch = 0  # guarded-by: _lock

    @property
    def mutation_epoch(self) -> int:
        with self._lock:
            return self._mutation_epoch

    # -- transactions -------------------------------------------------------

    # Machine-checked acquisition order (tools/ksimlint lock-order):
    # commit/rollback emit trace events while holding the store lock —
    # the trace plane is a leaf under it.
    # ksimlint: lock-order(ClusterStore._lock<TracePlane._lock)
    @contextlib.contextmanager
    def transaction(self, *, epoch_exempt: bool = False):
        """All-or-nothing write batch.

        Holds the store lock for the whole block (readers in OTHER
        threads wait; the owning thread reads its own staged state
        through the normal API).  On normal exit, buffered watch events
        deliver in write order.  On ANY exception, every touched key
        restores to its pre-transaction object and no event is ever
        delivered — a watcher cannot observe a half-applied batch.
        The resourceVersion counter is deliberately not rewound
        (rv gaps are legal, like etcd revisions).

        Used by the device-replay segment reconcile (scenario/runner.py)
        so an injected mid-reconcile fault — or a parity-check failure —
        can never leave a partially applied segment in the store.
        ``epoch_exempt=True`` (the segment reconcile only) keeps the
        batch's writes from bumping ``mutation_epoch``: the replay
        lower-cache tracks those deltas itself, and only OUT-OF-BAND
        writes must invalidate it.  Nesting is not supported;
        ``restore`` inside a transaction is refused."""
        with self._lock:
            if self._txn is not None:
                raise RuntimeError("nested store transactions are not supported")
            txn = _Txn(epoch_exempt=epoch_exempt)
            self._txn = txn
            try:
                yield self
            except BaseException as e:
                self._txn = None
                self._rollback(txn)
                TRACE.event(
                    "store.txn_rollback",
                    writes=len(txn.pre),
                    events=len(txn.events),
                    error=type(e).__name__,
                )
                raise
            self._txn = None
            TRACE.event(
                "store.txn_commit", writes=len(txn.pre), events=len(txn.events)
            )
            for ev in txn.events:
                self._deliver(ev)

    def _assert_owned(self) -> None:
        """Sanitizer-lite hook (strict mode): raise if the calling
        thread does not hold the store lock.  ``_is_owned`` is the
        stdlib RLock's own ownership probe — private but stable, and
        the only way to ask without trying to acquire."""
        if self._strict and not self._lock._is_owned():
            raise AssertionError(
                "ClusterStore internal mutator called without holding the "
                "store lock (KSIM_STORE_STRICT)"
            )

    def _touch(self, kind: str, key: str) -> None:  # ksimlint: lock-held(_lock)
        """Record a key's first-touch pre-image (callers hold the lock
        and are about to mutate the key)."""
        self._assert_owned()
        txn = self._txn
        if txn is not None and (kind, key) not in txn.pre:
            txn.pre[(kind, key)] = self._objects[kind].get(key, _MISSING)

    def _rollback(self, txn: _Txn) -> None:  # ksimlint: lock-held(_lock)
        """Restore every touched key to its pre-transaction object and
        repair the incremental indexes (callers hold the lock).  The
        (name, key) sort entry is identical for pre/current objects of
        the same key (the key embeds the name), so membership-only
        repair is exact."""
        self._assert_owned()
        for (kind, key), pre in txn.pre.items():
            cur = self._objects[kind].get(key, _MISSING)
            if cur is pre:
                continue
            sk = self._sorted_keys[kind]
            if cur is not _MISSING:
                del self._objects[kind][key]
                entry = (name_of(cur), key)
                idx = bisect.bisect_left(sk, entry)
                if idx < len(sk) and sk[idx] == entry:
                    del sk[idx]
            if pre is not _MISSING:
                self._objects[kind][key] = pre
                bisect.insort(sk, (name_of(pre), key))
            if kind == "pods":
                self._index_pod(key, None if pre is _MISSING else pre)

    # -- pod node-name index ------------------------------------------------

    def _index_pod(self, key: str, obj: JSON | None) -> None:  # ksimlint: lock-held(_lock)
        """Maintain the nodeName partition (callers hold the lock)."""
        self._assert_owned()
        self._with_node.pop(key, None)
        self._without_node.pop(key, None)
        old_node = self._node_of.pop(key, None)
        if old_node is not None:
            bucket = self._by_node.get(old_node)
            if bucket is not None:
                bucket.pop(key, None)
                if not bucket:
                    del self._by_node[old_node]
        if obj is None:
            return
        node = obj.get("spec", {}).get("nodeName")
        if node:
            self._with_node[key] = obj
            self._by_node.setdefault(node, {})[key] = obj
            self._node_of[key] = node
        else:
            self._without_node[key] = obj

    # The sides are deliberately UNORDERED (dict insertion order):
    # maintaining incremental (name, key) orders costs an O(side)
    # memmove per pod transition (bind = delete+insert on 15k-entry
    # lists), which measured out slower than the walks the partition
    # saves, and a per-call sort of the bound side costs the same again.
    # Order-sensitive consumers sort the (small) subset they select.

    def pods_with_node(self) -> list[JSON]:
        """Live dicts of pods carrying spec.nodeName (ANY phase),
        UNORDERED.  Read-only, same liveness contract as
        ``list(copy_objs=False)``."""
        with self._lock:
            return list(self._with_node.values())

    def pods_on_nodes(self, node_names) -> list[JSON]:
        """Live dicts of pods bound to any of ``node_names`` (ANY
        phase), UNORDERED — same read-only/liveness contract as
        ``pods_with_node``, via the nodeName bucket index."""
        with self._lock:
            out: list[JSON] = []
            for n in node_names:
                bucket = self._by_node.get(n)
                if bucket:
                    out.extend(bucket.values())
            return out

    def pods_without_node(self) -> list[JSON]:
        """Live dicts of pods without spec.nodeName (ANY phase),
        (name, key)-sorted — the scheduling queue's stable pre-order;
        the pending side is small, so the sort is cheap."""
        with self._lock:
            return [
                o
                for _n, _k, o in sorted(
                    (name_of(o), k, o) for k, o in self._without_node.items()
                )
            ]

    # -- CRUD ---------------------------------------------------------------

    def create(self, kind: str, obj: JSON, *, copy_obj: bool = True) -> JSON:
        """``copy_obj=False`` is the ownership-transfer fast path for
        trusted bulk writers (the scenario runner creates tens of
        thousands of generator-fresh objects; two deepcopies per create
        were ~11% of the 50k churn replay): the caller hands the dict
        over and must neither mutate it afterwards nor mutate the
        returned live object."""
        self._check_kind(kind)
        if copy_obj:
            obj = copy.deepcopy(obj)
        with self._lock:
            key = _key(kind, obj)
            if key in self._objects[kind]:
                raise ConflictError(f"{kind} {key!r} already exists")
            self._touch(kind, key)
            md = obj.setdefault("metadata", {})
            if kind in NAMESPACED_KINDS:
                md.setdefault("namespace", "default")
            md["resourceVersion"] = str(next(self._rv))
            md.setdefault("uid", f"uid-{kind}-{md['resourceVersion']}")
            self._objects[kind][key] = obj
            bisect.insort(self._sorted_keys[kind], (name_of(obj), key))
            if kind == "pods":
                self._index_pod(key, obj)
            # The stored object is frozen (writes replace, never mutate), so
            # the event and history can share it without a copy.
            self._notify(WatchEvent(kind, ADDED, obj))
            return copy.deepcopy(obj) if copy_obj else obj

    def get(self, kind: str, name: str, namespace: str = "") -> JSON:
        self._check_kind(kind)
        with self._lock:
            key = _key(kind, name, namespace)
            try:
                return copy.deepcopy(self._objects[kind][key])
            except KeyError:
                raise NotFoundError(f"{kind} {key!r} not found") from None

    def contains(self, kind: str, name: str, namespace: str = "") -> bool:
        """Keyed membership probe — no deep copy, no NotFoundError (the
        replay lowering's deferred store-membership checks run one probe
        per window event on the hot cache-hit path)."""
        self._check_kind(kind)
        with self._lock:
            return _key(kind, name, namespace) in self._objects[kind]

    def list(self, kind: str, namespace: str = "", *, copy_objs: bool = True) -> list[JSON]:
        """List objects sorted by name.  ``copy_objs=False`` returns the
        live dicts for READ-ONLY hot paths (featurization lists the whole
        cluster every scheduling pass; deep-copying thousands of pod dicts
        per pass dominated churn-replay profiles) — callers must not
        mutate and must not hold them across store writes."""
        self._check_kind(kind)
        with self._lock:
            table = self._objects[kind]
            out = [table[k] for _, k in self._sorted_keys[kind]]
            if namespace and kind in NAMESPACED_KINDS:
                out = [o for o in out if namespace_of(o) == namespace]
            return copy.deepcopy(out) if copy_objs else out

    def update(
        self,
        kind: str,
        obj: JSON,
        *,
        expect_rv: str | None = None,
        copy_obj: bool = True,
    ) -> JSON:
        """Replace an object; raises ConflictError if expect_rv is stale.
        ``copy_obj=False``: same ownership-transfer contract as
        ``create``."""
        self._check_kind(kind)
        if copy_obj:
            obj = copy.deepcopy(obj)
        with self._lock:
            key = _key(kind, obj)
            current = self._objects[kind].get(key)
            if current is None:
                raise NotFoundError(f"{kind} {key!r} not found")
            if expect_rv is not None and current["metadata"]["resourceVersion"] != expect_rv:
                raise ConflictError(
                    f"{kind} {key!r}: resourceVersion {expect_rv} is stale"
                )
            self._touch(kind, key)
            md = obj.setdefault("metadata", {})
            if kind in NAMESPACED_KINDS:
                md.setdefault("namespace", "default")
            md["uid"] = current["metadata"].get("uid")
            md["resourceVersion"] = str(next(self._rv))
            self._objects[kind][key] = obj
            if kind == "pods":
                self._index_pod(key, obj)
            self._notify(WatchEvent(kind, MODIFIED, obj))
            return copy.deepcopy(obj) if copy_obj else obj

    def patch(
        self,
        kind: str,
        name: str,
        namespace: str,
        mutate: Callable[[JSON], None],
        *,
        copy_ret: bool = True,
    ) -> JSON:
        """Atomic read-modify-write under the store lock.
        ``copy_ret=False`` returns the stored live object (read-only
        contract) — for bulk writers that discard the result."""
        self._check_kind(kind)
        with self._lock:
            key = _key(kind, name, namespace)
            current = self._objects[kind].get(key)
            if current is None:
                raise NotFoundError(f"{kind} {key!r} not found")
            obj = copy.deepcopy(current)
            mutate(obj)
            self._touch(kind, key)
            obj["metadata"]["resourceVersion"] = str(next(self._rv))
            self._objects[kind][key] = obj
            if kind == "pods":
                self._index_pod(key, obj)
            self._notify(WatchEvent(kind, MODIFIED, obj))
            return copy.deepcopy(obj) if copy_ret else obj

    def rewrap(
        self, kind: str, name: str, namespace: str, build: Callable[[JSON], JSON]
    ) -> JSON:
        """Atomic replace from a shallow re-wrap: ``build(current)``
        returns a NEW top-level object that may SHARE unmodified
        substructures with ``current`` (which is frozen — writes replace,
        never mutate).  This skips the full deepcopy ``patch`` pays,
        which matters on the scheduler's bind path: pods accumulate
        megabytes of result-history annotations and deep-copying them on
        every attempt dominated the record="full" product path.

        Contract: ``build`` must not mutate ``current`` or any shared
        substructure, must return a fresh ``metadata`` dict (it gets the
        new resourceVersion), and the returned object is stored AND
        shared with watch events — the caller must treat it as frozen.
        """
        self._check_kind(kind)
        with self._lock:
            key = _key(kind, name, namespace)
            current = self._objects[kind].get(key)
            if current is None:
                raise NotFoundError(f"{kind} {key!r} not found")
            obj = build(current)
            self._touch(kind, key)
            md = obj["metadata"] = dict(obj.get("metadata") or {})
            md["resourceVersion"] = str(next(self._rv))
            self._objects[kind][key] = obj
            if kind == "pods":
                self._index_pod(key, obj)
            self._notify(WatchEvent(kind, MODIFIED, obj))
            return obj

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        self._check_kind(kind)
        with self._lock:
            key = _key(kind, name, namespace)
            if key in self._objects[kind]:
                self._touch(kind, key)
            obj = self._objects[kind].pop(key, None)
            if obj is None:
                raise NotFoundError(f"{kind} {key!r} not found")
            if kind == "pods":
                self._index_pod(key, None)
            entry = (name_of(obj), key)
            idx = bisect.bisect_left(self._sorted_keys[kind], entry)
            sk = self._sorted_keys[kind]
            if idx < len(sk) and sk[idx] == entry:
                del sk[idx]
            # A delete is a new store event: stamp a fresh resourceVersion
            # (like the apiserver) so watch-resume replay — which filters
            # history on rv > lastResourceVersion — never drops it.  The
            # rebumped object is a shallow re-wrap: the popped dict may be
            # shared with earlier events/history (frozen contract) and
            # must not be mutated in place.
            obj = dict(obj, metadata=dict(obj["metadata"], resourceVersion=str(next(self._rv))))
            self._notify(WatchEvent(kind, DELETED, obj))

    def apply(self, kind: str, obj: JSON) -> JSON:
        """Create-or-update (the reference Load path uses server-side apply,
        simulator/snapshot/snapshot.go:158-196)."""
        self._check_kind(kind)
        with self._lock:
            key = _key(kind, obj)
            if key in self._objects[kind]:
                return self.update(kind, obj)
            return self.create(kind, obj)

    # -- watch --------------------------------------------------------------

    def watch(
        self,
        kinds: tuple[str, ...] = KINDS,
        *,
        since: dict[str, int] | None = None,
        list_first: tuple[str, ...] = (),
    ) -> "WatchStream":
        """Subscribe to events for ``kinds``.

        ``since`` maps kind -> lastResourceVersion: events after that
        version replay from the bounded history buffer first (the
        reference's RetryWatcher resume, resourcewatcher.go:128-134); a
        version older than the buffer raises ExpiredError — the etcd
        compaction "410 Gone" — telling the client to drop its cache and
        relist (a silent relist could never signal deletions it missed).
        ``list_first`` kinds get their current objects as ADDED events
        (the reference's list-then-watch when no lastResourceVersion is
        given, eventproxy.go:66-80).  Everything happens under one lock,
        so replay/list and the live subscription have no event gap."""
        for k in kinds:
            self._check_kind(k)
        q: queue.SimpleQueue = queue.SimpleQueue()
        with self._lock:
            if since and not self._history:
                # A resume point against a store that never emitted an
                # event can only come from a PREVIOUS store life (server
                # restart): it cannot be verified, so answer Gone and let
                # the client drop its cache and relist — silently
                # accepting it would leave the client showing pre-restart
                # objects forever.
                for kind, last in since.items():
                    self._check_kind(kind)
                    if kind in kinds and last > 0:
                        raise ExpiredError(
                            f"{kind} resourceVersion {last} predates this "
                            "store (no event history)"
                        )
            if since and self._history:
                covered_from = self._history[0][0]
                covered_to = self._history[-1][0]
                for kind, last in since.items():
                    self._check_kind(kind)
                    if kind not in kinds:
                        continue
                    if last + 1 < covered_from:
                        raise ExpiredError(
                            f"{kind} resourceVersion {last} is too old "
                            f"(history starts at {covered_from})"
                        )
                    if last > covered_to:
                        # From a previous store life whose rv counter ran
                        # ahead of this one — unverifiable, same as above.
                        raise ExpiredError(
                            f"{kind} resourceVersion {last} is ahead of "
                            f"this store (history ends at {covered_to})"
                        )
            for kind in list_first:
                self._check_kind(kind)
                for obj in self._objects[kind].values():
                    q.put(WatchEvent(kind, ADDED, copy.deepcopy(obj)))
            if since and self._history:
                for kind, last in since.items():
                    if kind not in kinds:
                        continue
                    for rv, ev in self._history:
                        if ev.kind == kind and rv > last:
                            q.put(ev)
            self._watchers.append((q, frozenset(kinds)))
        return WatchStream(self, q)

    def _unwatch(self, q: queue.SimpleQueue) -> None:
        with self._lock:
            self._watchers = [(w, ks) for (w, ks) in self._watchers if w is not q]

    def _notify(self, event: WatchEvent) -> None:  # ksimlint: lock-held(_lock)
        self._assert_owned()
        txn = self._txn
        if txn is not None:
            if not txn.epoch_exempt:
                self._mutation_epoch += 1
            # Staged: delivery (history + watcher queues) happens at
            # commit, in write order; rollback drops the event unseen.
            txn.events.append(event)
            return
        self._mutation_epoch += 1
        self._deliver(event)

    def _deliver(self, event: WatchEvent) -> None:  # ksimlint: lock-held(_lock)
        self._assert_owned()
        try:
            rv = int(event.obj["metadata"]["resourceVersion"])
        except (KeyError, ValueError, TypeError):
            rv = 0
        self._history.append((rv, event))
        for q, kinds in self._watchers:
            if event.kind in kinds:
                q.put(event)

    # -- snapshot/restore (reset service substrate) -------------------------

    def dump(self) -> dict[str, dict[str, JSON]]:
        with self._lock:
            return copy.deepcopy(self._objects)

    def restore(self, dump: dict[str, dict[str, JSON]]) -> None:
        """Wipe and restore; emits DELETED then ADDED events
        (reference reset deletes the etcd prefix then re-puts initial KVs,
        simulator/reset/reset.go:58-85).  Every emitted event — and every
        restored object — gets a FRESH resourceVersion so watch-resume
        replay (which filters on rv > lastResourceVersion) sees all of
        them; the restored objects' recorded rvs are superseded, like an
        etcd re-put bumping mod_revision."""
        with self._lock:
            if self._txn is not None:
                raise RuntimeError("restore() inside a store transaction")
            for kind in KINDS:
                for obj in list(self._objects[kind].values()):
                    # Shallow re-wrap, not in-place: the stored dict may be
                    # shared with earlier events/history (frozen contract).
                    obj = dict(obj, metadata=dict(obj["metadata"], resourceVersion=str(next(self._rv))))
                    self._notify(WatchEvent(kind, DELETED, obj))
                self._objects[kind].clear()
                self._sorted_keys[kind] = []
                if kind == "pods":
                    self._with_node.clear()
                    self._without_node.clear()
                    self._by_node.clear()
                    self._node_of.clear()
            for kind, objs in dump.items():
                self._check_kind(kind)
                for key, obj in objs.items():
                    restored = copy.deepcopy(obj)
                    restored.setdefault("metadata", {})["resourceVersion"] = str(
                        next(self._rv)
                    )
                    self._objects[kind][key] = restored
                    bisect.insort(self._sorted_keys[kind], (name_of(restored), key))
                    if kind == "pods":
                        self._index_pod(key, restored)
                    self._notify(WatchEvent(kind, ADDED, restored))

    # -- exact-state checkpoint (incremental job resume) --------------------

    def checkpoint(self) -> dict[str, Any]:
        """JSON-safe EXACT-state snapshot for the job plane's segment
        checkpoints (ksim_tpu/jobs/manager.py).

        Unlike ``dump``/``restore`` — which re-stamp fresh
        resourceVersions on load, like the reference reset service's
        etcd re-put (simulator/reset/reset.go:58-85) — a checkpoint
        carries the objects VERBATIM (rv and uid included) plus the rv
        counter position and the mutation epoch, so a restored store is
        byte-identical to the original: replaying the remaining event
        suffix consumes the same resourceVersions and mints the same
        ``uid-<kind>-<rv>`` defaults an uninterrupted run would have.
        Refused inside a transaction (a mid-segment snapshot would
        capture staged, uncommitted writes)."""
        with self._lock:
            if self._txn is not None:
                raise RuntimeError("checkpoint() inside a store transaction")
            # Peek the rv counter without consuming a version: next()
            # is the only read an itertools.count offers, so reinstall
            # a fresh count at the observed position.
            rv_next = next(self._rv)
            self._rv = itertools.count(rv_next)
            return {
                "objects": copy.deepcopy(self._objects),
                "rv_next": rv_next,
                "mutation_epoch": self._mutation_epoch,
            }

    @classmethod
    def from_checkpoint(
        cls, state: dict[str, Any], *, strict: "bool | None" = None
    ) -> "ClusterStore":
        """Reconstruct a store from a ``checkpoint()`` document.

        Objects install verbatim (no fresh rv/uid — the whole point),
        the rv counter resumes at the recorded position, the mutation
        epoch restores exactly (the replay lower-cache anchors plan
        validity on it — a restored store must not alias a cached
        epoch), and the incremental indexes (name-sorted keys, the pod
        nodeName partition) rebuild from the objects.  No watch events
        are emitted: the store is fresh, nothing subscribed yet."""
        store = cls(strict=strict)
        with store._lock:
            for kind, objs in state["objects"].items():
                store._check_kind(kind)
                table = store._objects[kind]
                sk = store._sorted_keys[kind]
                for key, obj in objs.items():
                    restored = copy.deepcopy(obj)
                    table[key] = restored
                    bisect.insort(sk, (name_of(restored), key))
                    if kind == "pods":
                        store._index_pod(key, restored)
            store._rv = itertools.count(int(state["rv_next"]))
            store._mutation_epoch = int(state["mutation_epoch"])
        return store

    def _check_kind(self, kind: str) -> None:
        # The KINDS key set of _objects is fixed at construction (only
        # the inner per-kind tables mutate), so this membership probe is
        # safe before the lock — public mutators call it on their way in.
        if kind not in self._objects:  # ksimlint: disable=lock-discipline
            raise NotFoundError(f"unknown kind {kind!r}")


class WatchStream:
    """Iterator over watch events; close() detaches from the store."""

    def __init__(self, store: ClusterStore, q: queue.SimpleQueue) -> None:
        self._store = store
        self._q = q
        self._closed = False

    def next(self, timeout: float | None = None) -> WatchEvent | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def __iter__(self) -> Iterator[WatchEvent]:
        while not self._closed:
            ev = self.next(timeout=0.1)
            if ev is not None:
                yield ev

    def close(self) -> None:
        self._closed = True
        self._store._unwatch(self._q)
