"""Snapshot -> fixed-shape device tensors.

This is the host->TPU boundary of the framework: the analogue of the
reference's NodeInfo/PodInfo construction in the upstream scheduler cache
(which the wrapped plugins consume per-(pod,node) call,
reference simulator/scheduler/plugin/wrappedplugin.go:420-548).  Everything
the batched Filter/Score kernels need is lowered here once per snapshot:

- **Resource axis.** The tracked resource set is cpu, memory,
  ephemeral-storage plus any extended resources present in the snapshot.
  ``pods`` capacity is a separate scalar ("Too many pods" check).
- **Exact unit scaling.** Kube-scheduler does int64 math; TPU integer math
  is int32.  Each resource r gets a unit u_r = gcd of every observed value
  of r, and all values are stored as value/u_r.  Integer-division score
  formulas like ``(c-r)*100//c`` are ratios of the raw values, so dividing
  numerator and denominator by the same u_r leaves every result bit-exact.
  If the scaled values could still overflow ``int32`` through the ``*100``
  in the score formula the featurizer falls back to lossy scaling and
  records ``exact=False`` (callers can then route parity-critical runs to
  the int64 path / host oracle).
- **Padding + bucketing.**  Pod and node counts are padded up to
  bucketed shapes (powers of two, with a 3/4 step in the >= 8192-pow2
  octaves — see ``bucket_size``) so recompiles are bounded (SURVEY.md
  section 7 hard part 4); ``valid`` masks carry the true extents.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

from ksim_tpu_torch.state.resources import (
    BASE_RESOURCES,
    UNSCHEDULABLE_TAINT,
    CPU,
    JSON,
    MEMORY,
    EPHEMERAL_STORAGE,
    PODS,
    labels_of,
    name_of,
    namespaced_key,
    node_allocatable,
    node_unschedulable,
    pod_is_scheduled,
    pod_node_name,
    pod_requests,
    pod_tolerations,
    tolerations_tolerate_taint,
)

# Largest per-resource scaled value that keeps v*100 (MaxNodeScore) in int32.
MAX_EXACT_SCALED = (2**31 - 1) // 128

# The tracked-resource prefix is BASE_RESOURCES (state/resources.py);
# extended resources are appended in sorted order.


def bucket_size(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (>= minimum) — with a 3/4 step
    once the pow2 reaches 8192 (…, 2048, 4096, 6144, 8192, 12288,
    16384, …).

    Pure powers of two waste up to half the compiled program's work on
    padding (5000 pods -> 8192 meant the headline scan burned 39% of
    its FLOPs on masked rows; 10k x 5k burned 44% across both axes).
    The extra bucket exists only at >= 8192 pow2s, so churn-scale
    shapes (pods capped per pass, vocabularies reset-valved at 4096,
    thousands of nodes) keep the exact old ladder — no new recompile
    boundaries there — and every 3/4 step is divisible by 2048, so
    dp/tp mesh sharding still divides evenly."""
    if n <= minimum:
        return minimum
    p = 1 << (n - 1).bit_length()
    if p >= 8192 and n <= (p * 3) // 4:
        return (p * 3) // 4
    return p


def vocab_pad(n: int, minimum: int = 8) -> int:
    """Bucket for a VOCABULARY axis (the ``bucket_size`` ladder): churn
    replay adds and removes vocab entries constantly, and unbucketed
    vocab shapes would force an XLA recompile on nearly every step (the
    pod/node axes are bucketed the same way)."""
    return bucket_size(max(n, 1), minimum)


@dataclass
class NodeTensors:
    """Per-node device-ready arrays, shape [N] or [N, R]."""

    names: list[str]
    allocatable: np.ndarray  # int32 [N, R] scaled
    allowed_pods: np.ndarray  # int32 [N]
    requested: np.ndarray  # int32 [N, R] from already-bound pods
    nonzero_requested: np.ndarray  # int32 [N, R] scoring-path accumulation
    pod_count: np.ndarray  # int32 [N]
    unschedulable: np.ndarray  # bool [N]
    valid: np.ndarray  # bool [N]

    @property
    def count(self) -> int:
        return len(self.names)

    @property
    def padded(self) -> int:
        return self.valid.shape[0]


@dataclass
class PodTensors:
    """Per-pod device-ready arrays, shape [P] or [P, R]."""

    keys: list[str]  # namespace/name
    requests: np.ndarray  # int32 [P, R] scaled (Fit filter path)
    nonzero_requests: np.ndarray  # int32 [P, R] scaled (scoring path)
    valid: np.ndarray  # bool [P]
    tolerates_unschedulable: np.ndarray  # bool [P]
    has_requests: np.ndarray  # bool [P] (fitsRequest early-exit predicate)
    index: np.ndarray  # int32 [P] == arange (row into per-pod aux arrays)

    @property
    def count(self) -> int:
        return len(self.keys)


@dataclass
class FeaturizedSnapshot:
    """Everything the batched kernels need, plus host-side decode tables."""

    resources: tuple[str, ...]  # the R axis
    units: dict[str, int]  # resource -> divisor used in scaling
    exact: bool  # int32 math is bit-exact vs int64
    nodes: NodeTensors
    pods: PodTensors
    aux: dict[str, Any] = field(default_factory=dict)  # plugin extras

    def resource_index(self, r: str) -> int:
        return self.resources.index(r)


def _gcd_unit(values: Sequence[int]) -> int:
    g = 0
    for v in values:
        g = math.gcd(g, v)
    return g or 1


class Featurizer:
    """Lower a snapshot (lists of pod/node JSON objects) to tensors."""

    def __init__(
        self,
        *,
        node_bucket_min: int | None = None,
        pod_bucket_min: int | None = None,
        interpod_hard_weight: int | None = None,
        extra_encoders: "dict[str, Any] | None" = None,
        added_affinity: "JSON | None" = None,
        spread_defaults: "tuple | None" = None,
    ) -> None:
        """``extra_encoders`` maps aux key -> fn(nodes, queue_pods,
        n_padded, p_padded) -> dataclass-with-AXES — the hook out-of-tree
        plugins use to ship their own tensors to the device (the sample
        NodeNumber / data-provider plugins ride this).  ``added_affinity``
        is the profile's NodeAffinityArgs.addedAffinity (upstream
        node_affinity.go addedNodeSelector/addedPrefSchedTerms)."""
        if interpod_hard_weight is None:
            from ksim_tpu_torch.state.interpod import DEFAULT_HARD_POD_AFFINITY_WEIGHT

            interpod_hard_weight = DEFAULT_HARD_POD_AFFINITY_WEIGHT
        self._node_bucket_min = node_bucket_min if node_bucket_min else 8
        self._pod_bucket_min = pod_bucket_min if pod_bucket_min else 8
        self._interpod_hard_weight = interpod_hard_weight
        self._extra_encoders = dict(extra_encoders or {})
        self._added_affinity = added_affinity
        # PodTopologySpreadArgs default constraints (List defaulting, or
        # the upstream systemDefaultConstraints for System) — inert in
        # the snapshot model (see encoding.default_spread_selector) but
        # threaded so the behavior is upstream-shaped.
        self._spread_defaults = spread_defaults
        # Incremental bound-pod aggregation across featurizations of the
        # SAME evolving cluster (state/boundagg.py): node-name slots keep
        # the node axis stable under churn, and the additive aggregates
        # update by delta instead of re-walking every bound pod.  A fresh
        # instance behaves exactly like the one-shot path (slot order =
        # first-seen order = the caller's order).
        from ksim_tpu_torch.state.boundagg import NodeSlots

        self._slots = NodeSlots()
        # Slot churn applied through advance_slots() between featurize
        # calls (the device-resident replay rolls node history forward
        # step by step without featurizing); merged into the next
        # featurize's changed-slot set so family repair still sees it.
        self._pending_changed: set[int] = set()
        self._agg: dict[str, Any] = {}
        # Shared per-pass bound-set diff (see boundagg.sync_family): one
        # O(bound) comparison per pass instead of one per family.
        self._prev_bound: dict[int, JSON] = {}
        self._bound_gen = 0
        # Bound pods carrying volumes, maintained from the diff — the
        # volumes fast path needs "is ANY bound pod using volumes", and
        # re-scanning 15k+ bound pods per pass was the single largest
        # steady-state featurize cost.
        self._bound_vol_count = 0
        # O(delta) evidence counters: per-pod base-row computations that
        # actually RAN vs. ones served from the identity memo.  A caller
        # with an identity-stable queue (the replay lower-cache keeps
        # surviving universe pods' objects alive across segments) should
        # see ``pod_rows_built`` grow with its per-window object churn,
        # not with the universe size — the counter the bench /
        # ``make lock-check`` O(delta) guard reads (docs/churn_floor.md
        # "Incremental lowering + pipelined executor").
        self.pod_rows_built = 0
        self.pod_rows_reused = 0
        self.featurize_passes = 0

    def slot_names(self) -> list[str]:
        """The current node-slot order, lowest slot first — the carry a
        segment checkpoint records so ``seed_slots`` can reinstall it on
        a restored run (scheduler/service.py ``checkpoint_carries``)."""
        return list(self._slots._names)

    def seed_slots(self, names: Sequence[str]) -> None:
        """Install a checkpoint-recorded node-slot order on a FRESH
        featurizer (job-plane incremental resume — see
        ``boundagg.NodeSlots.seed``).  Every seeded slot is queued as
        changed so the first featurize repairs families against the
        live objects; on a fresh instance that repair is the from-
        scratch rebuild it would have done anyway."""
        self._slots.seed(names)
        self._pending_changed |= set(range(len(names)))

    def advance_slots(self, nodes: Sequence[JSON]) -> None:
        """Advance the persistent node-slot history WITHOUT featurizing.

        The device-resident replay (engine/replay.py) schedules whole
        step segments off-host; between those steps this featurizer never
        runs, but its slot assignment must still follow every node
        delete/create so a later per-pass fallback sees the exact order
        the pure per-pass history would have produced.  Changed slots
        accumulate and merge into the next featurize's repair set."""
        _ordered, changed = self._slots.sync(list(nodes))
        self._pending_changed |= changed

    def featurize(
        self,
        nodes: Sequence[JSON],
        pods: Sequence[JSON],
        *,
        queue_pods: Sequence[JSON] = (),
        bound_pods: "Sequence[JSON] | None" = None,
        namespaces: Sequence[JSON] = (),
        pvs: Sequence[JSON] = (),
        pvcs: Sequence[JSON] = (),
        storage_classes: Sequence[JSON] = (),
    ) -> FeaturizedSnapshot:
        """``pods`` are existing cluster pods (bound ones charge their node);
        ``queue_pods`` are the pods to schedule (the pod axis P);
        ``bound_pods``, when given, are the node-bound pods (spec.nodeName
        set; callers with an indexed store pass
        ``store.pods_with_node()`` to skip the O(all pods) split —
        phase filtering still happens here);
        ``namespaces`` feed namespaceSelector matching (InterPodAffinity);
        ``pvs``/``pvcs``/``storage_classes`` feed the volume plugins."""
        from ksim_tpu_torch.state import objcache

        # Safe point for memo-table size enforcement: no memo key is in
        # flight here (see objcache.maybe_flush).
        objcache.maybe_flush()

        from ksim_tpu_torch.state.boundagg import sync_family

        sched_pods = list(queue_pods) if queue_pods else [
            p for p in pods if not pod_is_scheduled(p)
        ]
        bound_src = pods if bound_pods is None else bound_pods
        bound_pods = [
            p
            for p in bound_src
            if pod_is_scheduled(p)
            and (p.get("status", {}).get("phase") not in ("Succeeded", "Failed"))
        ]

        # Stable node slots: churn must not shift the node axis under the
        # incremental aggregates.  For a fresh featurizer this is the
        # caller's order.
        nodes, changed_slots = self._slots.sync(nodes)
        if self._pending_changed:
            changed_slots = changed_slots | self._pending_changed
            self._pending_changed = set()
        bound_map = {id(p): p for p in bound_pods}
        # Publish the shared arrival/departure diff for every family this
        # pass syncs (holding the previous map's pod refs keeps ids from
        # being recycled while they can still appear in a diff).
        prev = self._prev_bound
        self._bound_gen += 1
        added = [pid for pid in bound_map if pid not in prev]
        removed = [pid for pid in prev if pid not in bound_map]
        self._agg["__diff__"] = {
            "gen": self._bound_gen,
            "added": added,
            "removed": removed,
        }
        from ksim_tpu_torch.state.volumes import _pod_has_volumes

        for pid in added:
            self._bound_vol_count += _pod_has_volumes(bound_map[pid])
        for pid in removed:
            self._bound_vol_count -= _pod_has_volumes(prev[pid])
        self._prev_bound = bound_map

        node_alloc = [node_allocatable(n) for n in nodes]
        pod_reqs = [pod_requests(p) for p in sched_pods]
        pod_nz_reqs = [pod_requests(p, non_zero=True) for p in sched_pods]

        # Bound pods' raw request values as an incrementally-maintained
        # multiset per resource: the resource axis and exact gcd units
        # need every value that enters math, without an O(bound) walk.
        def _resvals_record(p: JSON):
            pairs = []
            for non_zero in (False, True):
                for r, v in pod_requests(p, non_zero=non_zero).items():
                    if v:
                        pairs.append((r, v))
            return (-1, tuple(pairs))

        def _resvals_apply(counters: dict, rec, sign: int) -> None:
            for r, v in rec[1]:
                c = counters.setdefault(r, {})
                nv = c.get(v, 0) + sign
                if nv:
                    c[v] = nv
                else:
                    del c[v]
                    if not c:
                        del counters[r]

        bound_vals: dict[str, dict[int, int]] = sync_family(
            self._agg,
            "resvals",
            (),
            bound_map,
            set(),  # node-independent
            make_arrays=dict,
            record_of=_resvals_record,
            apply=_resvals_apply,
        )

        # Resource axis: base prefix + extended resources seen anywhere.
        seen: set[str] = set()
        for d in (*node_alloc, *pod_reqs):
            seen.update(d.keys())
        seen.update(bound_vals.keys())
        seen.discard(PODS)
        extended = sorted(seen - set(BASE_RESOURCES))
        resources = BASE_RESOURCES + tuple(extended)
        ridx = {r: i for i, r in enumerate(resources)}
        R = len(resources)
        exact = True
        if R > 29:
            # Reason bits past bit 30 saturate into a shared bit (see
            # plugins/noderesources.py); decoded reasons are then ambiguous.
            exact = False

        # Exact gcd units per resource across every value that enters math.
        units: dict[str, int] = {}
        for r in resources:
            vals = [d.get(r, 0) for d in (*node_alloc, *pod_reqs, *pod_nz_reqs)]
            vals = [v for v in vals if v]
            vals.extend(bound_vals.get(r, ()))
            unit = _gcd_unit(vals)
            max_scaled = max((v // unit for v in vals), default=0)
            if max_scaled > MAX_EXACT_SCALED:
                # Lossy fallback: keep magnitudes bounded, mark inexact.
                unit = unit * -(-max_scaled // MAX_EXACT_SCALED)
                exact = False
            units[r] = unit

        # The requests dicts are memoized per pod object (pod_requests),
        # so lowered rows can be memoized on the dict's identity as long
        # as the unit scaling they were lowered with is part of the key.
        units_token = (resources, tuple(units[r] for r in resources))

        def lower(d: dict[str, int]) -> np.ndarray:
            key = ("lower", objcache.ref_id(d), units_token)
            hit = objcache.get(key)
            if hit is not objcache.MISS:
                return hit
            row = np.zeros(R, dtype=np.int64)
            for r, v in d.items():
                i = ridx.get(r)
                if i is not None:
                    u = units[r]
                    row[i] = v // u if v % u == 0 else -(-v // u)
            return objcache.put(key, row)

        N, P = len(nodes), len(sched_pods)
        NP, PP = bucket_size(N, self._node_bucket_min), bucket_size(P, self._pod_bucket_min)

        def build_node_arrays():
            alloc = np.zeros((NP, R), dtype=np.int32)
            allowed_pods = np.zeros(NP, dtype=np.int32)
            unsched = np.zeros(NP, dtype=bool)
            nvalid = np.zeros(NP, dtype=bool)
            node_names = [name_of(n) for n in nodes]
            for i, n in enumerate(nodes):
                alloc[i] = lower(node_alloc[i])
                allowed_pods[i] = node_alloc[i].get(PODS, 0)
                unsched[i] = node_unschedulable(n)
                nvalid[i] = True
            return alloc, allowed_pods, unsched, nvalid, node_names

        # Family-cached on the exact node objects + unit scaling: under
        # churn the node list and units are stable most passes, so the
        # 2k-iteration lowering loop collapses to one dict hit.
        alloc, allowed_pods, unsched, nvalid, node_names = objcache.cached_seq(
            "feat_nodes", nodes, build_node_arrays, units_token, NP
        )
        node_index = self._slots.slot_of

        # Per-node request sums from bound pods, maintained by delta.
        # Masters accumulate in int64: per-value bounds don't bound the
        # SUM over bound pods; clamp (and drop exactness) on the copies
        # only if a sum overflows.
        def _req_record(p: JSON):
            ni = node_index.get(pod_node_name(p))
            if ni is None or ni >= N:
                return None
            return (
                ni,
                (lower(pod_requests(p)), lower(pod_requests(p, non_zero=True))),
            )

        def _req_apply(arrays, rec, sign: int) -> None:
            ni, (row, nzrow) = rec
            if sign > 0:
                arrays["req"][ni] += row
                arrays["nz"][ni] += nzrow
                arrays["cnt"][ni] += 1
            else:
                arrays["req"][ni] -= row
                arrays["nz"][ni] -= nzrow
                arrays["cnt"][ni] -= 1

        reqagg = sync_family(
            self._agg,
            "requested",
            (units_token, NP),
            bound_map,
            changed_slots,
            make_arrays=lambda: {
                "req": np.zeros((NP, R), dtype=np.int64),
                "nz": np.zeros((NP, R), dtype=np.int64),
                "cnt": np.zeros(NP, dtype=np.int32),
            },
            record_of=_req_record,
            apply=_req_apply,
        )
        requested = reqagg["req"].copy()
        nz_requested = reqagg["nz"].copy()
        pod_count = reqagg["cnt"].copy()

        if requested.max(initial=0) > MAX_EXACT_SCALED or nz_requested.max(initial=0) > MAX_EXACT_SCALED:
            exact = False
            requested = np.minimum(requested, MAX_EXACT_SCALED)
            nz_requested = np.minimum(nz_requested, MAX_EXACT_SCALED)
        requested = requested.astype(np.int32)
        nz_requested = nz_requested.astype(np.int32)

        preq = np.zeros((PP, R), dtype=np.int32)
        pnz = np.zeros((PP, R), dtype=np.int32)
        pvalid = np.zeros(PP, dtype=bool)
        ptol = np.zeros(PP, dtype=bool)
        phas = np.zeros(PP, dtype=bool)
        base_set = set(BASE_RESOURCES)

        self.featurize_passes += 1

        def pod_base(p: JSON, j: int):
            """One memo entry bundling the pod's base-row pieces — a
            saturated churn pass re-featurizes ~1k unchanged pods, and
            one lookup per pod beats four."""
            key = ("podbase", objcache.ref_id(p), units_token)
            hit = objcache.get(key)
            if hit is not objcache.MISS:
                self.pod_rows_reused += 1
                return hit
            self.pod_rows_built += 1
            reqs = pod_reqs[j]
            # Upstream fitsRequest early-exit predicate: base requests all
            # zero AND no scalar-resource key present (a zero-valued
            # extended-resource key still defeats the early return).
            bundle = (
                lower(reqs),
                lower(pod_nz_reqs[j]),
                tolerations_tolerate_taint(pod_tolerations(p), UNSCHEDULABLE_TAINT),
                any(reqs.get(r, 0) for r in BASE_RESOURCES)
                or any(k not in base_set and k != PODS for k in reqs),
            )
            return objcache.put(key, bundle)

        for j, p in enumerate(sched_pods):
            preq[j], pnz[j], ptol[j], phas[j] = pod_base(p, j)
            pvalid[j] = True

        from ksim_tpu_torch.state.encoding import (
            encode_affinity,
            encode_taints,
            encode_topology_spread,
        )
        from ksim_tpu_torch.state.extras import (
            encode_image_locality,
            encode_node_name,
            encode_node_ports,
        )
        from ksim_tpu_torch.state.interpod import encode_inter_pod
        from ksim_tpu_torch.state.volumes import encode_volumes

        aux = {
            "affinity": encode_affinity(
                nodes, sched_pods, NP, PP, added_affinity=self._added_affinity
            ),
            "taints": encode_taints(nodes, sched_pods, NP, PP),
            "spread": encode_topology_spread(
                nodes, sched_pods, bound_pods, NP, PP,
                agg=self._agg, bound_map=bound_map,
                changed_slots=changed_slots, slot_of=node_index,
                default_constraints=self._spread_defaults,
            ),
            "interpod": encode_inter_pod(
                nodes, sched_pods, bound_pods, namespaces, NP, PP,
                hard_weight=self._interpod_hard_weight,
                agg=self._agg, bound_map=bound_map,
                changed_slots=changed_slots, slot_of=node_index,
            ),
            "nodename": encode_node_name(nodes, sched_pods, PP),
            "nodeports": encode_node_ports(nodes, sched_pods, bound_pods, NP, PP),
            "imagelocality": encode_image_locality(nodes, sched_pods, NP, PP),
            "volumes": encode_volumes(
                nodes, sched_pods, bound_pods, pvs, pvcs, storage_classes, NP, PP,
                bound_volume_free=self._bound_vol_count == 0,
            ),
        }
        for key, encoder in self._extra_encoders.items():
            aux[key] = encoder(nodes, sched_pods, NP, PP)

        return FeaturizedSnapshot(
            resources=resources,
            units=units,
            exact=exact,
            aux=aux,
            nodes=NodeTensors(
                names=node_names,
                allocatable=alloc,
                allowed_pods=allowed_pods,
                requested=requested,
                nonzero_requested=nz_requested,
                pod_count=pod_count,
                unschedulable=unsched,
                valid=nvalid,
            ),
            pods=PodTensors(
                keys=[namespaced_key(p) for p in sched_pods],
                requests=preq,
                nonzero_requests=pnz,
                valid=pvalid,
                tolerates_unschedulable=ptol,
                has_requests=phas,
                index=np.arange(PP, dtype=np.int32),
            ),
        )


def _field(obj: Any, name: str) -> Any:
    """Attribute ``name`` of ``obj``, or its key ``name`` when ``obj`` is a
    mapping."""
    if isinstance(obj, dict):
        return obj[name]
    return getattr(obj, name)


def _copy_into(cls: type, src: Any) -> Any:
    """An instance of dataclass ``cls`` with every init field read from
    ``src`` by name: arrays as owned numpy copies, anything else deep
    copied."""
    import copy
    import dataclasses

    kw = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        v = _field(src, f.name)
        if hasattr(v, "__array__") and not isinstance(v, (list, tuple, dict)):
            v = np.array(v, copy=True)
        else:
            v = copy.deepcopy(v)
        kw[f.name] = v
    return cls(**kw)


def _aux_from_arrays(aux: dict) -> dict:
    """This package's aux families from a mapping shaped like a
    snapshot's ``aux`` (``ksim_tpu``'s dataclasses, duck-typed, or
    mappings of arrays), every array an owned copy.  Families this
    package has no encoder type for are left out."""
    from ksim_tpu_torch.state.encoding import AffinityTensors, SpreadTensors, TaintTensors
    from ksim_tpu_torch.state.extras import ImageTensors, NodeNameTensors, NodePortTensors
    from ksim_tpu_torch.state.interpod import InterPodTensors
    from ksim_tpu_torch.state.volumes import VolumeTensors

    aux_types = {
        "affinity": AffinityTensors,
        "taints": TaintTensors,
        "spread": SpreadTensors,
        "interpod": InterPodTensors,
        "nodename": NodeNameTensors,
        "nodeports": NodePortTensors,
        "imagelocality": ImageTensors,
        "volumes": VolumeTensors,
    }
    return {key: _copy_into(aux_types[key], val) for key, val in aux.items() if key in aux_types}


def snapshot_from_arrays(obj: Any) -> FeaturizedSnapshot:
    """This package's FeaturizedSnapshot from any object shaped like one:
    ``ksim_tpu``'s own (duck-typed, never imported), or the same fields
    held in mappings of numpy arrays.  The aux families are matched by
    key; families this package has no encoder type for are left out."""
    aux = _aux_from_arrays(_field(obj, "aux"))
    return FeaturizedSnapshot(
        resources=tuple(_field(obj, "resources")),
        units=dict(_field(obj, "units")),
        exact=bool(_field(obj, "exact")),
        nodes=_copy_into(NodeTensors, _field(obj, "nodes")),
        pods=_copy_into(PodTensors, _field(obj, "pods")),
        aux=aux,
    )
