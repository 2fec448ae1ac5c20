"""DefaultPreemption (PostFilter) — the victim-search semantics.

Upstream kube-scheduler v1.30 ``plugins/defaultpreemption/default_preemption.go``
and ``framework/preemption/preemption.go``; the reference wraps PostFilter
and records ``{node: {plugin: "preemption victim"}}`` for the nominated
node, ``{}`` for every other filtered node (reference
simulator/scheduler/plugin/wrappedplugin.go:550-577,
simulator/scheduler/plugin/resultstore/store.go:439-456).

This module is the HOST implementation and the parity source of truth:
the per-pass scheduling path runs it directly, with the exact-parity
oracle for fit checks (plugins/oracle.py).  Since round 7 the
device-resident replay (engine/replay.py) lowers the same search into
the segment scan — bounded candidate/reprieve loops through the
compiled filter kernels — gated on the profile's filter set matching
``ORACLE_FIT_FILTER_NAMES`` below, and verified against this module on
the hand-derived fixtures (tests/fixtures/preemption_victims.py).
Changing any semantics here must change the device lowering and the
fixtures together.  Simplifications vs upstream, documented: no
PodDisruptionBudgets in the snapshot model (the reference's 7-kind
snapshot has none either, snapshot/snapshot.go:33-42), so the
PDB-violation criteria are trivially zero; victim start times fall back
to creationTimestamp when status.startTime is absent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ksim_tpu_torch.plugins import oracle
from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of

DEFAULT_PREEMPTION = "DefaultPreemption"
NOMINATED_MESSAGE = "preemption victim"

# Upstream DefaultPreemptionArgs defaults.
MIN_CANDIDATE_NODES_PERCENTAGE = 10
MIN_CANDIDATE_NODES_ABSOLUTE = 100

# The filter chain _FitState.fits runs, BY KERNEL NAME.  The device
# replay's on-device victim search (engine/replay.py) re-checks fits
# through the profile's compiled filter kernels, which is only exact
# when the profile's filter set matches this chain — the lowering gates
# on it.  The volume filters are in fits() too but pass trivially for
# the device vocabulary (no volume objects / no pod volumes), so their
# presence in a profile is allowed but not required.
ORACLE_FIT_FILTER_NAMES = frozenset(
    {
        "NodeUnschedulable",
        "NodeName",
        "TaintToleration",
        "NodeAffinity",
        "NodePorts",
        "NodeResourcesFit",
        "PodTopologySpread",
        "InterPodAffinity",
    }
)
VOLUME_FIT_FILTER_NAMES = frozenset(
    {"VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone"}
)


def candidate_count(n_nodes: int) -> int:
    """Upstream GetOffsetAndNumCandidates: how many candidate nodes the
    dry-run collects before stopping (10% of nodes, at least 100,
    capped at the node count)."""
    return min(
        max(n_nodes * MIN_CANDIDATE_NODES_PERCENTAGE // 100, MIN_CANDIDATE_NODES_ABSOLUTE),
        n_nodes,
    )


def pod_priority(pod: JSON) -> int:
    """Bare spec.priority (callers wanting PriorityClass resolution pass
    a resolver from state/priorities.py as ``priority_of``)."""
    return int(pod.get("spec", {}).get("priority") or 0)


def pod_eligible_to_preempt(pod: JSON) -> bool:
    """PodEligibleToPreemptOthers: preemptionPolicy Never opts out."""
    policy = pod.get("spec", {}).get("preemptionPolicy") or "PreemptLowerPriority"
    return policy != "Never"


def start_time(pod: JSON) -> str:
    """Victim start time: status.startTime, falling back to
    creationTimestamp (module docstring).  Public: the device lowering
    ranks start strings with this exact function."""
    return (
        pod.get("status", {}).get("startTime")
        or pod.get("metadata", {}).get("creationTimestamp")
        or ""
    )


_start_time = start_time  # internal alias (historic name)


def more_important_key(p: JSON, priority_of=pod_priority) -> tuple:
    """Sort key for util.MoreImportantPod order: higher priority first,
    then earlier start time (namespace/name breaks exact ties
    deterministically).  Public: the device lowering pre-ranks the pod
    universe with this exact key."""
    return (-priority_of(p), _start_time(p), namespace_of(p), name_of(p))


_more_important = more_important_key  # internal alias (historic name)


def _pods_by_node(pods: Sequence[JSON]) -> dict[str, list[JSON]]:
    out: dict[str, list[JSON]] = {}
    for p in pods:
        node = p.get("spec", {}).get("nodeName")
        if not node:
            continue
        if p.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            continue
        out.setdefault(node, []).append(p)
    return out


class _FitState:
    """Incremental hypothetical cluster state for repeated fit checks
    while victims are removed/reprieved (upstream mutates a copied
    NodeInfo via RemovePod/AddPod rather than rebuilding the snapshot)."""

    def __init__(
        self,
        nodes: Sequence[JSON],
        cluster_pods: Sequence[JSON],
        namespaces: Sequence[JSON],
        volumes: dict | None = None,
    ) -> None:
        self.nodes = nodes
        self.namespaces = namespaces
        self.volumes = volumes or {"pvs": (), "pvcs": (), "storage_classes": ()}
        # The volume oracle filters rebuild per-call lookup maps over the
        # pvc/pv/sc lists; skip them wholesale when the cluster has no
        # volume objects (the common case for preemption).
        self._check_volumes = bool(
            self.volumes.get("pvcs") or self.volumes.get("pvs")
        )
        self.infos = oracle.build_node_infos(nodes, cluster_pods)
        self._by_name = {info["name"]: info for info in self.infos}
        self.pbn = _pods_by_node(cluster_pods)

    def _info_of(self, pod: JSON):
        return self._by_name.get(pod.get("spec", {}).get("nodeName", ""))

    def remove(self, pod: JSON) -> None:
        from ksim_tpu_torch.state.resources import pod_requests

        info = self._info_of(pod)
        if info is None:
            return
        for r, v in pod_requests(pod).items():
            info["requested"][r] = info["requested"].get(r, 0) - v
        for r, v in pod_requests(pod, non_zero=True).items():
            info["nonzero_requested"][r] = info["nonzero_requested"].get(r, 0) - v
        info["pod_count"] -= 1
        key = (namespace_of(pod), name_of(pod))
        self.pbn[info["name"]] = [
            p
            for p in self.pbn.get(info["name"], [])
            if (namespace_of(p), name_of(p)) != key
        ]

    def add(self, pod: JSON) -> None:
        from ksim_tpu_torch.state.resources import pod_requests

        info = self._info_of(pod)
        if info is None:
            return
        for r, v in pod_requests(pod).items():
            info["requested"][r] = info["requested"].get(r, 0) + v
        for r, v in pod_requests(pod, non_zero=True).items():
            info["nonzero_requested"][r] = info["nonzero_requested"].get(r, 0) + v
        info["pod_count"] += 1
        self.pbn.setdefault(info["name"], []).append(pod)

    def fits(self, pod: JSON, node_idx: int) -> bool:
        """Full default-profile filter check of ``pod`` on one node
        (oracle semantics — exact upstream math)."""
        info = self.infos[node_idx]
        if oracle.node_unschedulable_filter(pod, info):
            return False
        if oracle.node_name_filter(pod, info):
            return False
        if oracle.taint_toleration_filter(pod, info):
            return False
        if oracle.node_affinity_filter(pod, info):
            return False
        if oracle.node_ports_filter(pod, self.pbn.get(info["name"], [])):
            return False
        if oracle.fit_filter(pod, info):
            return False
        if self._check_volumes or pod.get("spec", {}).get("volumes"):
            vols = self.volumes
            node = self.nodes[node_idx]
            on_node = self.pbn.get(info["name"], [])
            if oracle.volume_restrictions_filter(pod, on_node, vols["pvcs"]):
                return False
            if oracle.node_volume_limits_filter(
                pod, node, on_node, vols["pvcs"], vols["pvs"], vols["storage_classes"]
            ):
                return False
            if oracle.volume_binding_filter(
                pod, node, vols["pvcs"], vols["pvs"], vols["storage_classes"]
            ):
                return False
            if oracle.volume_zone_filter(pod, node, vols["pvcs"], vols["pvs"]):
                return False
        if oracle.topology_spread_filter_all(pod, self.infos, self.pbn)[node_idx]:
            return False
        if oracle.inter_pod_affinity_filter_all(
            pod, self.infos, self.pbn, self.namespaces
        )[node_idx]:
            return False
        return True


@dataclass
class Candidate:
    node_index: int
    node_name: str
    victims: list[JSON]  # in MoreImportantPod order


@dataclass
class PreemptionDecision:
    nominated_node: str | None  # None = preemption failed
    victims: list[JSON]


def _select_victims_on_node(
    pod: JSON,
    node_idx: int,
    nodes: Sequence[JSON],
    cluster_pods: Sequence[JSON],
    namespaces: Sequence[JSON],
    volumes: dict | None = None,
    priority_of=pod_priority,
) -> list[JSON] | None:
    """Upstream selectVictimsOnNode: remove all lower-priority pods, check
    feasibility, then reprieve as many as possible in importance order.
    Returns the victim list, or None when the node is not a candidate."""
    node_name = name_of(nodes[node_idx])
    prio = priority_of(pod)
    potential = [
        p
        for p in cluster_pods
        if p.get("spec", {}).get("nodeName") == node_name
        and p.get("status", {}).get("phase") not in ("Succeeded", "Failed")
        and priority_of(p) < prio
    ]
    if not potential:
        return None
    state = _FitState(nodes, cluster_pods, namespaces, volumes)
    for v in potential:
        state.remove(v)
    if not state.fits(pod, node_idx):
        return None
    victims: list[JSON] = []
    # Reprieve in MoreImportantPod order (no PDBs -> single bucket).
    for v in sorted(potential, key=lambda p: _more_important(p, priority_of)):
        state.add(v)
        if not state.fits(pod, node_idx):
            state.remove(v)
            victims.append(v)
    return victims


def _pick_one_node(candidates: list[Candidate], priority_of=pod_priority) -> Candidate:
    """Upstream pickOneNodeForPreemption, PDB criteria degenerate:
    lowest highest-victim-priority, then smallest priority sum, then
    fewest victims, then latest earliest victim start time, then first."""
    best = candidates

    def narrow(keyfn, take_min=True):
        nonlocal best
        vals = [keyfn(c) for c in best]
        target = min(vals) if take_min else max(vals)
        best = [c for c, v in zip(best, vals) if v == target]

    def earliest_high_priority_start(c: Candidate) -> str:
        """util.GetEarliestPodStartTime: the earliest start time among the
        HIGHEST-priority victims only."""
        if not c.victims:
            return ""
        top = max(priority_of(v) for v in c.victims)
        return min(_start_time(v) for v in c.victims if priority_of(v) == top)

    narrow(lambda c: max((priority_of(v) for v in c.victims), default=-(2**31)))
    if len(best) > 1:
        narrow(lambda c: sum(priority_of(v) for v in c.victims))
    if len(best) > 1:
        narrow(lambda c: len(c.victims))
    if len(best) > 1:
        narrow(earliest_high_priority_start, take_min=False)
    return best[0]


def find_preemption(
    pod: JSON,
    nodes: Sequence[JSON],
    cluster_pods: Sequence[JSON],
    *,
    candidate_mask: Sequence[bool] | None = None,
    namespaces: Sequence[JSON] = (),
    volumes: dict | None = None,
    priority_of=pod_priority,
) -> PreemptionDecision:
    """DefaultPreemption for one unschedulable pod.

    ``candidate_mask`` marks nodes whose filter failure is resolvable by
    removing pods (the engine derives it from recorded reason bits via
    each plugin's ``failure_unresolvable``); None means try every node.
    Candidate search is capped like upstream GetOffsetAndNumCandidates
    (10% of nodes, at least 100)."""
    if not pod_eligible_to_preempt(pod):
        return PreemptionDecision(nominated_node=None, victims=[])
    n = len(nodes)
    want = candidate_count(n)
    candidates: list[Candidate] = []
    pods_list = list(cluster_pods)
    for ni in range(n):
        if candidate_mask is not None and not candidate_mask[ni]:
            continue
        victims = _select_victims_on_node(
            pod, ni, nodes, pods_list, namespaces, volumes, priority_of
        )
        if victims is None:
            continue
        candidates.append(
            Candidate(node_index=ni, node_name=name_of(nodes[ni]), victims=victims)
        )
        if len(candidates) >= want:
            break
    if not candidates:
        return PreemptionDecision(nominated_node=None, victims=[])
    chosen = _pick_one_node(candidates, priority_of)
    return PreemptionDecision(
        nominated_node=chosen.node_name, victims=chosen.victims
    )


def render_postfilter_result(
    failed_nodes: Sequence[str], nominated: str | None
) -> dict[str, dict[str, str]]:
    """The postfilter-result annotation body (store.go:439-456): every
    filtered node gets an entry, the nominated one names the plugin."""
    out: dict[str, dict[str, str]] = {name: {} for name in failed_nodes}
    if nominated is not None:
        out[nominated] = {DEFAULT_PREEMPTION: NOMINATED_MESSAGE}
    return out
