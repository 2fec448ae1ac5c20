"""Pure-Python parity oracle for every plugin.

Direct, slow, obviously-correct re-derivations of upstream kube-scheduler
v1.30 plugin code paths over Python ints (int64 semantics) and floats (IEEE
double, same as Go float64).  The batched JAX kernels are tested
golden-style against these (SURVEY.md section 4: "golden-file parity tests
... against a pure-Python reference implementation of each plugin").

The oracle operates on NodeInfo dicts built by ``build_node_infos`` —
the analogue of the upstream scheduler cache NodeInfo.

The oracle is also the parity source of truth for PREEMPTION's fit
re-checks: scheduler/preemption.py's host victim search runs this
module's filters directly (``_FitState.fits``), and the device-resident
victim search (engine/replay.py) re-checks fits through the compiled
kernels — exactness there rests on the kernel<->oracle parity tests
plus a lowering gate that the profile's filter set matches the fit
chain (preemption.ORACLE_FIT_FILTER_NAMES).  Changing any filter's
semantics here must change the kernel AND the hand-derived fixtures
under tests/fixtures/ together.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

from ksim_tpu_torch.state.resources import (
    CPU,
    EPHEMERAL_STORAGE,
    JSON,
    MEMORY,
    PODS,
    name_of,
    pod_is_scheduled,
    pod_node_name,
    pod_requests,
)

from ksim_tpu_torch.plugins.base import MAX_NODE_SCORE
from ksim_tpu_torch.state.resources import BASE_RESOURCES

NodeInfo = dict[str, Any]


def build_node_infos(nodes: Sequence[JSON], pods: Sequence[JSON]) -> list[NodeInfo]:
    """NodeInfo accumulation: bound, non-terminal pods charge their node."""
    from ksim_tpu_torch.state.resources import node_allocatable

    infos: list[NodeInfo] = []
    by_name: dict[str, NodeInfo] = {}
    for n in nodes:
        alloc = node_allocatable(n)
        info: NodeInfo = {
            "node": n,
            "name": name_of(n),
            "allocatable": {r: v for r, v in alloc.items() if r != PODS},
            "allowed_pods": alloc.get(PODS, 0),
            "requested": {},
            "nonzero_requested": {},
            "pod_count": 0,
        }
        infos.append(info)
        by_name[info["name"]] = info
    for p in pods:
        if not pod_is_scheduled(p):
            continue
        if p.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            continue
        info = by_name.get(pod_node_name(p))
        if info is None:
            continue
        for r, v in pod_requests(p).items():
            info["requested"][r] = info["requested"].get(r, 0) + v
        for r, v in pod_requests(p, non_zero=True).items():
            info["nonzero_requested"][r] = info["nonzero_requested"].get(r, 0) + v
        info["pod_count"] += 1
    return infos


def commit_pod(info: NodeInfo, pod: JSON) -> None:
    """Charge a newly scheduled pod to a NodeInfo (Reserve-phase commit)."""
    for r, v in pod_requests(pod).items():
        info["requested"][r] = info["requested"].get(r, 0) + v
    for r, v in pod_requests(pod, non_zero=True).items():
        info["nonzero_requested"][r] = info["nonzero_requested"].get(r, 0) + v
    info["pod_count"] += 1


# -- NodeUnschedulable ------------------------------------------------------


def node_unschedulable_filter(pod: JSON, info: NodeInfo) -> list[str]:
    """Upstream node_unschedulable.go Filter."""
    from ksim_tpu_torch.state.resources import (
        node_unschedulable,
        pod_tolerations,
        tolerations_tolerate_taint,
    )
    from ksim_tpu_torch.state.resources import UNSCHEDULABLE_TAINT

    if not node_unschedulable(info["node"]):
        return []
    if tolerations_tolerate_taint(pod_tolerations(pod), UNSCHEDULABLE_TAINT):
        return []
    return ["node(s) were unschedulable"]


# -- TaintToleration --------------------------------------------------------


def taint_toleration_filter(pod: JSON, info: NodeInfo) -> list[str]:
    """Upstream taint_toleration.go Filter (FindMatchingUntoleratedTaint
    over NoSchedule/NoExecute taints, node order)."""
    from ksim_tpu_torch.state.resources import node_taints, pod_tolerations, untolerated_taint

    taint = untolerated_taint(node_taints(info["node"]), pod_tolerations(pod))
    if taint is None:
        return []
    return [
        f"node(s) had untolerated taint {{{taint.get('key', '')}: {taint.get('value', '')}}}"
    ]


def taint_toleration_score(pod: JSON, info: NodeInfo) -> int:
    """Upstream countIntolerableTaintsPreferNoSchedule: PreferNoSchedule
    taints not tolerated by the pod's ""/PreferNoSchedule tolerations."""
    from ksim_tpu_torch.state.resources import (
        node_taints,
        pod_tolerations,
        tolerations_tolerate_taint,
    )

    tols = [
        t
        for t in pod_tolerations(pod)
        if (t.get("effect") or "") in ("", "PreferNoSchedule")
    ]
    count = 0
    for taint in node_taints(info["node"]):
        if taint.get("effect") != "PreferNoSchedule":
            continue
        if not tolerations_tolerate_taint(tols, taint):
            count += 1
    return count


# -- NodeAffinity ------------------------------------------------------------


def node_affinity_filter(
    pod: JSON, info: NodeInfo, added_affinity: JSON | None = None
) -> list[str]:
    """Upstream node_affinity.go Filter: the profile's enforced
    addedAffinity first (early return, errReasonEnforced), then
    nodeSelector AND required terms."""
    from ksim_tpu_torch.state.selectors import match_node_selector_terms

    node = info["node"]
    labels = dict(node.get("metadata", {}).get("labels") or {})
    if added_affinity:
        added_req = added_affinity.get(
            "requiredDuringSchedulingIgnoredDuringExecution"
        )
        if added_req is not None and not match_node_selector_terms(
            added_req.get("nodeSelectorTerms") or [], labels, info["name"]
        ):
            return ["node(s) didn't match scheduler-enforced node affinity"]
    spec = pod.get("spec", {})
    ns = spec.get("nodeSelector")
    if ns:
        for k, v in ns.items():
            if labels.get(k) != v:
                return ["node(s) didn't match Pod's node affinity/selector"]
    aff = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    required = aff.get("requiredDuringSchedulingIgnoredDuringExecution")
    if required is not None:
        if not match_node_selector_terms(
            required.get("nodeSelectorTerms") or [], labels, info["name"]
        ):
            return ["node(s) didn't match Pod's node affinity/selector"]
    return []


def node_affinity_score(
    pod: JSON, info: NodeInfo, added_affinity: JSON | None = None
) -> int:
    """Upstream node_affinity.go Score: sum of matching preferred weights
    (pod terms plus the profile's addedAffinity preferred terms)."""
    from ksim_tpu_torch.state.selectors import match_node_selector_term

    node = info["node"]
    labels = dict(node.get("metadata", {}).get("labels") or {})
    aff = (pod.get("spec", {}).get("affinity") or {}).get("nodeAffinity") or {}
    score = 0
    pref = list(aff.get("preferredDuringSchedulingIgnoredDuringExecution") or [])
    if added_affinity:
        pref += list(
            added_affinity.get("preferredDuringSchedulingIgnoredDuringExecution")
            or []
        )
    for pt in pref:
        w = int(pt.get("weight", 0))
        if w == 0:
            continue
        if match_node_selector_term(pt.get("preference") or {}, labels, info["name"]):
            score += w
    return score


# -- PodTopologySpread -------------------------------------------------------


def _spread_constraints(pod: JSON, mode: str) -> list[JSON]:
    want = "DoNotSchedule" if mode == "filter" else "ScheduleAnyway"
    out = []
    for con in pod.get("spec", {}).get("topologySpreadConstraints") or []:
        if con.get("whenUnsatisfiable", "DoNotSchedule") == want:
            out.append(con)
    return out


def _spread_selector(con: JSON, pod: JSON) -> JSON:
    from ksim_tpu_torch.state.encoding import _effective_selector

    return _effective_selector(con, pod)


def _spread_node_eligible(pod: JSON, info: NodeInfo, con: JSON) -> bool:
    """Per-constraint inclusion policies (NodeInclusionPolicy on,
    defaults Honor affinity / Ignore taints)."""
    from ksim_tpu_torch.state.resources import node_taints, pod_tolerations, untolerated_taint

    if (con.get("nodeAffinityPolicy") or "Honor") == "Honor":
        if node_affinity_filter(pod, info):
            return False
    if (con.get("nodeTaintsPolicy") or "Ignore") == "Honor":
        if untolerated_taint(node_taints(info["node"]), pod_tolerations(pod)) is not None:
            return False
    return True


def _count_matching(info: NodeInfo, all_pods_by_node, ns: str, sel: JSON) -> int:
    from ksim_tpu_torch.state.selectors import match_label_selector
    from ksim_tpu_torch.state.resources import labels_of, namespace_of

    count = 0
    for p in all_pods_by_node.get(info["name"], []):
        if (namespace_of(p) or "default") != ns:
            continue
        if match_label_selector(sel, labels_of(p)):
            count += 1
    return count


def _node_has_keys(info: NodeInfo, cons: list[JSON]) -> bool:
    from ksim_tpu_torch.state.resources import labels_of

    lbls = labels_of(info["node"])
    return all(c.get("topologyKey", "") in lbls for c in cons)


def topology_spread_filter_all(
    pod: JSON, infos: list[NodeInfo], all_pods_by_node: dict
) -> list[list[str]]:
    """Upstream filtering.go: per-node failure reasons (empty = pass)."""
    from ksim_tpu_torch.state.resources import labels_of, namespace_of
    from ksim_tpu_torch.state.selectors import match_label_selector

    cons = _spread_constraints(pod, "filter")
    if not cons:
        return [[] for _ in infos]
    ns = namespace_of(pod) or "default"
    out: list[list[str]] = []
    # Domain stats per constraint over eligible nodes with all filter keys.
    per_con: list[dict] = []
    for con in cons:
        sel = _spread_selector(con, pod)
        counts: dict[str, int] = {}
        for info in infos:
            if not _node_has_keys(info, cons):
                continue
            if not _spread_node_eligible(pod, info, con):
                continue
            v = labels_of(info["node"]).get(con.get("topologyKey", ""))
            counts[v] = counts.get(v, 0) + _count_matching(info, all_pods_by_node, ns, sel)
        min_match = min(counts.values()) if counts else 0
        min_domains = int(con.get("minDomains") or 0)
        if min_domains > 0 and len(counts) < min_domains:
            min_match = 0
        per_con.append(
            {
                "con": con,
                "sel": sel,
                "counts": counts,
                "min_match": min_match,
                "self": match_label_selector(sel, labels_of(pod)),
            }
        )
    for info in infos:
        reasons: list[str] = []
        lbls = labels_of(info["node"])
        for pc in per_con:
            tk = pc["con"].get("topologyKey", "")
            if tk not in lbls:
                reasons = [
                    "node(s) didn't match pod topology spread constraints (missing required label)"
                ]
                break
            match_num = pc["counts"].get(lbls[tk], 0)
            skew = match_num + (1 if pc["self"] else 0) - pc["min_match"]
            if skew > int(pc["con"].get("maxSkew", 1)):
                reasons = ["node(s) didn't match pod topology spread constraints"]
                break
        out.append(reasons)
    return out


def topology_spread_score_all(
    pod: JSON,
    infos: list[NodeInfo],
    all_pods_by_node: dict,
    feasible: list[bool],
) -> tuple[list[int], list[int]]:
    """Upstream scoring.go: (raw, normalized) per node.  ``feasible`` marks
    nodes that passed the whole framework filter (PreScore's
    filteredNodes)."""
    import math as _math

    from ksim_tpu_torch.state.resources import labels_of, namespace_of
    from ksim_tpu_torch.state.selectors import match_label_selector

    n = len(infos)
    cons = _spread_constraints(pod, "score")
    if not cons:
        # PreScore returns Skip: the plugin contributes nothing.
        return [0] * n, [0] * n
    ns = namespace_of(pod) or "default"
    ignored = [not _node_has_keys(info, cons) for info in infos]
    per_con = []
    for con in cons:
        sel = _spread_selector(con, pod)
        registered: set[str] = set()
        for i, info in enumerate(infos):
            if feasible[i] and not ignored[i]:
                v = labels_of(info["node"]).get(con.get("topologyKey", ""))
                if v is not None:
                    registered.add(v)
        counts: dict[str, int] = {v: 0 for v in registered}
        for info in infos:
            if not _spread_node_eligible(pod, info, con):
                continue
            v = labels_of(info["node"]).get(con.get("topologyKey", ""))
            if v in counts:
                counts[v] += _count_matching(info, all_pods_by_node, ns, sel)
        per_con.append(
            {
                "con": con,
                "counts": counts,
                "tp_weight": _math.log(len(registered) + 2),
            }
        )
    raw = []
    for i, info in enumerate(infos):
        if not feasible[i] or ignored[i]:
            raw.append(0)
            continue
        lbls = labels_of(info["node"])
        total = 0.0
        for pc in per_con:
            v = lbls.get(pc["con"].get("topologyKey", ""))
            if v in pc["counts"]:
                total += pc["counts"][v] * pc["tp_weight"] + (
                    int(pc["con"].get("maxSkew", 1)) - 1
                )
        raw.append(int(round(total)))
    scoreable = [raw[i] for i in range(n) if feasible[i] and not ignored[i]]
    mx = max(scoreable, default=0)
    mn = min(scoreable, default=0)
    norm = []
    for i in range(n):
        if ignored[i] or not feasible[i]:
            norm.append(0)
            continue
        if mx == 0:
            norm.append(MAX_NODE_SCORE)
        else:
            norm.append(MAX_NODE_SCORE * (mx + mn - raw[i]) // mx)
    return raw, norm


# -- InterPodAffinity --------------------------------------------------------


def _ipa_required(pod: JSON, kind: str) -> list[JSON]:
    aff = (pod.get("spec", {}).get("affinity") or {}).get(kind) or {}
    return list(aff.get("requiredDuringSchedulingIgnoredDuringExecution") or [])


def _ipa_preferred(pod: JSON, kind: str) -> list[JSON]:
    aff = (pod.get("spec", {}).get("affinity") or {}).get(kind) or {}
    return list(aff.get("preferredDuringSchedulingIgnoredDuringExecution") or [])


def _ipa_term_matches(term: JSON, owner: JSON, other: JSON, ns_labels: dict) -> bool:
    from ksim_tpu_torch.state.interpod import context_matches, term_context
    from ksim_tpu_torch.state.resources import namespace_of

    ctx = term_context(term, namespace_of(owner) or "default")
    return context_matches(ctx, other, ns_labels)


def _ipa_has_affinity(pod: JSON) -> bool:
    from ksim_tpu_torch.state.interpod import has_any_affinity

    return has_any_affinity(pod)


def inter_pod_affinity_filter_all(
    pod: JSON,
    infos: list[NodeInfo],
    all_pods_by_node: dict,
    namespaces: Sequence[JSON] = (),
) -> list[list[str]]:
    """Upstream filtering.go: per-node failure reasons (empty = pass),
    first failing check only (Filter returns on first violation)."""
    from ksim_tpu_torch.state.resources import labels_of

    ns_labels = {name_of(ns): dict(labels_of(ns)) for ns in namespaces}
    aff_terms = _ipa_required(pod, "podAffinity")
    anti_terms = _ipa_required(pod, "podAntiAffinity")

    # PreFilter count maps: topologyPair -> matched term count.
    affinity_counts: dict[tuple[str, str], int] = {}
    anti_counts: dict[tuple[str, str], int] = {}
    existing_anti_counts: dict[tuple[str, str], int] = {}
    for info in infos:
        node_lbls = labels_of(info["node"])
        for ep in all_pods_by_node.get(info["name"], []):
            for t in aff_terms:
                tk = t.get("topologyKey", "")
                if tk in node_lbls and _ipa_term_matches(t, pod, ep, ns_labels):
                    key = (tk, node_lbls[tk])
                    affinity_counts[key] = affinity_counts.get(key, 0) + 1
            for t in anti_terms:
                tk = t.get("topologyKey", "")
                if tk in node_lbls and _ipa_term_matches(t, pod, ep, ns_labels):
                    key = (tk, node_lbls[tk])
                    anti_counts[key] = anti_counts.get(key, 0) + 1
            for t in _ipa_required(ep, "podAntiAffinity"):
                tk = t.get("topologyKey", "")
                if tk in node_lbls and _ipa_term_matches(t, ep, pod, ns_labels):
                    key = (tk, node_lbls[tk])
                    existing_anti_counts[key] = existing_anti_counts.get(key, 0) + 1

    self_match = bool(aff_terms) and all(
        _ipa_term_matches(t, pod, pod, ns_labels) for t in aff_terms
    )

    out: list[list[str]] = []
    for info in infos:
        node_lbls = labels_of(info["node"])
        # (1) satisfyPodAffinity.
        pods_exist = True
        missing_key = False
        for t in aff_terms:
            tk = t.get("topologyKey", "")
            if tk in node_lbls:
                if affinity_counts.get((tk, node_lbls[tk]), 0) <= 0:
                    pods_exist = False
            else:
                missing_key = True
                break
        ok_aff = not missing_key and (
            pods_exist or (len(affinity_counts) == 0 and self_match)
        )
        if not ok_aff:
            out.append(["node(s) didn't match pod affinity rules"])
            continue
        # (2) satisfyPodAntiAffinity.
        viol = any(
            t.get("topologyKey", "") in node_lbls
            and anti_counts.get(
                (t.get("topologyKey", ""), node_lbls[t.get("topologyKey", "")]), 0
            )
            > 0
            for t in anti_terms
        )
        if viol:
            out.append(["node(s) didn't match pod anti-affinity rules"])
            continue
        # (3) satisfyExistingPodsAntiAffinity.
        viol = any(
            node_lbls.get(tk) == val and cnt > 0
            for (tk, val), cnt in existing_anti_counts.items()
        )
        if viol:
            out.append(["node(s) didn't satisfy existing pods' anti-affinity rules"])
            continue
        out.append([])
    return out


def inter_pod_affinity_score_all(
    pod: JSON,
    infos: list[NodeInfo],
    all_pods_by_node: dict,
    feasible: list[bool],
    namespaces: Sequence[JSON] = (),
    hard_weight: int = 1,
) -> tuple[list[int], list[int]]:
    """Upstream scoring.go: (raw, normalized) per node; non-feasible nodes
    (absent from the upstream score list) get 0."""
    from ksim_tpu_torch.state.resources import labels_of

    ns_labels = {name_of(ns): dict(labels_of(ns)) for ns in namespaces}
    pref_aff = _ipa_preferred(pod, "podAffinity")
    pref_anti = _ipa_preferred(pod, "podAntiAffinity")
    has_constraints = bool(pref_aff) or bool(pref_anti)

    topo: dict[tuple[str, str], int] = {}

    def add(term: JSON, owner: JSON, to_check: JSON, node_lbls: dict, w: int) -> None:
        tk = term.get("topologyKey", "")
        if tk in node_lbls and _ipa_term_matches(term, owner, to_check, ns_labels):
            key = (tk, node_lbls[tk])
            topo[key] = topo.get(key, 0) + w

    for info in infos:
        node_lbls = labels_of(info["node"])
        for ep in all_pods_by_node.get(info["name"], []):
            if not has_constraints and not _ipa_has_affinity(ep):
                continue  # podsToProcess = PodsWithAffinity
            for wt in pref_aff:
                add(wt.get("podAffinityTerm") or {}, pod, ep, node_lbls, int(wt.get("weight", 0)))
            for wt in pref_anti:
                add(wt.get("podAffinityTerm") or {}, pod, ep, node_lbls, -int(wt.get("weight", 0)))
            if hard_weight > 0:
                for t in _ipa_required(ep, "podAffinity"):
                    add(t, ep, pod, node_lbls, hard_weight)
            for wt in _ipa_preferred(ep, "podAffinity"):
                add(wt.get("podAffinityTerm") or {}, ep, pod, node_lbls, int(wt.get("weight", 0)))
            for wt in _ipa_preferred(ep, "podAntiAffinity"):
                add(wt.get("podAffinityTerm") or {}, ep, pod, node_lbls, -int(wt.get("weight", 0)))

    raw = []
    for i, info in enumerate(infos):
        if not feasible[i]:
            raw.append(0)
            continue
        node_lbls = labels_of(info["node"])
        raw.append(
            sum(cnt for (tk, val), cnt in topo.items() if node_lbls.get(tk) == val)
        )
    feas_scores = [raw[i] for i in range(len(infos)) if feasible[i]]
    norm = [0] * len(infos)
    if feas_scores:
        mn, mx = min(feas_scores), max(feas_scores)
        diff = mx - mn
        for i in range(len(infos)):
            if feasible[i] and diff > 0:
                norm[i] = int(float(MAX_NODE_SCORE) * (float(raw[i] - mn) / float(diff)))
    return raw, norm


# -- normalization helper ----------------------------------------------------


def default_normalize_score(
    scores: list[int], *, reverse: bool, max_priority: int = MAX_NODE_SCORE
) -> list[int]:
    """Upstream helper.DefaultNormalizeScore over a scored-node list."""
    max_count = max(scores, default=0)
    if max_count == 0:
        if reverse:
            return [max_priority] * len(scores)
        return list(scores)
    out = []
    for s in scores:
        s = max_priority * s // max_count
        if reverse:
            s = max_priority - s
        out.append(s)
    return out


# -- NodeResourcesFit -------------------------------------------------------


def fit_filter(pod: JSON, info: NodeInfo) -> list[str]:
    """Upstream fit.go fitsRequest: returns insufficient-resource reasons
    (empty == fits)."""
    reasons: list[str] = []
    if info["pod_count"] + 1 > info["allowed_pods"]:
        reasons.append("Too many pods")
    req = pod_requests(pod)
    # Early exit iff base requests are zero AND no scalar-resource key is
    # present — a zero-valued extended-resource key still populates
    # ScalarResources upstream and defeats the early return.
    if all(req.get(r, 0) == 0 for r in BASE_RESOURCES) and not any(
        k not in BASE_RESOURCES for k in req
    ):
        return reasons
    alloc = info["allocatable"]
    used = info["requested"]
    for r in BASE_RESOURCES:
        if req.get(r, 0) > alloc.get(r, 0) - used.get(r, 0):
            reasons.append(f"Insufficient {r}")
    # Extended resources in sorted order — upstream iterates a Go map
    # (random order); we canonicalize to the featurizer's sorted resource
    # axis so kernel and oracle agree on reason ordering.
    for r in sorted(req):
        v = req[r]
        if r in BASE_RESOURCES or v == 0:
            continue
        if v > alloc.get(r, 0) - used.get(r, 0):
            reasons.append(f"Insufficient {r}")
    return reasons


def least_allocated_score(
    pod: JSON,
    info: NodeInfo,
    resources: tuple[tuple[str, int], ...] = ((CPU, 1), (MEMORY, 1)),
) -> int:
    """Upstream least_allocated.go leastResourceScorer."""
    pod_nz = pod_requests(pod, non_zero=True)
    node_score = 0
    weight_sum = 0
    for r, weight in resources:
        allocatable = info["allocatable"].get(r, 0)
        if allocatable == 0:
            continue
        requested = info["nonzero_requested"].get(r, 0) + pod_nz.get(r, 0)
        if requested > allocatable:
            s = 0
        else:
            s = ((allocatable - requested) * MAX_NODE_SCORE) // allocatable
        node_score += s * weight
        weight_sum += weight
    if weight_sum == 0:
        return 0
    return node_score // weight_sum


def most_allocated_score(
    pod: JSON,
    info: NodeInfo,
    resources: tuple[tuple[str, int], ...] = ((CPU, 1), (MEMORY, 1)),
) -> int:
    """Upstream most_allocated.go mostResourceScorer."""
    pod_nz = pod_requests(pod, non_zero=True)
    node_score = 0
    weight_sum = 0
    for r, weight in resources:
        allocatable = info["allocatable"].get(r, 0)
        if allocatable == 0:
            continue
        requested = info["nonzero_requested"].get(r, 0) + pod_nz.get(r, 0)
        # Requests above capacity clamp (pods with no requests get minimums).
        s = (min(requested, allocatable) * MAX_NODE_SCORE) // allocatable
        node_score += s * weight
        weight_sum += weight
    if weight_sum == 0:
        return 0
    return node_score // weight_sum


def _broken_linear(shape: tuple[tuple[int, int], ...], p: int) -> int:
    """Upstream helper/shape_score.go BuildBrokenLinearFunction (scores
    already scaled x10).  Go integer division truncates toward zero."""
    for i, (u, s) in enumerate(shape):
        if p <= u:
            if i == 0:
                return s
            u_p, s_p = shape[i - 1]
            num = (s - s_p) * (p - u_p)
            den = u - u_p
            q = num // den if num >= 0 else -((-num) // den)
            return s_p + q
    return shape[-1][1]


def requested_to_capacity_ratio_score(
    pod: JSON,
    info: NodeInfo,
    shape: tuple[tuple[int, int], ...],
    resources: tuple[tuple[str, int], ...] = ((CPU, 1), (MEMORY, 1)),
) -> int:
    """Upstream requested_to_capacity_ratio.go
    buildRequestedToCapacityRatioScorerFunction: shape scores pre-scaled
    x10; zero-capacity/overcommit evaluate the shape at maxUtilization;
    only positive resource scores enter the weight sum; the final average
    is math.Round of a float division (exact for our int magnitudes)."""
    pod_nz = pod_requests(pod, non_zero=True)
    scaled = tuple((u, s * 10) for u, s in shape)
    node_score = 0
    weight_sum = 0
    for r, weight in resources:
        allocatable = info["allocatable"].get(r, 0)
        if allocatable == 0:
            continue
        requested = info["nonzero_requested"].get(r, 0) + pod_nz.get(r, 0)
        if requested > allocatable:
            util = MAX_NODE_SCORE
        else:
            util = (requested * MAX_NODE_SCORE) // allocatable
        s = _broken_linear(scaled, util)
        if s > 0:
            node_score += s * weight
            weight_sum += weight
    if weight_sum == 0:
        return 0
    # math.Round(n / d) for n >= 0 == (2n + d) // (2d).
    return (2 * node_score + weight_sum) // (2 * weight_sum)


def balanced_allocation_score(
    pod: JSON,
    info: NodeInfo,
    resources: tuple[str, ...] = (CPU, MEMORY),
) -> int:
    """Upstream balanced_allocation.go balancedResourceScorer (float64)."""
    pod_nz = pod_requests(pod, non_zero=True)
    fractions: list[float] = []
    total = 0.0
    for r in resources:
        allocatable = info["allocatable"].get(r, 0)
        if allocatable == 0:
            continue
        requested = info["nonzero_requested"].get(r, 0) + pod_nz.get(r, 0)
        fraction = float(requested) / float(allocatable)
        if fraction > 1:
            fraction = 1.0
        total += fraction
        fractions.append(fraction)
    std = 0.0
    if len(fractions) == 2:
        std = abs((fractions[0] - fractions[1]) / 2)
    elif len(fractions) > 2:
        mean = total / len(fractions)
        std = math.sqrt(sum((f - mean) ** 2 for f in fractions) / len(fractions))
    return int((1 - std) * float(MAX_NODE_SCORE))


# -- NodeName ---------------------------------------------------------------


def node_name_filter(pod: JSON, info: NodeInfo) -> list[str]:
    """Upstream nodename/node_name.go Fits."""
    from ksim_tpu_torch.plugins.nodename import ERR_REASON

    want = pod.get("spec", {}).get("nodeName") or ""
    if not want or want == info["name"]:
        return []
    return [ERR_REASON]


# -- NodePorts --------------------------------------------------------------


def node_ports_filter(pod: JSON, pods_on_node: Sequence[JSON]) -> list[str]:
    """Upstream nodeports/node_ports.go Fits over the node's existing
    pods' (hostIP, protocol, hostPort) triples."""
    from ksim_tpu_torch.plugins.nodeports import ERR_REASON
    from ksim_tpu_torch.state.extras import _host_ports, ports_conflict

    wants = _host_ports(pod)
    if not wants:
        return []
    existing = [t for p in pods_on_node for t in _host_ports(p)]
    for w in wants:
        for e in existing:
            if ports_conflict(w, e):
                return [ERR_REASON]
    return []


# -- ImageLocality ----------------------------------------------------------


def build_image_states(nodes: Sequence[JSON]) -> dict[str, tuple[int, int]]:
    """normalized image name -> (sizeBytes, numNodes) — the scheduler
    cache's ImageStateSummary."""
    from ksim_tpu_torch.state.extras import normalized_image_name

    sizes: dict[str, int] = {}
    num: dict[str, int] = {}
    for node in nodes:
        seen: set[str] = set()
        for img in node.get("status", {}).get("images") or []:
            sz = int(img.get("sizeBytes") or 0)
            for nm in img.get("names") or []:
                key = normalized_image_name(nm)
                if key in seen:
                    continue
                seen.add(key)
                sizes[key] = max(sizes.get(key, 0), sz)
                num[key] = num.get(key, 0) + 1
    return {k: (sizes[k], num[k]) for k in sizes}


def image_locality_score(
    pod: JSON,
    node: JSON,
    image_states: dict[str, tuple[int, int]],
    total_nodes: int,
) -> int:
    """Upstream imagelocality/image_locality.go Score (sumImageScores +
    calculatePriority), float64 exact."""
    from ksim_tpu_torch.state.extras import normalized_image_name

    node_images = {
        normalized_image_name(nm)
        for img in node.get("status", {}).get("images") or []
        for nm in img.get("names") or []
    }
    containers = pod.get("spec", {}).get("containers") or []
    sum_scores = 0
    for c in containers:
        name = normalized_image_name(c.get("image") or "")
        if name in node_images and name in image_states:
            size, nn = image_states[name]
            # Go evaluates size * (nn/total): the spread ratio FIRST, so
            # the float64 rounding point matches (int(size*nn/total) can
            # differ by 1 at ~1-in-4000 triples).
            sum_scores += int(float(size) * (float(nn) / float(total_nodes)))
    from ksim_tpu_torch.plugins.imagelocality import MAX_CONTAINER_THRESHOLD, MIN_THRESHOLD

    max_threshold = MAX_CONTAINER_THRESHOLD * len(containers)
    clamped = min(max(sum_scores, MIN_THRESHOLD), max(max_threshold, MIN_THRESHOLD))
    denom = max_threshold - MIN_THRESHOLD
    if denom <= 0:
        return 0
    return int(MAX_NODE_SCORE * (clamped - MIN_THRESHOLD) / denom)


# -- Volume family ----------------------------------------------------------
# Pure-Python counterparts of plugins/volumes.py (same scoped semantics,
# state/volumes.py docstring documents the simplifications).


def _volume_claims(pod: JSON, pvcs_by_key: dict) -> tuple[list[JSON], int]:
    """(resolved PVC objects, pod_fail code 0|1 unbound-immediate|2 missing)
    — ignores storage-class context; callers refine."""
    from ksim_tpu_torch.state.volumes import _pvc_name, _pod_volumes
    from ksim_tpu_torch.state.resources import namespace_of

    ns = namespace_of(pod) or "default"
    out, fail = [], 0
    for vol in _pod_volumes(pod):
        claim = _pvc_name(pod, vol)
        if claim is None:
            continue
        pvc = pvcs_by_key.get(f"{ns}/{claim}")
        if pvc is None:
            fail = fail or 2
            continue
        out.append(pvc)
    return out, fail


def volume_binding_filter(
    pod: JSON, node: JSON, pvcs: Sequence[JSON], pvs: Sequence[JSON],
    storage_classes: Sequence[JSON],
) -> list[str]:
    from ksim_tpu_torch.plugins.volumes import (
        ERR_BIND_CONFLICT,
        ERR_NODE_CONFLICT,
        ERR_PVC_NOT_FOUND,
        ERR_UNBOUND_IMMEDIATE,
    )
    from ksim_tpu_torch.state.volumes import (
        NO_PROVISIONER,
        _pv_affinity_admits,
        _pv_matches_claim,
    )
    from ksim_tpu_torch.state.resources import namespace_of

    pvcs_by_key = {f"{namespace_of(c)}/{name_of(c)}": c for c in pvcs}
    pv_by_name = {name_of(v): v for v in pvs}
    sc_by_name = {name_of(s): s for s in storage_classes}
    claims, fail = _volume_claims(pod, pvcs_by_key)
    reasons = []
    if fail == 2:
        reasons.append(ERR_PVC_NOT_FOUND)
    node_conf = bind_conf = unbound = False
    for pvc in claims:
        spec = pvc.get("spec") or {}
        bound = spec.get("volumeName") or ""
        sc = sc_by_name.get(spec.get("storageClassName") or "")
        mode = (sc or {}).get("volumeBindingMode") or "Immediate"
        if bound:
            pv = pv_by_name.get(bound)
            if pv is None:
                if ERR_PVC_NOT_FOUND not in reasons:
                    reasons.append(ERR_PVC_NOT_FOUND)
            elif not _pv_affinity_admits(pv, node):
                node_conf = True
        elif mode == "Immediate":
            unbound = True
        else:
            provisionable = bool(
                sc and (sc.get("provisioner") or "") not in ("", NO_PROVISIONER)
            )
            has_cand = any(
                _pv_matches_claim(pv, pvc) and _pv_affinity_admits(pv, node)
                for pv in pvs
            )
            if not (provisionable or has_cand):
                bind_conf = True
    if unbound:
        reasons.insert(0, ERR_UNBOUND_IMMEDIATE)
    if node_conf:
        reasons.append(ERR_NODE_CONFLICT)
    if bind_conf:
        reasons.append(ERR_BIND_CONFLICT)
    return reasons


def volume_zone_filter(
    pod: JSON, node: JSON, pvcs: Sequence[JSON], pvs: Sequence[JSON]
) -> list[str]:
    from ksim_tpu_torch.plugins.volumes import ERR_ZONE_CONFLICT
    from ksim_tpu_torch.state.volumes import _pv_zone_admits
    from ksim_tpu_torch.state.resources import labels_of, namespace_of

    pvcs_by_key = {f"{namespace_of(c)}/{name_of(c)}": c for c in pvcs}
    pv_by_name = {name_of(v): v for v in pvs}
    claims, _fail = _volume_claims(pod, pvcs_by_key)
    node_labels = dict(labels_of(node))
    for pvc in claims:
        bound = (pvc.get("spec") or {}).get("volumeName") or ""
        pv = pv_by_name.get(bound)
        if pv is not None and not _pv_zone_admits(pv, node_labels):
            return [ERR_ZONE_CONFLICT]
    return []


def volume_restrictions_filter(
    pod: JSON, pods_on_node: Sequence[JSON], pvcs: Sequence[JSON]
) -> list[str]:
    from ksim_tpu_torch.plugins.volumes import ERR_DISK_CONFLICT, ERR_RWOP_CONFLICT
    from ksim_tpu_torch.state.volumes import DISK_SOURCES, _pod_volumes, _pvc_name
    from ksim_tpu_torch.state.resources import namespace_of

    pvcs_by_key = {f"{namespace_of(c)}/{name_of(c)}": c for c in pvcs}

    def rwop_claims(p):
        ns = namespace_of(p) or "default"
        out = set()
        for vol in _pod_volumes(p):
            claim = _pvc_name(p, vol)
            if claim is None:
                continue
            pvc = pvcs_by_key.get(f"{ns}/{claim}")
            modes = set(((pvc or {}).get("spec") or {}).get("accessModes") or [])
            if "ReadWriteOncePod" in modes:
                out.add(f"{ns}/{claim}")
        return out

    def disks(p):
        out = []
        for vol in _pod_volumes(p):
            for src, id_field, ro_share in DISK_SOURCES:
                s = vol.get(src)
                if s and s.get(id_field):
                    out.append((src, str(s[id_field]), not s.get("readOnly"), ro_share))
        return out

    reasons = []
    mine = rwop_claims(pod)
    existing = set()
    for p in pods_on_node:
        existing |= rwop_claims(p)
    my_disks = disks(pod)
    node_disks = [d for p in pods_on_node for d in disks(p)]
    disk_conf = False
    for src, vid, rw, ro_share in my_disks:
        for esrc, evid, erw, _ in node_disks:
            if (src, vid) != (esrc, evid):
                continue
            if not ro_share or rw or erw:
                disk_conf = True
    if disk_conf:
        reasons.append(ERR_DISK_CONFLICT)
    if mine & existing:
        reasons.append(ERR_RWOP_CONFLICT)
    return reasons


def node_volume_limits_filter(
    pod: JSON,
    node: JSON,
    pods_on_node: Sequence[JSON],
    pvcs: Sequence[JSON],
    pvs: Sequence[JSON],
    storage_classes: Sequence[JSON],
    pools: tuple[str, ...] | None = None,
) -> list[str]:
    """``pools`` restricts the check to the named attachable-volumes-*
    suffixes — the legacy one-type plugins (EBSLimits, GCEPDLimits,
    AzureDiskLimits, CinderLimits; upstream nodevolumelimits/non_csi.go);
    None is the all-pool NodeVolumeLimits behavior."""
    from ksim_tpu_torch.plugins.volumes import ERR_MAX_VOLUME_COUNT
    from ksim_tpu_torch.state.volumes import (
        DISK_SOURCES,
        LIMIT_ONLY_SOURCES,
        SOURCE_POOL,
        _csi_pool,
        _pod_volumes,
        _pvc_name,
        _pv_source_id,
    )
    from ksim_tpu_torch.state.resources import namespace_of

    pvcs_by_key = {f"{namespace_of(c)}/{name_of(c)}": c for c in pvcs}
    pv_by_name = {name_of(v): v for v in pvs}
    sc_by_name = {name_of(s): s for s in storage_classes}

    def pooled_volumes(p):
        """set of (pool, volume-id) the pod attaches."""
        ns = namespace_of(p) or "default"
        out = set()
        for vol in _pod_volumes(p):
            claim = _pvc_name(p, vol)
            if claim is not None:
                pvc = pvcs_by_key.get(f"{ns}/{claim}")
                if not pvc:
                    continue
                pv = pv_by_name.get((pvc.get("spec") or {}).get("volumeName") or "")
                if not pv:
                    continue
                src, _vid = _pv_source_id(pv)
                sc = sc_by_name.get((pvc.get("spec") or {}).get("storageClassName") or "")
                pool = SOURCE_POOL.get(src) if src else None
                pool = pool or _csi_pool(pv, sc)
                if pool:
                    out.add((pool, f"pv:{name_of(pv)}"))
                continue
            for src, id_field, _ro in DISK_SOURCES:
                s = vol.get(src)
                if s and s.get(id_field) and SOURCE_POOL.get(src):
                    out.add((SOURCE_POOL[src], f"{src}:{s[id_field]}"))
            for src, id_field in LIMIT_ONLY_SOURCES:
                s = vol.get(src)
                if s and s.get(id_field) and SOURCE_POOL.get(src):
                    out.add((SOURCE_POOL[src], f"{src}:{s[id_field]}"))
        return out

    alloc = node.get("status", {}).get("allocatable") or {}
    limits = {
        k.removeprefix("attachable-volumes-"): int(v)
        for k, v in alloc.items()
        if k.startswith("attachable-volumes-")
    }
    attached: dict[str, set] = {}
    for p in pods_on_node:
        for pool, vid in pooled_volumes(p):
            attached.setdefault(pool, set()).add(vid)
    # Accumulate the pod's volumes per pool BEFORE comparing: a pod
    # attaching several new volumes must fit as a whole (the kernel sums
    # used + new the same way).
    want: dict[str, set] = {}
    for pool, vid in pooled_volumes(pod):
        want.setdefault(pool, set()).add(vid)
    for pool, vids in want.items():
        if pools is not None and pool not in pools:
            continue
        if pool in limits and len(attached.get(pool, set()) | vids) > limits[pool]:
            return [ERR_MAX_VOLUME_COUNT]
    return []
