"""Kubernetes label-selector and node-selector matching semantics.

Pure-Python (host-side) implementations of the matching rules used across
the snapshot service (label-selector filtered export, reference
simulator/snapshot/snapshot.go:104-140) and the affinity-family plugins.
The batched plugins encode these same rules as tensor ops via the
featurizer's vocabularies; these functions are the parity oracle.

Semantics mirror k8s.io/apimachinery/pkg/apis/meta/v1 LabelSelectorAsSelector
and k8s.io/component-helpers/scheduling/corev1/nodeaffinity.
"""

from __future__ import annotations

from typing import Any

JSON = dict[str, Any]


def match_label_selector(selector: JSON | None, labels: dict[str, str]) -> bool:
    """metav1.LabelSelector match. An empty/None selector matches everything
    (matches metav1.LabelSelectorAsSelector: nil => Nothing is NOT the case
    here — the reference passes a concrete selector struct, where empty
    means Everything)."""
    if not selector:
        return True
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        if not _match_label_expression(expr, labels):
            return False
    return True


def _match_label_expression(expr: JSON, labels: dict[str, str]) -> bool:
    key = expr.get("key", "")
    op = expr.get("operator", "")
    values = expr.get("values") or []
    if op == "In":
        return key in labels and labels[key] in values
    if op == "NotIn":
        # Upstream labels.Requirement.Matches: a NotIn requirement is
        # SATISFIED when the key is absent (selector.go: `if !ls.Has(key)
        # { return true }` for NotIn/NotEquals) — discovered by the
        # independent NodeAffinity operator fixture; presence was wrongly
        # required here before round 3.
        return key not in labels or labels[key] not in values
    if op == "Exists":
        return key in labels
    if op == "DoesNotExist":
        return key not in labels
    raise ValueError(f"unknown label selector operator {op!r}")


def match_node_selector_requirement(req: JSON, labels: dict[str, str]) -> bool:
    """v1.NodeSelectorRequirement on labels: adds Gt/Lt over integer values
    (upstream nodeaffinity.nodeSelectorRequirementsAsSelector)."""
    key = req.get("key", "")
    op = req.get("operator", "")
    values = req.get("values") or []
    if op in ("In", "NotIn", "Exists", "DoesNotExist"):
        return _match_label_expression(
            {"key": key, "operator": op, "values": values}, labels
        )
    if op in ("Gt", "Lt"):
        if key not in labels or len(values) != 1:
            return False
        try:
            lbl = int(labels[key])
            val = int(values[0])
        except ValueError:
            return False
        return lbl > val if op == "Gt" else lbl < val
    raise ValueError(f"unknown node selector operator {op!r}")


def match_node_selector_term(
    term: JSON, node_labels: dict[str, str], node_name: str = ""
) -> bool:
    """One NodeSelectorTerm: AND of matchExpressions (against labels only)
    and matchFields (only metadata.name is supported — upstream
    nodeaffinity.go; a term naming any other field matches nothing).  An
    empty term matches nothing."""
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return False
    for req in exprs:
        if not match_node_selector_requirement(req, node_labels):
            return False
    for req in fields:
        if req.get("key") != "metadata.name":
            return False
        if not match_node_selector_requirement(req, {"metadata.name": node_name}):
            return False
    return True


def match_node_selector_terms(
    terms: list[JSON], node_labels: dict[str, str], node_name: str = ""
) -> bool:
    """NodeSelector: OR over terms; empty list matches nothing."""
    return any(match_node_selector_term(t, node_labels, node_name) for t in terms)
