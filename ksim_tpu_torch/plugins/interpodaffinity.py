"""InterPodAffinity filter + score.

Upstream kube-scheduler v1.30 ``plugins/interpodaffinity/{filtering,
scoring}.go``:

- Filter: (1) every required affinity term must have a matching existing
  pod in the candidate node's topology domain — unless NO pod in the
  cluster matches any term and the pod matches its own terms (the
  first-pod-of-a-series escape); a node missing any term's topology key
  fails.  Required terms sharing a topology key share one count
  (upstream topologyToMatchedTermCount is keyed by (key, value)).
  (2) No required anti-affinity term may have a matching pod in the
  domain.  (3) No existing pod's required anti-affinity term that
  matches the incoming pod may have presence in the domain.  The first
  failing check wins (upstream Filter order).
- Score: topology-pair weights from the incoming pod's preferred
  (anti-)affinity terms over matching existing pods and from existing
  pods' terms matched against the incoming pod (required affinity at
  HardPodAffinityWeight, preferred at +-w).  NormalizeScore is
  ``int(100 * (s - min) / (max - min))`` over feasible nodes, all zeros
  when max == min, computed as an integer floor while 100 * (s - min)
  fits int32 and in floating point (float64 exact, float32 f32) beyond.

The carries are the per-node domain-count views of state/interpod.py
(``cnt``/``ecnt``/``ew`` [N, T], plus the cluster-wide ``total`` [T]);
committing a pod adds its term rows to every node in the chosen node's
domain, term by term.
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.plugins.base import (
    MAX_NODE_SCORE,
    FilterOutput,
    NodeStateView,
    PodView,
    floordiv_nonneg,
)
from ksim_tpu_torch.state.interpod import InterPodTensors

NAME = "InterPodAffinity"

ERR_REASON_AFFINITY_RULES_NOT_MATCH = "node(s) didn't match pod affinity rules"
ERR_REASON_ANTI_AFFINITY_RULES_NOT_MATCH = "node(s) didn't match pod anti-affinity rules"
ERR_REASON_EXISTING_ANTI_AFFINITY_RULES_NOT_MATCH = (
    "node(s) didn't satisfy existing pods' anti-affinity rules"
)

AFFINITY_BIT = 1
ANTI_BIT = 2
EXISTING_ANTI_BIT = 4

_BIG = torch.iinfo(torch.int32).max
# Spans of 100 * (s - min) beyond int32 take the floating-point path.
IN_RANGE = _BIG // MAX_NODE_SCORE


def _any_hit(node_mat: torch.Tensor, pod_rows: torch.Tensor) -> torch.Tensor:
    """bool [B, N]: some t with node_mat[n, t] and pod_rows[b, t]."""
    return (node_mat[None, :, :] & pod_rows[:, None, :]).any(dim=2)


def _dot(node_mat: torch.Tensor, pod_rows: torch.Tensor) -> torch.Tensor:
    """i32 [B, N]: sum_t node_mat[n, t] * pod_rows[b, t], wrapping in int32
    as the reference's int32 dot does."""
    return (node_mat[None, :, :] * pod_rows[:, None, :].to(torch.int32)).sum(dim=2, dtype=torch.int32)


class InterPodAffinity:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 3
    final_score_bound = 100  # post-normalize max (MaxNodeScore)
    name = NAME

    def __init__(self, ipa: InterPodTensors) -> None:
        del ipa  # all state flows through aux/carry

    def static_sig(self) -> tuple:
        return (NAME,)

    def failure_unresolvable(self, bits: int) -> bool:
        # Upstream: unmatched required affinity is UnschedulableAndUnresolvable
        # (removing pods can't create matches); anti-affinity violations are
        # Unschedulable (victims can clear them).
        return bool(bits & AFFINITY_BIT)

    def raw_dtype(self, exact: bool) -> torch.dtype:
        return torch.int32

    # -- carried state ------------------------------------------------------

    def carry_init(self, aux) -> dict:
        a = aux["interpod"]
        return {"cnt": a["cnt_node"], "ecnt": a["ecnt_node"], "ew": a["ew_node"], "total": a["total"]}

    def carry_commit(self, carry, aux, pods: PodView, best) -> dict:
        a = aux["interpod"]
        j = pods.index[0]
        dom_t = a["dom_t"]  # [N, T]
        placed = best >= 0
        doms = dom_t[best.clamp_min(0)]  # [T] the chosen node's domain per term
        key_present = (doms >= 0) & placed  # [T]
        mask = ((dom_t == doms[None, :]) & key_present[None, :]).to(torch.int32)  # [N, T]
        qm = a["pod_term_match"][j].to(torch.int32)
        return {
            "cnt": carry["cnt"] + mask * qm[None, :],
            "ecnt": carry["ecnt"] + mask * a["pod_eat"][j][None, :],
            "ew": carry["ew"] + mask * a["pod_vw"][j][None, :],
            "total": carry["total"] + torch.where(key_present, qm, 0),
        }

    # -- filter -------------------------------------------------------------

    def filter(self, state: NodeStateView, pods: PodView, aux, carry) -> FilterOutput:
        a = aux["interpod"]
        j = pods.index
        raff, ranti, qm = a["req_aff"][j], a["req_anti"][j], a["pod_term_match"][j]  # [B, T]
        dom_t, cnt = a["dom_t"], carry["cnt"]
        # (1) required affinity: every term's topology key on the node and,
        # per topology key, the node's domain count over this pod's
        # required terms on that key > 0 — or the escape.
        missing_any = _any_hit(dom_t < 0, raff)
        no_pods_any = torch.zeros_like(missing_any)
        for k in range(a["node_dom"].shape[1]):
            on_key = raff & (a["term_tk"] == k)[None, :]  # [B, T]
            key_cnt = _dot(cnt, on_key)  # [B, N]
            no_pods_any = no_pods_any | (on_key.any(dim=1)[:, None] & (key_cnt <= 0))
        total_req = (carry["total"][None, :] * raff.to(torch.int32)).sum(dim=1, dtype=torch.int32)
        escape = (total_req == 0) & a["self_aff"][j]
        pass_aff = ~missing_any & (~no_pods_any | escape[:, None])
        # (2) incoming required anti-affinity (missing key = satisfied).
        viol_anti = _any_hit(cnt > 0, ranti)
        # (3) existing pods' required anti-affinity vs this pod.
        viol_existing = _any_hit(carry["ecnt"] > 0, qm)
        code = torch.where(
            ~pass_aff,
            AFFINITY_BIT,
            torch.where(viol_anti, ANTI_BIT, torch.where(viol_existing, EXISTING_ANTI_BIT, 0)),
        )
        # Upstream's PreFilter Skip: no required terms and no existing
        # term matching the pod cannot fail.
        pred = (raff | ranti | qm).any(dim=1)
        code = torch.where(pred[:, None], code, 0).to(torch.int32)
        return FilterOutput(ok=code == 0, reason_bits=code)

    def decode_reasons(self, bits: int) -> list[str]:
        if bits & AFFINITY_BIT:
            return [ERR_REASON_AFFINITY_RULES_NOT_MATCH]
        if bits & ANTI_BIT:
            return [ERR_REASON_ANTI_AFFINITY_RULES_NOT_MATCH]
        if bits & EXISTING_ANTI_BIT:
            return [ERR_REASON_EXISTING_ANTI_AFFINITY_RULES_NOT_MATCH]
        return []

    # -- score --------------------------------------------------------------

    def score(self, state: NodeStateView, pods: PodView, aux, ok=None, *, exact=True, carry=None):
        a = aux["interpod"]
        pref_w, qm = a["pref_w"][pods.index], a["pod_term_match"][pods.index]
        return _dot(carry["cnt"], pref_w) + _dot(carry["ew"], qm)

    def normalize(self, scores, ok, *, pods=None, aux=None, exact=True):
        any_ok = ok.any(dim=1, keepdim=True)
        mn = torch.where(any_ok, torch.where(ok, scores, _BIG).amin(dim=1, keepdim=True), 0)
        mx = torch.where(any_ok, torch.where(ok, scores, -_BIG - 1).amax(dim=1, keepdim=True), 0)
        diff = mx - mn  # int32, wrapping as the reference's does
        shifted = scores - mn
        # On a feasible node with diff > 0, 0 <= shifted <= diff: the
        # integer floor sees non-negative operands only.
        live = ok & (diff > 0)
        in_range = shifted < IN_RANGE
        val_int = floordiv_nonneg(torch.where(live & in_range, shifted, 0) * MAX_NODE_SCORE, diff.clamp_min(1))
        ft = torch.float64 if exact else torch.float32
        ratio = torch.where(live, shifted, 0).to(ft) / diff.clamp_min(1).to(ft)
        val_f = torch.floor(MAX_NODE_SCORE * ratio).to(torch.int32)
        out = torch.where(live, torch.where(in_range, val_int, val_f), 0)
        return torch.where((scores != 0).any(dim=1, keepdim=True), out, 0).to(torch.int32)
