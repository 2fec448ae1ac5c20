"""NodeAffinity filter + score.

Upstream kube-scheduler v1.30 ``plugins/nodeaffinity/node_affinity.go``:

- Filter: pod.spec.nodeSelector (all pairs must match) AND
  requiredDuringSchedulingIgnoredDuringExecution (OR over
  nodeSelectorTerms; a present-but-unmatchable required clause fails).
  Failure message: ``node(s) didn't match Pod's node affinity/selector``.
- Score: sum of weights of matching preferred terms; normalized with
  DefaultNormalizeScore(MaxNodeScore, reverse=false).

Algebra over the term vocabulary (state/encoding.py): a node matches
term t iff its satisfied-requirement count over t's requirement set
equals |t|.  That ``node_req_match @ term_req.T`` product is
pod-independent, so it is computed once per snapshot
(``term_matches``) and stored in the aux tree as ``term_ok``.  Empty
terms have size -1 and can never match (upstream: empty term matches
nothing).
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

NAME = "NodeAffinity"
ERR_REASON_POD = "node(s) didn't match Pod's node affinity/selector"
ERR_REASON_ENFORCED = "node(s) didn't match scheduler-enforced node affinity"
POD_MISMATCH_BIT = 1
ENFORCED_MISMATCH_BIT = 2


def term_matches(a: dict) -> torch.Tensor:
    """bool [N, T]: node matches term.  The count product runs in float32
    (no integer matmul on CUDA); it is exact because every count is a
    sum of 0/1 products below 2^24."""
    counts = a["node_req_match"].to(torch.float32) @ a["term_req"].to(torch.float32).T
    return counts.to(torch.int32) == a["term_size"][None, :]


def required_affinity_match(aux, pods: PodView) -> torch.Tensor:
    """bool [B, N]: node passes the pod's nodeSelector AND required node
    affinity (upstream nodeaffinity.GetRequiredNodeAffinity(pod).Match)."""
    a = aux["affinity"]
    term_ok = a["term_ok"]  # [N, T]
    sel = a["selector_term"][pods.index]  # [B]
    sel_ok = torch.where(sel[:, None] >= 0, term_ok[:, sel.clamp_min(0)].T, True)
    req_set = a["required_terms"][pods.index]  # [B, T]
    req_any = (term_ok[None, :, :] & req_set[:, None, :]).any(dim=2)
    req_ok = torch.where(a["has_required"][pods.index][:, None], req_any, True)
    return sel_ok & req_ok


class NodeAffinity:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 2
    final_score_bound = 100  # post-normalize max (MaxNodeScore)
    name = NAME

    def filter(self, state: NodeStateView, pods: PodView, aux) -> FilterOutput:
        a = aux["affinity"]
        pod_ok = required_affinity_match(aux, pods)
        # Profile-level addedAffinity (NodeAffinityArgs): checked FIRST
        # upstream (node_affinity.go Filter, errReasonEnforced), ANDed for
        # every pod of the profile.
        term_ok = a["term_ok"]
        added_ok = torch.where(
            a["has_added"][0], (term_ok & a["added_terms"][None, :]).any(dim=1), True
        )
        bits = torch.where(added_ok, 0, ENFORCED_MISMATCH_BIT)[None, :] | torch.where(
            pod_ok, 0, POD_MISMATCH_BIT
        )
        return FilterOutput(ok=bits == 0, reason_bits=bits.to(torch.int32))

    def decode_reasons(self, bits: int) -> list[str]:
        # Upstream early-returns on the enforced mismatch, so the pod
        # reason never co-occurs with it in a recorded status.
        if bits & ENFORCED_MISMATCH_BIT:
            return [ERR_REASON_ENFORCED]
        return [ERR_REASON_POD] if bits else []

    def static_sig(self) -> tuple:
        return (NAME,)

    def failure_unresolvable(self, bits: int) -> bool:
        # Upstream returns UnschedulableAndUnresolvable: labels don't
        # change when pods are preempted.
        return True

    def raw_dtype(self, exact: bool) -> torch.dtype:
        # The reference's weight sum promotes to int64 under x64.
        return torch.int64 if exact else torch.int32

    def score(self, state: NodeStateView, pods: PodView, aux, ok=None, *, exact=True):
        a = aux["affinity"]
        term_ok = a["term_ok"].to(torch.int32)  # [N, T]
        # addedAffinity preferred terms score for every pod (upstream
        # node_affinity.go Score: addedPrefSchedTerms).
        weights = a["preferred_weights"][pods.index] + a["added_pref"][None, :]
        out = torch.zeros(
            (weights.shape[0], term_ok.shape[0]),
            dtype=self.raw_dtype(exact),
            device=term_ok.device,
        )
        for t in range(term_ok.shape[1]):
            out += term_ok[None, :, t] * weights[:, t, None]
        return out

    def normalize(
        self, scores: torch.Tensor, ok: torch.Tensor, *, pods=None, aux=None, exact=True
    ) -> torch.Tensor:
        """DefaultNormalizeScore(MaxNodeScore, reverse=False) over feasible
        nodes."""
        mx = torch.where(ok, scores, 0).amax(dim=1, keepdim=True)
        scaled = floordiv_nonneg(MAX_NODE_SCORE * scores, mx.clamp_min(1))
        return torch.where(mx > 0, scaled, scores).to(torch.int32)
