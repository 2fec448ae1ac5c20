"""TaintToleration filter + score.

Upstream kube-scheduler v1.30 ``plugins/tainttoleration/taint_toleration.go``:

- Filter: the first taint with effect NoSchedule/NoExecute (in node taint
  order) not tolerated by the pod fails the node with
  ``node(s) had untolerated taint {<key>: <value>}``.
- Score: count of PreferNoSchedule taints not tolerated by the pod's
  tolerations with effect ""/PreferNoSchedule; normalized with
  DefaultNormalizeScore(MaxNodeScore, reverse=true).

Toleration matching runs host-side (state/encoding.py encode_taints);
the plugin works on the distinct-taint vocabulary: ``reason_bits`` holds
``w + 1`` of the first untolerated taint (0 == passed) so the exact
upstream message is reconstructable.
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
from ksim_tpu_torch.state.encoding import TaintTensors

NAME = "TaintToleration"
_BIG = torch.iinfo(torch.int32).max


def forbidding_taints_tolerated(aux, pods: PodView) -> torch.Tensor:
    """bool [B, N]: no untolerated NoSchedule/NoExecute taint — the
    predicate PodTopologySpread's Honor nodeTaintsPolicy consults."""
    a = aux["taints"]
    order = a["node_taint_order"][None]  # [1, N, W]
    tolerated = a["pod_tolerated"][pods.index][:, None, :]  # [B, 1, W]
    bad = (order > 0) & a["forbidding"][None, None, :] & ~tolerated
    return ~bad.any(dim=2)


class TaintToleration:
    final_score_bound = 100  # post-normalize max (MaxNodeScore)
    name = NAME

    def __init__(self, taints: TaintTensors) -> None:
        self._taints = taints  # host-side vocab for decode
        # The reason is a 1-based INDEX into the taint vocabulary (not a
        # bit mask), so the width the engine's dtype downcast may rely on
        # is the vocabulary size's bit length (engine/core.py).
        self.reason_bit_width = (taints.n_taints + 1).bit_length()

    def static_sig(self) -> tuple:
        return (NAME,)  # the vocab only feeds host-side decode

    def failure_unresolvable(self, bits: int) -> bool:
        # Upstream returns UnschedulableAndUnresolvable for untolerated
        # NoSchedule/NoExecute taints.
        return True

    def filter(self, state: NodeStateView, pods: PodView, aux) -> FilterOutput:
        a = aux["taints"]
        order = a["node_taint_order"][None]  # [1, N, W]
        tolerated = a["pod_tolerated"][pods.index][:, None, :]  # [B, 1, W]
        bad = (order > 0) & a["forbidding"][None, None, :] & ~tolerated
        first = torch.where(bad, order, _BIG).amin(dim=2)  # [B, N]
        blocked = first != _BIG
        # The lowest taint index sitting at that position (argmax returns
        # the first maximal entry).
        at_first = ((order == first[..., None]) & bad).to(torch.uint8)
        w_idx = at_first.argmax(dim=2).to(torch.int32)
        reason = torch.where(blocked, w_idx + 1, 0).to(torch.int32)
        return FilterOutput(ok=~blocked, reason_bits=reason)

    def decode_reasons(self, bits: int) -> list[str]:
        if bits == 0:
            return []
        t = self._taints.taints[bits - 1]
        return [f"node(s) had untolerated taint {{{t['key']}: {t['value']}}}"]

    def raw_dtype(self, exact: bool) -> torch.dtype:
        return torch.int32

    def score(self, state: NodeStateView, pods: PodView, aux, ok=None, *, exact=True):
        a = aux["taints"]
        order = a["node_taint_order"][None]
        tolerated = a["pod_tolerated_prefer"][pods.index][:, None, :]
        intolerable = (order > 0) & a["prefer"][None, None, :] & ~tolerated
        return intolerable.sum(dim=2, dtype=torch.int32)

    def normalize(
        self, scores: torch.Tensor, ok: torch.Tensor, *, pods=None, aux=None, exact=True
    ) -> torch.Tensor:
        """DefaultNormalizeScore(MaxNodeScore, reverse=True) over feasible
        nodes (upstream normalizes the scored-node list only)."""
        mx = torch.where(ok, scores, 0).amax(dim=1, keepdim=True)
        scaled = floordiv_nonneg(MAX_NODE_SCORE * scores, mx.clamp_min(1))
        return torch.where(mx > 0, MAX_NODE_SCORE - scaled, MAX_NODE_SCORE).to(
            torch.int32
        )
