"""NodeUnschedulable filter plugin.

Upstream kube-scheduler v1.30 ``plugins/nodeunschedulable/node_unschedulable.go``:
a node with ``spec.unschedulable`` fails the filter unless the pod tolerates
the ``node.kubernetes.io/unschedulable:NoSchedule`` taint.  The toleration
check is a host-side boolean per pod (featurizer), so the filter is a mask
op.  Reason message matches upstream ``ErrReasonUnschedulable``.
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.plugins.base import FilterOutput, NodeStateView, PodView

NAME = "NodeUnschedulable"
ERR_REASON_UNSCHEDULABLE = "node(s) were unschedulable"


class NodeUnschedulable:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 2
    name = NAME

    def filter(self, state: NodeStateView, pods: PodView, aux=None) -> FilterOutput:
        blocked = state.unschedulable[None, :] & ~pods.tolerates_unschedulable[:, None]
        return FilterOutput(ok=~blocked, reason_bits=blocked.to(torch.int32))

    def decode_reasons(self, bits: int) -> list[str]:
        return [ERR_REASON_UNSCHEDULABLE] if bits else []

    def static_sig(self) -> tuple:
        return (NAME,)

    def failure_unresolvable(self, bits: int) -> bool:
        # Upstream returns UnschedulableAndUnresolvable: removing pods
        # cannot un-cordon a node.
        return True
