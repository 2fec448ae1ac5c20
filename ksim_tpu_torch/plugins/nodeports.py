"""NodePorts filter plugin.

Upstream kube-scheduler v1.30 ``plugins/nodeports/node_ports.go``: each of
the pod's requested host ports must be free on the node; conflicts follow
(protocol, port, hostIP-with-0.0.0.0-wildcard) semantics.  Failure reason:
``node(s) didn't have free ports for the requested pod ports``.

Encoding: state/extras.py builds a vocabulary of the queue pods' wanted
(ip, proto, port) triples; the scan carry is the per-node conflict count
per vocab entry, committed with an outer-product add.
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.plugins.base import FilterOutput, NodeStateView, PodView

NAME = "NodePorts"
ERR_REASON = "node(s) didn't have free ports for the requested pod ports"


class NodePorts:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 1
    name = NAME

    def static_sig(self) -> tuple:
        return (NAME,)

    def failure_unresolvable(self, bits: int) -> bool:
        # Upstream returns Unschedulable: evicting the conflicting pod
        # frees the port.
        return False

    def carry_init(self, aux) -> torch.Tensor:
        return aux["nodeports"]["conflict_counts"].clone()  # i32 [N, V]

    def carry_commit(self, carry, aux, pods: PodView, best) -> torch.Tensor:
        """Charge the single pod of ``pods`` to node ``best`` (0-d)."""
        adds = aux["nodeports"]["pod_adds"][pods.index[0]]  # [V]
        onehot = (torch.arange(carry.shape[0], device=carry.device) == best) & (best >= 0)
        return carry + onehot.to(carry.dtype)[:, None] * adds[None, :]

    def filter(self, state: NodeStateView, pods: PodView, aux, carry) -> FilterOutput:
        wants = aux["nodeports"]["pod_wants"][pods.index]  # bool [B, V]
        conflict = ((carry > 0)[None, :, :] & wants[:, None, :]).any(dim=2)  # [B, N]
        ok = ~conflict
        return FilterOutput(ok=ok, reason_bits=conflict.to(torch.int32))

    def decode_reasons(self, bits: int) -> list[str]:
        return [ERR_REASON] if bits else []
