"""NodeName filter plugin.

Upstream kube-scheduler v1.30 ``plugins/nodename/node_name.go``: a pod
naming a specific node in ``spec.nodeName`` fails every other node with
``node(s) didn't match the requested node name``; pods without a request
pass everywhere.  Encoding: state/extras.py (requested node index, -2 for
a name not in the snapshot).
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.plugins.base import FilterOutput, NodeStateView, PodView

NAME = "NodeName"
ERR_REASON = "node(s) didn't match the requested node name"


class NodeName:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 1
    name = NAME

    def static_sig(self) -> tuple:
        return (NAME,)

    def failure_unresolvable(self, bits: int) -> bool:
        # Upstream returns UnschedulableAndUnresolvable.
        return True

    def filter(self, state: NodeStateView, pods: PodView, aux) -> FilterOutput:
        req = aux["nodename"]["pod_req_node"][pods.index][:, None]  # [B, 1]
        n = torch.arange(state.valid.shape[0], device=req.device)[None, :]
        ok = (req == -1) | (n == req)
        return FilterOutput(ok=ok, reason_bits=(~ok).to(torch.int32))

    def decode_reasons(self, bits: int) -> list[str]:
        return [ERR_REASON] if bits else []
