"""Volume-family filter plugins: VolumeBinding, VolumeZone,
NodeVolumeLimits, VolumeRestrictions.

Upstream kube-scheduler v1.30 semantics over the snapshot model's
pvs/pvcs/storageClasses (encoding and documented simplifications in
state/volumes.py).  All four are filter-only in the default profile
(VolumeBinding's capacity score is gated behind an alpha feature).
Every per-pod check is an any-hit of a [N, X] boolean matrix against the
pod's [X] row; the attach/usage state changed by scheduling rides the
scan carries (NodeVolumeLimits saturates at 1, VolumeRestrictions adds).
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.plugins.base import FilterOutput, NodeStateView, PodView
from ksim_tpu_torch.state.volumes import VolumeTensors

VOLUME_BINDING = "VolumeBinding"
VOLUME_ZONE = "VolumeZone"
NODE_VOLUME_LIMITS = "NodeVolumeLimits"
VOLUME_RESTRICTIONS = "VolumeRestrictions"

# VolumeBinding (volume_binding.go / binder.go)
ERR_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"
ERR_PVC_NOT_FOUND = "persistentvolumeclaim not found"
ERR_NODE_CONFLICT = "node(s) had volume node affinity conflict"
ERR_BIND_CONFLICT = "node(s) didn't find available persistent volumes to bind"
UNBOUND_IMMEDIATE_BIT = 1
PVC_MISSING_BIT = 2
NODE_CONFLICT_BIT = 4
BIND_CONFLICT_BIT = 8

# VolumeZone (volume_zone.go)
ERR_ZONE_CONFLICT = "node(s) had no available volume zone"

# NodeVolumeLimits (nodevolumelimits csi.go/non_csi.go)
ERR_MAX_VOLUME_COUNT = "node(s) exceed max volume count"

# VolumeRestrictions (volume_restrictions.go)
ERR_DISK_CONFLICT = "node(s) had no available disk"
ERR_RWOP_CONFLICT = (
    "node has pod using PersistentVolumeClaim with the same name and "
    "ReadWriteOncePod access mode"
)
DISK_CONFLICT_BIT = 1
RWOP_CONFLICT_BIT = 2


def _any_hit(node_mat: torch.Tensor, pod_rows: torch.Tensor) -> torch.Tensor:
    """bool [B, N]: some x with node_mat[n, x] and pod_rows[b, x]."""
    return (node_mat[None, :, :] & pod_rows[:, None, :]).any(dim=2)


def _hits(node_mat: torch.Tensor, pod_rows: torch.Tensor) -> torch.Tensor:
    """i32 [B, N]: the number of such x."""
    return (node_mat[None, :, :] & pod_rows[:, None, :]).sum(dim=2, dtype=torch.int32)


def _onehot(carry: torch.Tensor, best) -> torch.Tensor:
    """i32 [N, 1]: 1 on row ``best`` (a 0-d tensor), none when negative."""
    n = torch.arange(carry.shape[0], device=carry.device)
    return ((n == best) & (best >= 0)).to(carry.dtype)[:, None]


class VolumeBinding:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 4
    name = VOLUME_BINDING

    def __init__(self, vt: VolumeTensors) -> None:
        del vt

    def static_sig(self) -> tuple:
        return (VOLUME_BINDING,)

    def failure_unresolvable(self, bits: int) -> bool:
        return True  # upstream: all UnschedulableAndUnresolvable

    def filter(self, state: NodeStateView, pods: PodView, aux) -> FilterOutput:
        a = aux["volumes"]
        j = pods.index
        # Bound PVs whose node affinity rejects the node.
        node_conf = _any_hit(~a["pv_node_ok"].T, a["pod_pv"][j])
        # WFFC claims with neither a candidate PV on the node nor dynamic
        # provisioning.
        unsat = ~(a["pvc_cand_ok"] | a["pvc_provisionable"][:, None])  # [C, N]
        bind_conf = _any_hit(unsat.T, a["pod_wffc"][j])
        # pod_fail's bit layout matches UNBOUND_IMMEDIATE_BIT/PVC_MISSING_BIT.
        code = (
            a["pod_fail"][j][:, None]
            + torch.where(node_conf, NODE_CONFLICT_BIT, 0)
            + torch.where(bind_conf, BIND_CONFLICT_BIT, 0)
        ).to(torch.int32)
        return FilterOutput(ok=code == 0, reason_bits=code)

    def decode_reasons(self, bits: int) -> list[str]:
        out = []
        if bits & UNBOUND_IMMEDIATE_BIT:
            out.append(ERR_UNBOUND_IMMEDIATE)
        if bits & PVC_MISSING_BIT:
            out.append(ERR_PVC_NOT_FOUND)
        if bits & NODE_CONFLICT_BIT:
            out.append(ERR_NODE_CONFLICT)
        if bits & BIND_CONFLICT_BIT:
            out.append(ERR_BIND_CONFLICT)
        return out


class VolumeZone:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 1
    name = VOLUME_ZONE

    def __init__(self, vt: VolumeTensors) -> None:
        del vt

    def static_sig(self) -> tuple:
        return (VOLUME_ZONE,)

    def failure_unresolvable(self, bits: int) -> bool:
        return True  # upstream: UnschedulableAndUnresolvable

    def filter(self, state: NodeStateView, pods: PodView, aux) -> FilterOutput:
        a = aux["volumes"]
        conflict = _any_hit(~a["pv_zone_ok"].T, a["pod_pv"][pods.index])
        return FilterOutput(ok=~conflict, reason_bits=conflict.to(torch.int32))

    def decode_reasons(self, bits: int) -> list[str]:
        return [ERR_ZONE_CONFLICT] if bits else []


class NodeVolumeLimits:
    """Attach-limit filter over one or all attachable-volumes-* pools.

    ``NodeVolumeLimits`` covers every pool (upstream v1.30's CSI plugin
    counts migrated in-tree volumes too); the legacy registry names
    (EBSLimits, GCEPDLimits, AzureDiskLimits, CinderLimits) are instances
    restricted to their one pool via ``pools``.  The kernels take any
    number of instances (kernels/chain.py profile_tables)."""

    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 1

    def __init__(
        self,
        vt: VolumeTensors,
        *,
        name: str = NODE_VOLUME_LIMITS,
        pools: tuple[str, ...] | None = None,
    ) -> None:
        self.name = name
        self.pool_ids = tuple(
            k
            for k, pool in enumerate(vt.pool_names[: int(vt.n_pools)])
            if pools is None or pool in pools
        )

    def static_sig(self) -> tuple:
        return (NODE_VOLUME_LIMITS, self.name, self.pool_ids)

    def failure_unresolvable(self, bits: int) -> bool:
        return False  # evicting pods detaches volumes

    def carry_init(self, aux) -> torch.Tensor:
        return aux["volumes"]["attached_init"]  # i32 [N, V]

    def carry_commit(self, carry, aux, pods: PodView, best) -> torch.Tensor:
        uses = aux["volumes"]["pod_vol"][pods.index[0]].to(carry.dtype)  # [V]
        # Attachment is unique per (volume, node): saturate at 1.
        return torch.maximum(carry, _onehot(carry, best) * uses[None, :])

    def filter(self, state: NodeStateView, pods: PodView, aux, carry) -> FilterOutput:
        a = aux["volumes"]
        attached = carry > 0  # [N, V]
        pod_vol = a["pod_vol"][pods.index]  # [B, V]
        over = torch.zeros((pod_vol.shape[0], carry.shape[0]), dtype=torch.bool, device=carry.device)
        for k in self.pool_ids:
            in_pool = a["vol_key"] == k  # [V]
            used = (attached & in_pool[None, :]).sum(dim=1, dtype=torch.int32)  # [N]
            new = _hits(~attached, pod_vol & in_pool[None, :])  # [B, N] dedup'd
            limit = a["limits"][:, k]
            over = over | ((limit >= 0)[None, :] & (used[None, :] + new > limit[None, :]))
        return FilterOutput(ok=~over, reason_bits=over.to(torch.int32))

    def decode_reasons(self, bits: int) -> list[str]:
        return [ERR_MAX_VOLUME_COUNT] if bits else []


class VolumeRestrictions:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 2
    name = VOLUME_RESTRICTIONS

    def __init__(self, vt: VolumeTensors) -> None:
        del vt

    def static_sig(self) -> tuple:
        return (VOLUME_RESTRICTIONS,)

    def failure_unresolvable(self, bits: int) -> bool:
        return False  # upstream: Unschedulable (preemptable)

    def carry_init(self, aux) -> dict:
        a = aux["volumes"]
        return {"rwop": a["rwop_init"], "disk_any": a["disk_any_init"], "disk_rw": a["disk_rw_init"]}

    def carry_commit(self, carry, aux, pods: PodView, best) -> dict:
        a = aux["volumes"]
        j = pods.index[0]
        hot = _onehot(carry["rwop"], best)

        def add(c, uses):
            return c + hot * uses.to(torch.int32)[None, :]

        return {
            "rwop": add(carry["rwop"], a["pod_rwop"][j]),
            "disk_any": add(carry["disk_any"], a["pod_disk_any"][j]),
            "disk_rw": add(carry["disk_rw"], a["pod_disk_rw"][j]),
        }

    def filter(self, state: NodeStateView, pods: PodView, aux, carry) -> FilterOutput:
        a = aux["volumes"]
        j = pods.index
        # ReadWriteOncePod: any other user of the claim on the node.
        rwop = _any_hit(carry["rwop"] > 0, a["pod_rwop"][j])
        # Disk conflicts (isVolumeConflict): EBS never shares; GCE/ISCSI/
        # RBD share only when BOTH uses are read-only.
        share = a["disk_ro_shareable"][None, :]
        pod_any = a["pod_disk_any"][j]
        pod_rw = a["pod_disk_rw"][j]
        any_used = carry["disk_any"] > 0
        rw_used = carry["disk_rw"] > 0
        disk = (
            _any_hit(any_used, pod_any & ~share)
            | _any_hit(any_used, pod_rw & share)
            | _any_hit(rw_used, pod_any & ~pod_rw & share)
        )
        code = torch.where(disk, DISK_CONFLICT_BIT, 0) + torch.where(rwop, RWOP_CONFLICT_BIT, 0)
        return FilterOutput(ok=code == 0, reason_bits=code.to(torch.int32))

    def decode_reasons(self, bits: int) -> list[str]:
        out = []
        if bits & DISK_CONFLICT_BIT:
            out.append(ERR_DISK_CONFLICT)
        if bits & RWOP_CONFLICT_BIT:
            out.append(ERR_RWOP_CONFLICT)
        return out
