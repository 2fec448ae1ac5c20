"""Common types for the plugin chain on torch tensors.

A plugin evaluates a BLOCK of B pods against all N nodes at once: every
per-pod tensor carries a leading pod axis ([B, ...]) and every result is
[B, N].  This is ``ksim_tpu``'s vmap over pods written out as a batch
dimension; the sequential-commit scan uses B = 1.

Reason codes: filters return an int32 code per node (0 == passed); the
meaning is plugin-specific and decoded host-side into the upstream
status messages for the result annotations.

Normalizes share one signature, ``normalize(raw, ok, *, pods, aux,
exact)``; a plugin that needs only the raw scores and the mask ignores
the rest.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# framework.MaxNodeScore — the single definition for the package.
MAX_NODE_SCORE = 100


def floordiv_nonneg(a: torch.Tensor, b) -> torch.Tensor:
    """``a // b`` for a >= 0 and b > 0, where floor division (the
    reference's ``//``) and C++'s truncating ``/`` (the kernels') agree.
    Every integer division of the ported plugins is written so that its
    operands are non-negative; this checks it."""
    b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    valid = (a >= 0).all() & (b > 0).all()
    if a.is_cuda:
        torch._assert_async(valid)  # no host sync
    elif not bool(valid):
        raise AssertionError("integer division with a negative operand")
    return torch.div(a, b, rounding_mode="floor")


class NodeStateView(NamedTuple):
    """Per-node tensors visible to plugins.

    Static across a scheduling run: allocatable, allowed_pods, valid,
    unschedulable.  Carried by the scan: requested, nonzero_requested,
    pod_count.
    """

    allocatable: torch.Tensor  # i32 [N, R]
    allowed_pods: torch.Tensor  # i32 [N]
    valid: torch.Tensor  # bool [N]
    unschedulable: torch.Tensor  # bool [N]
    requested: torch.Tensor  # i32 [N, R]
    nonzero_requested: torch.Tensor  # i32 [N, R]
    pod_count: torch.Tensor  # i32 [N]

    def commit(
        self, node_idx: torch.Tensor, pod_req: torch.Tensor, pod_nz: torch.Tensor
    ) -> "NodeStateView":
        """Charge one pod to node ``node_idx`` (a 0-d tensor; no-op when
        it is negative).  Returns a new view; ``self`` is unchanged."""
        n = self.pod_count.shape[0]
        onehot = (torch.arange(n, device=self.pod_count.device) == node_idx) & (
            node_idx >= 0
        )
        hot = onehot.to(torch.int32)
        return self._replace(
            requested=self.requested + hot[:, None] * pod_req[None, :],
            nonzero_requested=self.nonzero_requested + hot[:, None] * pod_nz[None, :],
            pod_count=self.pod_count + hot,
        )


class PodView(NamedTuple):
    """A block of B pods as plugins see them (leading dim B on every leaf)."""

    requests: torch.Tensor  # i32 [B, R]
    nonzero_requests: torch.Tensor  # i32 [B, R]
    tolerates_unschedulable: torch.Tensor  # bool [B]
    has_requests: torch.Tensor  # bool [B] (upstream fitsRequest early-exit)
    index: torch.Tensor  # i32 [B] — rows into per-pod aux tensors


class PodBatch(NamedTuple):
    """The pod axis (leading dim P on every leaf)."""

    requests: torch.Tensor  # i32 [P, R]
    nonzero_requests: torch.Tensor  # i32 [P, R]
    valid: torch.Tensor  # bool [P]
    tolerates_unschedulable: torch.Tensor  # bool [P]
    has_requests: torch.Tensor  # bool [P]
    index: torch.Tensor  # i32 [P] == arange(P)

    def rows(self, lo: int, hi: int) -> "PodBatch":
        """Pods ``lo:hi`` (views: contiguous when the batch is)."""
        return PodBatch(*(x[lo:hi] for x in self))

    def view(self) -> PodView:
        return PodView(
            requests=self.requests,
            nonzero_requests=self.nonzero_requests,
            tolerates_unschedulable=self.tolerates_unschedulable,
            has_requests=self.has_requests,
            index=self.index,
        )


class FilterOutput(NamedTuple):
    ok: torch.Tensor  # bool [B, N]
    reason_bits: torch.Tensor  # i32 [B, N], 0 == passed
