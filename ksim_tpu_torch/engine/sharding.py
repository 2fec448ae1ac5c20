"""Device-mesh layouts of the scheduling engine.

The port of ``ksim_tpu/engine/sharding.py``, under the same names.  The
pod-by-node evaluation has two parallel axes: the pod batch (data
parallel, "dp") and the node axis (tensor parallel, "tp").  The reference
annotates its arrays with ``jax.sharding.NamedSharding`` and lets GSPMD
insert the collectives; here a layout is plain data:

- a ``Mesh`` is an array ``(dp, tp)`` of ``torch.device`` with the axis
  names ``("dp", "tp")``;
- a ``Layout`` (the NamedSharding) is a mesh and one entry per tensor
  axis: "dp", "tp" or None (the PartitionSpec);
- a ``Sharded`` tensor is the list of its shards, one per mesh position in
  row-major order: an axis laid over "tp" is cut into ``tp`` contiguous
  blocks (shard ``r`` holds rows ``[r * n / tp, (r + 1) * n / tp)``, as
  ``P(TP)`` does), one laid over "dp" into ``dp`` blocks, and every other
  axis is whole (replicated).

The node-axis reductions the reference leaves to GSPMD are the kernels'
own exchange between shards (csrc/shard_exchange.cuh, kernels/sharded.py).

Which devices a mesh lists: on a card, distinct visible GPUs; on the CPU,
``CPU_SHARDS`` CPU shards, slices held apart on the one CPU that stand in
for the eight virtual CPU devices the reference's tests run on.  An
explicit ``devices=`` list may name one card more than once: its shards
are then co-resident on that card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ksim_tpu_torch.plugins.base import NodeStateView

DP, TP = "dp", "tp"

# The CPU shards a mesh may list without a card: the reference's tests run
# on eight virtual CPU devices (XLA's host platform device count), so the
# port's CPU tests get as many.
CPU_SHARDS = 8


def _indexed(d: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` is the current one), so that
    equal cards compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (dp, tp) grid of devices with the axis names ("dp", "tp")."""

    def __init__(self, devices: Sequence, shape: tuple[int, int]) -> None:
        dp, tp = shape
        devs = [_indexed(torch.device(d)) for d in devices]
        if len(devs) != dp * tp:
            raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} device(s), got {len(devs)}")
        grid = np.empty((dp, tp), dtype=object)
        for i, d in enumerate(devs):
            grid[i // tp, i % tp] = d
        self.devices = grid
        self.axis_names = (DP, TP)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def dp(self) -> int:
        return int(self.devices.shape[0])

    @property
    def tp(self) -> int:
        return int(self.devices.shape[1])

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i, j]

    def flat(self) -> list[torch.device]:
        """The devices in row-major order (the shards' order)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, tp={self.tp}, devices={[str(d) for d in self.flat()]})"


def available_devices() -> list[torch.device]:
    """The devices a mesh may list by default: the visible GPUs, or
    CPU_SHARDS CPU shards without a card."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * CPU_SHARDS


def make_mesh(n_devices: int | None = None, *, dp: int | None = None, devices: Sequence | None = None) -> Mesh:
    """(dp, tp) mesh over the first n devices; tp gets the larger factor
    since the node axis dominates memory.  ``devices`` names them (one
    card may repeat: co-resident shards); without it the mesh takes the
    visible GPUs, or the CPU shards.  Raises ValueError when there are
    fewer devices than it needs."""
    pool = available_devices() if devices is None else [torch.device(d) for d in devices]
    n = n_devices or len(pool)
    if n > len(pool):
        raise ValueError(f"a mesh of {n} device(s) needs {n} but only {len(pool)} present")
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 2 else 1
    tp = n // dp
    if dp * tp != n:
        raise ValueError(f"cannot factor {n} devices into dp={dp} x tp={tp}")
    return Mesh(pool[:n], (dp, tp))


def fleet_mesh(dp: int, tp: int = 1, devices: Sequence | None = None) -> Mesh:
    """The fleet replay mesh (``KSIM_FLEET_DP``): the stacked trajectory
    (lane) axis lays over ``dp`` devices.  With ``tp == 1`` each lane's
    segment runs whole on one device and only the lane axis splits; with
    ``tp > 1`` each lane's node tensors would also shard over ``tp``
    devices (the 2-D fleet).  Raises if the host has too few devices."""
    pool = available_devices() if devices is None else [torch.device(d) for d in devices]
    if len(pool) < dp * tp:
        raise ValueError(
            f"fleet mesh dp={dp} x tp={tp} needs {dp * tp} device(s) "
            f"but only {len(pool)} present"
        )
    return Mesh(pool[: dp * tp], (dp, tp))


@dataclass(frozen=True)
class Layout:
    """A tensor's layout over a mesh (the reference's NamedSharding): per
    tensor axis the mesh axis it lies over ("dp", "tp") or None."""

    mesh: Mesh
    spec: tuple


@dataclass
class Sharded:
    """A tensor laid out over a mesh: its shards in mesh row-major order
    (shard ``i * tp + j`` on ``mesh.device(i, j)``) and its global shape."""

    layout: Layout
    shards: list
    shape: tuple

    @property
    def mesh(self) -> Mesh:
        return self.layout.mesh

    def shard(self, i: int, j: int) -> torch.Tensor:
        return self.shards[i * self.mesh.tp + j]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, gathered onto ``device`` (default: the first
        shard's)."""
        mesh, spec = self.mesh, self.layout.spec
        device = self.shards[0].device if device is None else torch.device(device)
        rows = []
        for i in range(mesh.dp if DP in spec else 1):
            cols = [self.shard(i, j).to(device) for j in range(mesh.tp if TP in spec else 1)]
            rows.append(torch.cat(cols, dim=spec.index(TP)) if TP in spec else cols[0])
        return torch.cat(rows, dim=spec.index(DP)) if DP in spec else rows[0]


def put(a: torch.Tensor, layout: Layout) -> Sharded:
    """Lay ``a`` out over ``layout`` (the reference's jax.device_put with
    a NamedSharding).  Raises ValueError when a split axis does not divide
    by its mesh axis.  Every shard is its own tensor: a CPU shard never
    aliases another, and a replicated tensor has one copy per device."""
    mesh, spec = layout.mesh, tuple(layout.spec)
    if len(spec) != a.ndim:
        raise ValueError(f"layout {spec} for a tensor of {a.ndim} axes")
    for name in (DP, TP):
        if name in spec:
            ax, k = spec.index(name), mesh.shape[name]
            if a.shape[ax] % k:
                raise ValueError(
                    f"axis {ax} of size {a.shape[ax]} does not divide over {name}={k}"
                )
    copies: dict = {}
    shards = []
    for i in range(mesh.dp):
        for j in range(mesh.tp):
            dev = mesh.device(i, j)
            piece = a
            for name, pos in ((DP, i), (TP, j)):
                if name in spec:
                    ax = spec.index(name)
                    size = a.shape[ax] // mesh.shape[name]
                    piece = piece.narrow(ax, pos * size, size)
            split = DP in spec or TP in spec
            if split or dev.type == "cpu":
                shards.append(piece.to(dev, copy=True).contiguous())
                continue
            # A replicated tensor: one copy per distinct device.
            if dev not in copies:
                copies[dev] = piece.to(dev, copy=True).contiguous()
            shards.append(copies[dev])
    return Sharded(layout, shards, tuple(a.shape))


def _leading(mesh: Mesh, name: str | None, ndim: int) -> Layout:
    if ndim == 0 or name is None:
        return Layout(mesh, (None,) * ndim)
    return Layout(mesh, (name,) + (None,) * (ndim - 1))


def node_state_shardings(mesh: Mesh) -> NodeStateView:
    """Shard every node-axis array over TP; replicate over DP."""
    s1 = Layout(mesh, (TP,))
    s2 = Layout(mesh, (TP, None))
    return NodeStateView(
        allocatable=s2,
        allowed_pods=s1,
        valid=s1,
        unschedulable=s1,
        requested=s2,
        nonzero_requested=s2,
        pod_count=s1,
    )


def shard_pod_batch(pods, mesh: Mesh):
    """Shard every pod-batch leaf over DP (leading axis)."""
    return type(pods)(*(put(a, _leading(mesh, DP, a.ndim)) for a in pods))


def shard_node_state(state: NodeStateView, mesh: Mesh) -> NodeStateView:
    shardings = node_state_shardings(mesh)
    return NodeStateView(*(put(a, s) for a, s in zip(state, shardings)))


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def shard_lane_axis(tree, mesh: Mesh):
    """Lay every leaf's LEADING (lane) axis over the mesh's dp axis;
    later axes stay unsharded (a lane's cluster state lives whole on its
    device: the fleet's dp parallelism is across trajectories, not inside
    one)."""
    return _tree_map(lambda a: put(a, lane_sharding(mesh, a.ndim)), tree)


def replicate_tree(tree, mesh: Mesh):
    """Replicate every leaf across the whole mesh (the fleet's shared
    universe constants: every lane reads the same tables)."""
    return _tree_map(lambda a: put(a, replicated_sharding(mesh, a.ndim)), tree)


def lane_sharding(mesh: Mesh, ndim: int) -> Layout:
    """Layout of a lane-stacked fleet leaf whose trailing axes stay whole
    per lane (pod-axis queue state, scalars): leading (lane) axis over
    ``dp``, the rest replicated."""
    return _leading(mesh, DP, ndim)


def lane_node_sharding(mesh: Mesh, ndim: int) -> Layout:
    """Layout of a lane-stacked ``[S, N, ...]`` node tensor on a 2-D fleet
    mesh: lanes over ``dp``, the node axis (axis 1) over ``tp``."""
    if ndim < 2:
        return lane_sharding(mesh, ndim)
    return Layout(mesh, (DP, TP) + (None,) * (ndim - 2))


def node_leading_sharding(mesh: Mesh, ndim: int) -> Layout:
    """Layout laying a tensor's LEADING axis over ``tp`` (the node axis of
    the device replay's ``[N]`` / ``[N, R]`` state); later axes
    replicated.  Scalars replicate."""
    return _leading(mesh, TP, ndim)


def node_axis_sharding(mesh: Mesh, ndim: int, axis: int) -> Layout:
    """Layout laying one interior axis over ``tp`` (the replay's per-step
    ``[K, N]`` event rank tables shard axis 1, not 0)."""
    spec = [None] * ndim
    spec[axis] = TP
    return Layout(mesh, tuple(spec))


def replicated_sharding(mesh: Mesh, ndim: int) -> Layout:
    """Fully replicated layout (pod-axis and scalar replay state: every
    device needs the whole pod table to score its node shard)."""
    return Layout(mesh, (None,) * ndim)


def shard_aux(aux: dict, axes: dict, mesh: Mesh) -> dict:
    """Shard encoding arrays by their declared leading-axis kind ("node"
    -> TP, "pod" -> DP, None -> replicated): the AXES class variables of
    state/encoding.py."""

    def lay(a, kind):
        name = {"node": TP, "pod": DP}.get(kind)
        return put(a, _leading(mesh, name, a.ndim))

    return _tree_map(lay, aux, axes)


def gather_tree(tree: Any, device=None):
    """Every Sharded leaf of ``tree`` gathered whole onto ``device``."""
    return _tree_map(lambda a: a.full(device) if isinstance(a, Sharded) else a, tree)
