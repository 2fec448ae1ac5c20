"""One-shot importer: boot-time cluster replication.

Snap the source cluster through its snapshot service and Load into the
simulator, ignoring per-object errors and any scheduler configuration —
exactly the reference's flow (reference
simulator/oneshotimporter/importer.go:17-59: Snap from the export service,
convert, Load with IgnoreErr + IgnoreSchedulerConfiguration)."""

from __future__ import annotations

from typing import Protocol

from ksim_tpu_torch.state.resources import JSON


class ReplicateService(Protocol):
    """What the importer needs from both sides (SnapshotService shape)."""

    def snap(self, label_selector: JSON | None = None) -> JSON: ...

    def load(self, resources: JSON, *, ignore_err: bool = False,
             ignore_scheduler_configuration: bool = False) -> None: ...


class OneShotImporter:
    def __init__(
        self, import_service: ReplicateService, export_service: ReplicateService
    ) -> None:
        self._import = import_service  # into the simulator
        self._export = export_service  # from the source cluster

    def import_cluster_resources(self, label_selector: JSON | None = None) -> None:
        """Snap the source, load into the simulator.  Scheduler config is
        never taken from the source (importer.go:44-59 note)."""
        resources = self._export.snap(label_selector)
        self._import.load(
            resources, ignore_err=True, ignore_scheduler_configuration=True
        )
