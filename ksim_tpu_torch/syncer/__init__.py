"""Resource syncer: continuous import from a source cluster.

The reference mirrors a real cluster into the simulator through dynamic
shared informers with mandatory mutators and filters (reference
simulator/syncer/syncer.go:45-208, syncer/resource.go:18-123).  Here the
source is anything store-shaped (list + watch with the ClusterStore event
protocol) — typically another ClusterStore, or an adapter over a real
apiserver."""

from ksim_tpu_torch.syncer.syncer import (
    ADD,
    DEFAULT_KINDS,
    UPDATE,
    Syncer,
    SyncerOptions,
)

__all__ = ["ADD", "DEFAULT_KINDS", "UPDATE", "Syncer", "SyncerOptions"]
