"""Simulator HTTP server: the product's API surface.

Mirrors the reference's echo server route-for-route (reference
simulator/server/server.go:44-54) over the in-memory ClusterStore and the
batch-evaluating scheduler service."""

from ksim_tpu_torch.server.di import DIContainer
from ksim_tpu_torch.server.http import SimulatorServer
from ksim_tpu_torch.server.reset import ResetService

__all__ = ["DIContainer", "ResetService", "SimulatorServer"]
