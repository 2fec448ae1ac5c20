"""DI container: the single place services are constructed and wired,
mirroring the reference (reference simulator/server/di/di.go:24-71).

The port of ``ksim_tpu/server/di.py``.  ``device`` and ``exact`` go to
the ``SchedulerService``: its engines run on CUDA unless the caller asks
for ``device="cpu"`` (the plain PyTorch versions), and without a card
the constructor raises.  The tenant job plane (``ksim_tpu/jobs``) is not
ported yet: with ``KSIM_JOBS_DIR`` set, and on first use of
``job_manager``, the container raises NotImplementedError naming
``ksim_tpu_torch/jobs``; ``job_manager_if_built`` stays ``None``."""

from __future__ import annotations

import os
from typing import Any

from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.server.reset import ResetService
from ksim_tpu_torch.state.cluster import ClusterStore
from ksim_tpu_torch.state.snapshot import SnapshotService

#: What the job plane's refusals say (the container, and the server's
#: job routes, which answer 501 with it).
JOBS_UNPORTED = (
    "the tenant job plane (ksim_tpu_torch/jobs) is not ported yet; "
    "run jobs on ksim_tpu's server"
)


class DIContainer:
    def __init__(
        self,
        store: ClusterStore | None = None,
        *,
        scheduler_config: dict | None = None,
        registry: dict | None = None,
        record: str = "full",
        start_scheduler: bool = False,
        scheduler_config_path: str | None = None,
        device: "str | None" = None,
        exact: bool = True,
    ) -> None:
        if os.environ.get("KSIM_JOBS_DIR"):
            raise NotImplementedError(f"KSIM_JOBS_DIR is set, but {JOBS_UNPORTED}")
        self.store = store if store is not None else ClusterStore()
        self.scheduler_service = SchedulerService(
            self.store,
            config=scheduler_config,
            registry=registry,
            record=record,
            config_path=scheduler_config_path,
            device=device,
            exact=exact,
        )
        self.snapshot_service = SnapshotService(
            self.store, scheduler_service=self.scheduler_service
        )
        self.reset_service = ResetService(self.store, self.scheduler_service)
        if start_scheduler:
            self.scheduler_service.start()

    @property
    def job_manager(self):
        """The job plane: not ported, so first use raises."""
        raise NotImplementedError(JOBS_UNPORTED)

    @property
    def job_manager_if_built(self):
        """The job plane if anything has built it: never, in the port."""
        return None

    @property
    def extender_service(self) -> Any:
        """The proxy behind /api/v1/extender/<verb>/<id> (server.go:88-93);
        follows the scheduler config (extenders live in
        KubeSchedulerConfiguration.extenders)."""
        svc = self.scheduler_service.extender_service
        return svc if svc else None

    def shutdown(self, timeout: "float | None" = 5.0) -> None:
        """Stop services.  Callers about to EXIT the process should pass a
        generous (or None) timeout: an abandoned loop thread alive during
        runtime teardown can corrupt the heap (SchedulerService.stop)."""
        self.scheduler_service.stop(timeout=timeout)
