"""DI container: the single place services are constructed and wired,
mirroring the reference (reference simulator/server/di/di.go:24-71).

The port of ``ksim_tpu/server/di.py``.  ``device`` and ``exact`` go to
the ``SchedulerService`` and to the tenant job plane's ``JobManager``:
their engines run on CUDA unless the caller asks for ``device="cpu"``
(the plain PyTorch versions), and without a card the constructor
raises."""

from __future__ import annotations

import os
import threading
from typing import Any

from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.server.reset import ResetService
from ksim_tpu_torch.state.cluster import ClusterStore
from ksim_tpu_torch.state.snapshot import SnapshotService


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
        self.store = store if store is not None else ClusterStore()
        self._device = device
        self._exact = exact
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
        # The tenant job plane (jobs/) is built LAZILY on first use:
        # constructing it spawns the worker pool, which a container
        # serving only the classic single-cluster surface never needs.
        self._job_manager = None
        self._job_manager_lock = threading.Lock()
        if os.environ.get("KSIM_JOBS_DIR"):
            # The durable job plane replays its journal at construction:
            # a restarted server must know its journaled jobs before the
            # first tenant GET, so the lazy build would leave recovered
            # results 404 until some request forced the manager into
            # being.
            from ksim_tpu_torch.jobs import JobManager

            self._job_manager = JobManager(device=device, exact=exact)
        if start_scheduler:
            self.scheduler_service.start()

    @property
    def job_manager(self):
        """The job plane (jobs.JobManager), built on first access from
        the job-plane environment knobs (docs/env.md "Job plane"), on
        this container's device and mode."""
        with self._job_manager_lock:
            if self._job_manager is None:
                from ksim_tpu_torch.jobs import JobManager

                self._job_manager = JobManager(device=self._device, exact=self._exact)
            return self._job_manager

    @property
    def job_manager_if_built(self):
        """The job plane if anything has used it yet, else None (the
        metrics endpoint reports without forcing worker threads into
        existence)."""
        with self._job_manager_lock:
            return self._job_manager

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
        jm = self.job_manager_if_built
        if jm is not None:
            jm.shutdown(timeout=timeout)
        self.scheduler_service.stop(timeout=timeout)
