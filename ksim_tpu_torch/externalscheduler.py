"""Deprecated external-scheduler SDK (compat shim).

The reference keeps ``pkg/externalscheduler`` as a deprecated older
surface next to ``pkg/debuggablescheduler`` (reference
simulator/pkg/externalscheduler/external_scheduler.go:39 deprecation
note).  This module mirrors that arrangement: the same capabilities,
re-exported under the old names, emitting DeprecationWarning.  New code
uses ksim_tpu_torch.scheduler.service / ksim_tpu_torch.cmd.scheduler directly.
"""

from __future__ import annotations

import warnings

from ksim_tpu_torch.scheduler.profile import Builder  # noqa: F401 (compat)
from ksim_tpu_torch.scheduler.service import SchedulerService


def new_scheduler(store, *, config=None, registry=None, **kw) -> SchedulerService:
    """Deprecated: construct the debuggable scheduler service (the
    reference's externalscheduler.NewSchedulerCommand analogue)."""
    warnings.warn(
        "ksim_tpu_torch.externalscheduler is deprecated; use "
        "ksim_tpu_torch.scheduler.service.SchedulerService",
        DeprecationWarning,
        stacklevel=2,
    )
    return SchedulerService(store, config=config, registry=registry, **kw)
