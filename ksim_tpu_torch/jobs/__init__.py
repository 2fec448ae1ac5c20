"""Tenant job plane: queue + worker pool + per-job isolation planes.

The port of ``ksim_tpu/jobs``.  See jobs/manager.py for the subsystem
docstring (and how a job reaches the card), docs/jobs.md for the API,
queue semantics and tenancy model, and jobs/fleet.py for the
multi-worker fleet (lease-claimed jobs over one shared journal)."""

from ksim_tpu_torch.jobs.fleet import FileLock, FleetMember, JournalTailer, LeasePlane
from ksim_tpu_torch.jobs.journal import JobJournal
from ksim_tpu_torch.jobs.manager import (
    JOB_FAULT_SITES,
    TERMINAL_STATES,
    Job,
    JobLimitExceeded,
    JobManager,
    JobThrottled,
    parse_job_faults,
)
from ksim_tpu_torch.jobs.queue import JobQueue, JobQueueFull

__all__ = [
    "JOB_FAULT_SITES",
    "TERMINAL_STATES",
    "FileLock",
    "FleetMember",
    "Job",
    "JobJournal",
    "JobLimitExceeded",
    "JobManager",
    "JobQueue",
    "JobQueueFull",
    "JobThrottled",
    "JournalTailer",
    "LeasePlane",
    "parse_job_faults",
]
