"""Bounded priority/cost job queue (stdlib-only).

The port of ``ksim_tpu/jobs/queue.py``, unchanged.

The admission edge of the job plane: ``put`` REFUSES (``JobQueueFull``
-> HTTP 429) instead of blocking — a tenant submitting into a saturated
simulator must get backpressure it can act on, not a hung request
holding an HTTP handler thread.

Ordering (admission by cost): larger
``priority`` pops first; WITHIN a priority band, shortest-job-first by
``cost`` (the manager passes the spec's event count), ties in
submission order.  Pure priority-then-FIFO is the all-default-cost
special case.  SJF is what stops a 50k-event
job from convoying every 6k job behind it on a narrow worker pool.

SJF's classic failure is starvation: a steady stream of short jobs
keeps a long one waiting forever.  The bound: every pop that OVERTAKES
an older same-band entry increments that entry's bypass counter, and an
entry bypassed ``max_bypass`` times pops next regardless of cost — so a
job's wait within its band is bounded by ``max_bypass`` pops, by
construction (``KSIM_JOBS_SJF_BYPASS``; the unit tests pin both the
ordering and the bound).

Cancellation of QUEUED jobs is lazy: the manager flips the job's state
and the worker-side ``get`` hands the entry back anyway — the worker
re-checks and skips it (removing from a heap's middle is O(n) and the
entry is dead weight for at most one pop).
"""

from __future__ import annotations

import heapq
import threading
from typing import Any

__all__ = ["JobQueue", "JobQueueFull"]

#: Default starvation bound: a same-band entry is overtaken at most
#: this many times before it pops regardless of cost.
DEFAULT_MAX_BYPASS = 4


class JobQueueFull(Exception):
    """The bounded queue refused a submission (HTTP 429 upstream)."""


class JobQueue:
    """Thread-safe bounded priority+SJF queue with a close() for
    shutdown.  All sizes here are small (the queue is bounded, default
    16), so the O(n) band walks in ``get`` are noise next to the jobs
    themselves."""

    def __init__(self, limit: int, *, max_bypass: "int | None" = None) -> None:
        self.limit = max(int(limit), 0)  # 0 = unbounded
        self.max_bypass = (
            DEFAULT_MAX_BYPASS if max_bypass is None else max(int(max_bypass), 1)
        )
        self._cond = threading.Condition()
        # Heap of (neg_priority, cost, seq, item): priority bands first,
        # cheapest-within-band second, FIFO last.
        self._heap: list[tuple[int, int, int, Any]] = []  # guarded-by: _cond
        self._bypassed: dict[int, int] = {}  # seq -> overtakes; guarded-by: _cond
        self._seq = 0  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        self.submitted = 0  # guarded-by: _cond
        self.rejected = 0  # guarded-by: _cond
        self.bypass_pops = 0  # starvation-bound pops; guarded-by: _cond

    def put(self, item: Any, *, priority: int = 0, cost: int = 0) -> None:
        """Enqueue or raise ``JobQueueFull`` — never blocks.  ``cost``
        is the job's size estimate (event count); 0 keeps the legacy
        FIFO position within the band."""
        with self._cond:
            if self._closed:
                raise JobQueueFull("job queue is shut down")
            if self.limit and len(self._heap) >= self.limit:
                self.rejected += 1
                raise JobQueueFull(
                    f"job queue full ({len(self._heap)}/{self.limit})"
                )
            heapq.heappush(self._heap, (-priority, max(int(cost), 0), self._seq, item))
            self._seq += 1
            self.submitted += 1
            self._cond.notify()

    def _pop_locked(self) -> Any:  # ksimlint: lock-held(_cond)
        """SJF-with-starvation-bound pop (see module docstring)."""
        top_band = self._heap[0][0]
        oldest = min(
            (e for e in self._heap if e[0] == top_band), key=lambda e: e[2]
        )
        if (
            oldest is not self._heap[0]
            and self._bypassed.get(oldest[2], 0) >= self.max_bypass
        ):
            chosen = oldest
            self._heap.remove(oldest)
            heapq.heapify(self._heap)
            self.bypass_pops += 1
        else:
            chosen = heapq.heappop(self._heap)
        # Every remaining same-band entry OLDER than the pop was just
        # overtaken once.
        for e in self._heap:
            if e[0] == chosen[0] and e[2] < chosen[2]:
                self._bypassed[e[2]] = self._bypassed.get(e[2], 0) + 1
        self._bypassed.pop(chosen[2], None)
        return chosen[3]

    def get(self, timeout: "float | None" = None) -> Any:
        """Pop the next entry per the admission order; blocks up to
        ``timeout`` (forever when None).  Returns None on timeout or
        once the queue is closed and drained — the worker exit signal."""
        with self._cond:
            while not self._heap:
                if self._closed:
                    return None
                if not self._cond.wait(timeout):
                    return None
            return self._pop_locked()

    def close(self) -> None:
        """Refuse new submissions and wake every blocked ``get`` (they
        drain the remaining entries, then return None)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def depth(self) -> int:
        with self._cond:
            return len(self._heap)

    def stats(self) -> dict:
        with self._cond:
            return {
                "depth": len(self._heap),
                "capacity": self.limit,
                "submitted": self.submitted,
                "rejected": self.rejected,
                "bypass_pops": self.bypass_pops,
            }
