"""Deterministic fault injection: named sites, armed with schedules.

The reference simulator has no fault injection anywhere (SURVEY.md §5);
its recovery story is retries + rollback, and nothing exercises them.
This module is the repo's single fault plane: production code declares
NAMED INJECTION SITES (one ``FAULTS.check("layer.site")`` call on the
failure-prone path) and tests — or an operator via the ``KSIM_FAULTS``
environment spec — ARM those sites with deterministic schedules.  An
unarmed site costs one dict lookup on an empty dict; nothing else.

Sites currently wired (see docs/faults.md for the full table):

- ``replay.lower``      segment lowering (engine/replay.py)
- ``replay.prelower``   the NEXT window's speculative store-independent
                        prefix, overlapped with the in-flight dispatch
                        (a fault here degrades that window's overlap
                        only — it re-parses synchronously)
- ``replay.dispatch``   per-segment device dispatch (under the watchdog)
- ``replay.reconcile``  per-step segment reconcile (inside the store
                        transaction — a fault here must roll back)
- ``service.schedule``  the scheduling pass (scheduler/service.py)
- ``writeback.push``    live-cluster write-back push (syncer/writeback.py)
- ``kubeapi.request``   any kube-apiserver HTTP request (syncer/kubeapi.py)
- ``jobs.run``          a tenant job starting on a job-plane worker
                        (ksim_tpu/jobs/manager.py; a fault here fails
                        that one job, never the worker pool)
- ``jobs.lease_claim``  a fleet member claiming a job lease
                        (ksim_tpu/jobs/fleet.py; a fault here skips ONE
                        claim attempt — another member, or the next
                        poll, picks the job up)
- ``jobs.lease_renew``  a fleet worker's heartbeat renewal batch (a
                        fault here is survivable until lease expiry)

Schedules are deterministic by construction — "fail call N" and "fail
the first K calls" count per-site calls, "hang" sleeps (simulating a
wedged backend; the caller's watchdog is what's under test), and the
probabilistic schedule draws from a per-site seeded RNG so a failing
run replays exactly.

Spec string (``KSIM_FAULTS`` or ``FaultPlane.configure``): comma- or
semicolon-separated ``site=schedule[@error]`` entries::

    KSIM_FAULTS="replay.dispatch=always,writeback.push=first:2"

    call:N        fail exactly the Nth call (1-based)
    first:K       fail calls 1..K
    always        fail every call
    p:P[:SEED]    fail each call with probability P (seeded, default 0)
    hang:T[:K]    sleep T seconds on every call (or only the first K),
                  then CONTINUE — pairs with a caller-side watchdog

``@error`` picks the exception class from ``ERROR_REGISTRY`` (default
``fault`` = InjectedFault, a SimulatorError — classified layers treat it
as an expected, containable failure).  ``@type`` raises a TypeError: a
planted PROGRAMMING error, which classified handlers must re-raise
rather than absorb (tests/test_replay_faults.py pins that).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass

from ksim_tpu_torch.errors import (
    DeviceUnavailableError,
    ReplayFallback,
    SimulatorError,
)
from ksim_tpu_torch.obs import TRACE

logger = logging.getLogger(__name__)

#: Every wired injection site, in pipeline order.  This is the ONE
#: machine-readable list (the docstring table above is prose): each site
#: fires inside the trace-plane span of the same name (obs.SPAN_NAMES),
#: and tests/test_obs.py's registry-sync test asserts this tuple matches
#: the ``FAULTS.check("...")`` call sites in the source AND stays
#: covered by the span taxonomy — the two registries cannot drift apart
#: silently.
SITES: tuple[str, ...] = (
    "replay.lower",
    "replay.prelower",
    "replay.dispatch",
    "replay.reconcile",
    "service.schedule",
    "writeback.push",
    "kubeapi.request",
    "jobs.run",
    "jobs.journal_append",
    "jobs.journal_replay",
    "jobs.checkpoint_append",
    "jobs.checkpoint_restore",
    "jobs.lease_claim",
    "jobs.lease_renew",
    "traces.stream",
)


class InjectedFault(SimulatorError):
    """The fault plane's default injected error — a SimulatorError, so
    every classified handler treats it as an expected fault."""


#: ``@name`` suffixes in a spec string -> exception class.  ``type`` is
#: deliberately a non-SimulatorError: it plants a programming error that
#: classified handlers must RE-RAISE, not absorb.
ERROR_REGISTRY: dict[str, type[BaseException]] = {
    "fault": InjectedFault,
    "device": DeviceUnavailableError,
    "fallback": ReplayFallback,
    "simerr": SimulatorError,
    "runtime": RuntimeError,
    "oserror": OSError,
    "type": TypeError,
}


@dataclass
class _Armed:
    """One armed site: schedule kind + parameters + counters."""

    kind: str  # call | first | always | p | hang
    n: int = 0  # call:N / first:K / hang's K (0 = every call)
    prob: float = 0.0
    hang_s: float = 0.0
    exc: type[BaseException] = InjectedFault
    rng: random.Random | None = None
    calls: int = 0  # per-arming; the durable counters live in SiteStats

    def should_fire(self) -> bool:
        if self.kind == "always":
            return True
        if self.kind == "call":
            return self.calls == self.n
        if self.kind == "first":
            return self.calls <= self.n
        if self.kind == "hang":
            return self.n == 0 or self.calls <= self.n
        if self.kind == "p":
            return self.rng.random() < self.prob
        return False


@dataclass
class SiteStats:
    calls: int = 0
    fired: int = 0


class FaultPlane:
    """Process-global registry of armed injection sites.

    Thread-safe: sites are hit from the scheduler watch loop, the
    write-back thread, and the replay dispatch worker concurrently.
    The hang schedule sleeps OUTSIDE the lock so a hanging site never
    wedges the whole plane.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sites: dict[str, _Armed] = {}  # guarded-by: _lock
        # Counters survive disarm/reset-armed so a test can assert the
        # fault was exercised after the run completed and cleaned up.
        self._stats: dict[str, SiteStats] = {}  # guarded-by: _lock

    # -- arming ----------------------------------------------------------

    def arm(
        self,
        site: str,
        schedule: str = "always",
        *,
        exc: "type[BaseException] | None" = None,
    ) -> None:
        """Arm ``site`` with a schedule string (the spec grammar's
        right-hand side, e.g. ``"call:3"``, ``"hang:2:1"``,
        ``"first:2@device"``).  ``exc`` overrides the error class (wins
        over an ``@name`` suffix) — tests use it to plant exception
        types outside the registry."""
        entry = self._parse(site, schedule)
        if exc is not None:
            entry.exc = exc
        with self._lock:
            self._sites[site] = entry
            self._stats.setdefault(site, SiteStats())

    def disarm(self, site: "str | None" = None) -> None:
        """Disarm one site (or all).  Exercised-fault counters persist
        until ``reset``."""
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)

    def reset(self) -> None:
        """Disarm everything and clear all counters (test teardown)."""
        with self._lock:
            self._sites.clear()
            self._stats.clear()

    def configure(self, spec: str) -> None:
        """Parse a ``KSIM_FAULTS`` spec string and arm every entry.
        Malformed entries raise ValueError (a silently ignored fault
        spec would make a chaos run vacuously green)."""
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"KSIM_FAULTS entry {part!r}: expected site=schedule")
            site, _, schedule = part.partition("=")
            self.arm(site.strip(), schedule.strip())

    def _parse(self, site: str, schedule: str) -> _Armed:
        sched, _, err = schedule.partition("@")
        exc = InjectedFault
        if err:
            if err not in ERROR_REGISTRY:
                raise ValueError(
                    f"site {site!r}: unknown error class {err!r} "
                    f"(have {sorted(ERROR_REGISTRY)})"
                )
            exc = ERROR_REGISTRY[err]
        parts = sched.split(":")
        kind = parts[0]
        if kind == "hang" and err:
            # A hang sleeps and CONTINUES — it never raises, so an
            # @error suffix would be silently discarded and the chaos
            # run would exercise something other than what the spec
            # says.  Refuse loudly instead.
            raise ValueError(
                f"site {site!r}: hang schedules never raise; "
                f"drop the @{err} suffix"
            )
        try:
            if kind == "always" and len(parts) == 1:
                return _Armed("always", exc=exc)
            if kind in ("call", "first") and len(parts) == 2:
                n = int(parts[1])
                if n < 1:
                    # Calls are 1-based; call:0/first:0 would arm a site
                    # that can never fire — the vacuously-green chaos
                    # run this parser exists to refuse.
                    raise ValueError(f"{kind}:{n} can never fire (calls are 1-based)")
                return _Armed(kind, n=n, exc=exc)
            if kind == "hang" and len(parts) in (2, 3):
                return _Armed(
                    "hang",
                    hang_s=float(parts[1]),
                    n=int(parts[2]) if len(parts) == 3 else 0,
                )
            if kind == "p" and len(parts) in (2, 3):
                seed = int(parts[2]) if len(parts) == 3 else 0
                return _Armed(
                    "p", prob=float(parts[1]), rng=random.Random(seed), exc=exc
                )
        except ValueError as e:
            raise ValueError(f"site {site!r}: bad schedule {schedule!r}: {e}") from None
        raise ValueError(f"site {site!r}: unknown schedule {schedule!r}")

    # -- the hot path ----------------------------------------------------

    def check(self, site: str) -> None:
        """The injection point.  No-op unless ``site`` is armed; an
        armed site counts the call and, per its schedule, sleeps (hang)
        or raises its error class."""
        # Deliberately unlocked fast path: an unarmed plane must cost one
        # dict truthiness check and nothing else.  The race is benign —
        # dict reads never crash under CPython, a site armed concurrently
        # with a check may miss that one call, which the deterministic
        # schedules never rely on (tests arm before running).
        if not self._sites:  # ksimlint: disable=lock-discipline
            return
        with self._lock:
            entry = self._sites.get(site)
            if entry is None:
                return
            entry.calls += 1
            stats = self._stats.setdefault(site, SiteStats())
            stats.calls += 1
            fire = entry.should_fire()
            if fire:
                stats.fired += 1
                kind, hang_s, exc, calls = (
                    entry.kind, entry.hang_s, entry.exc, entry.calls,
                )
        if not fire:
            return
        # Timeline evidence: a chaos run's question is WHEN the fault
        # landed relative to the phase spans around it, not just that a
        # counter moved.
        if kind == "hang":
            TRACE.event("fault.fired", site=site, mode="hang", seconds=hang_s)
            logger.warning(
                "fault plane: hanging site %s for %.1fs (call %d)",
                site, hang_s, calls,
            )
            time.sleep(hang_s)
            return
        TRACE.event("fault.fired", site=site, mode="raise", exc=exc.__name__)
        logger.warning(
            "fault plane: injecting %s at site %s (call %d)",
            exc.__name__, site, calls,
        )
        # The message is STABLE (no call counter): for ReplayFallback
        # classes it becomes the fallback-histogram bucket, which must
        # not grow a new key per call; the log line above carries the
        # call number for debugging.
        raise exc(f"injected fault at {site}")

    # -- evidence --------------------------------------------------------

    def calls(self, site: str) -> int:
        with self._lock:
            s = self._stats.get(site)
            return s.calls if s else 0

    def fired(self, site: str) -> int:
        """Times ``site`` actually injected (raised or hung) — the
        "fault was exercised" assertion tests lean on."""
        with self._lock:
            s = self._stats.get(site)
            return s.fired if s else 0

    def snapshot(self) -> dict[str, dict[str, int]]:
        """All per-site counters (bench evidence / debugging)."""
        with self._lock:
            return {
                site: {"calls": s.calls, "fired": s.fired}
                for site, s in self._stats.items()
            }


#: The process-global plane every injection site checks.  ``KSIM_FAULTS``
#: arms it at import so subprocess children (bench rungs) inherit fault
#: config through the environment — the stdlib-only bench parent never
#: has to import this module.
FAULTS = FaultPlane()

_env_spec = os.environ.get("KSIM_FAULTS", "")
if _env_spec:
    FAULTS.configure(_env_spec)
