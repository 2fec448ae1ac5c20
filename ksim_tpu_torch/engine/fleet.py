"""Fleet replay: S independent what-if trajectories, one launch per window.

The port of ``ksim_tpu/engine/fleet.py``.  Policy sweeps, Monte-Carlo
chaos and autoscaler tuning run many independent churn trajectories that
share one pod/node universe.  Running them solo pays S times the segment
lowering and S times the launch.  This module multiplexes them:

- Every lane is a complete solo stack — its own ClusterStore, its own
  SchedulerService, its own ReplayDriver (cache, counters) — so per-lane
  reconcile, per-lane fallback and per-lane evidence are the solo code
  paths (scenario/runner.py drives them).
- Lanes replaying the same base stream form the convergent cohort: the
  cohort leader lowers each window once (``ReplayDriver.prepare_segment``)
  and one dispatch advances every cohort lane K steps.  Each lane decodes
  and reconciles against its own store, equal to its solo run.
- Two cohort modes.  By default (dedupe) the leader's solo kernel-D
  launch runs once and its pulled outputs fan out to every lane: the
  convergence invariant makes the lanes' carries identical, so S equal
  trajectories would be redundant.  ``KSIM_FLEET_VMAP=1`` runs the
  lane-stacked program instead — kernel D with one block per lane
  (kernels/replay_segment.py ``replay_segment_fleet``, through
  ``engine/replay.py _fleet_exec``).
- Per-lane deltas degrade per lane, never fleet-wide: a lane whose private
  fault plane (``KSIM_FLEET_FAULTS``) fires, whose reconcile rolls back,
  or whose stream diverges (per-lane op streams) leaves the cohort and
  continues on the solo device path, while the cohort keeps amortizing.
  Divergence is detected by cursor drift: equal cursors over the shared
  stream imply equal stores, so a lane that stops advancing in lockstep
  is split off (a ``replay.fleet_lane_fallback`` event marks it).

- The group dispatch runs on a watchdogged worker thread (the leader
  driver's ``KSIM_REPLAY_WATCHDOG_S``) while the leader pre-parses the
  next window on the main thread, as the solo executor does.  A timeout
  or an injected fault degrades every ready lane identically: each lane's
  driver counts it on its own breaker, so the breakers stay in lockstep.
  Only the plan's owner, the cohort leader, adopts the reused device
  buffers.

Not ported: ``KSIM_FLEET_DP`` (the lane axis over a device mesh, ROADMAP
queue 1 item 9) raises NotImplementedError.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any

from ksim_tpu_torch.engine.replay import ReplayParityError, _fleet_exec
from ksim_tpu_torch.errors import DeviceUnavailableError, ReplayFallback, SimulatorError
from ksim_tpu_torch.faults import FaultPlane
from ksim_tpu_torch.obs import TRACE

logger = logging.getLogger(__name__)


def parse_fleet_faults(spec: str, n_lanes: int) -> dict[int, FaultPlane]:
    """Parse a ``KSIM_FLEET_FAULTS`` spec into per-lane fault planes.

    Syntax: comma/semicolon-separated ``<lane>:<site>=<schedule>[@error]``
    entries, the right-hand side exactly the ``KSIM_FAULTS`` grammar, e.g.
    ``"2:replay.dispatch=call:1;2:replay.lower=first:1"`` arms lane 2
    only.  Each listed lane gets its own ``FaultPlane``, checked next to
    the process-global ``FAULTS`` at the replay sites, so chaos lands on
    one trajectory while the rest of the fleet stays healthy.  Malformed
    entries raise (a silently dropped lane spec would make a chaos sweep
    vacuously green)."""
    planes: dict[int, FaultPlane] = {}
    for part in spec.replace(";", ",").split(","):
        part = part.strip()
        if not part:
            continue
        lane_s, sep, rest = part.partition(":")
        if not sep or not lane_s.strip().isdigit():
            raise ValueError(f"KSIM_FLEET_FAULTS entry {part!r}: expected <lane>:<site>=<schedule>")
        lane = int(lane_s)
        if not 0 <= lane < n_lanes:
            raise ValueError(
                f"KSIM_FLEET_FAULTS entry {part!r}: lane {lane} outside the fleet (0..{n_lanes - 1})"
            )
        planes.setdefault(lane, FaultPlane()).configure(rest)
    return planes


@dataclass
class FleetLane:
    """One trajectory's full solo stack plus its fleet bookkeeping."""

    idx: int
    runner: Any  # per-lane ScenarioRunner (store+service owner)
    driver: Any  # per-lane ReplayDriver
    keys: list  # sorted step keys of THIS lane's stream
    by_step: dict  # step -> list[Operation] (cohort lanes share the base dict)
    result: Any  # per-lane ScenarioResult
    faults: "FaultPlane | None" = None
    shared_stream: bool = True  # replays the base stream (cohort-eligible)
    i: int = 0  # cursor into keys
    done: bool = False  # a doneOperation step completed
    convergent: bool = True
    # The reason this lane degraded in the current round (cleared each
    # round).
    round_reason: "str | None" = field(default=None, repr=False)

    @property
    def finished(self) -> bool:
        return self.done or self.i >= len(self.keys)


class FleetDriver:
    """Drives every lane to completion, multiplexing the convergent
    cohort through shared lowerings and group dispatches."""

    def __init__(self, lanes: list[FleetLane]) -> None:
        if os.environ.get("KSIM_FLEET_DP"):
            raise NotImplementedError(
                "KSIM_FLEET_DP (fleet lanes over a device mesh) is not ported to "
                "ksim_tpu_torch (ROADMAP queue 1 item 11)"
            )
        self.lanes = lanes
        # Cohort dispatch mode (module docstring): the lane-stacked
        # kernel-D launch, or the leader's solo launch fanned out.
        self.vmap_cohort = os.environ.get("KSIM_FLEET_VMAP") == "1"
        self.shared_lowerings = 0
        self.group_dispatches = 0
        self.lane_fallbacks = 0
        self.divergences = 0
        # Kernel time of the lane-stacked launches on a CUDA device.
        self.kernel_ms = 0.0

    # -- evidence ------------------------------------------------------------

    def stats(self) -> dict:
        drivers = [ln.driver for ln in self.lanes]
        total = sum(d.device_steps + d.fallback_steps for d in drivers)
        on_dev = sum(d.device_steps for d in drivers)
        return {
            "lanes": len(self.lanes),
            "cohort_mode": "vmap" if self.vmap_cohort else "dedupe",
            "shared_lowerings": self.shared_lowerings,
            "group_dispatches": self.group_dispatches,
            "lane_fallbacks": self.lane_fallbacks,
            "divergences": self.divergences,
            "convergent_lanes": sum(1 for ln in self.lanes if ln.convergent),
            # Device-committed lane-steps over all lane-steps.
            "lanes_on_device": round(on_dev / total, 4) if total else None,
            "lane_device_steps": [d.device_steps for d in drivers],
            "lane_fallback_steps": [d.fallback_steps for d in drivers],
            "lane_lowerings": [len(d.lower_log) for d in drivers],
            "kernel_ms": self.kernel_ms,
        }

    # -- the fleet loop ------------------------------------------------------

    def run(self) -> None:
        while True:
            active = [ln for ln in self.lanes if not ln.finished]
            if not active:
                return
            # Cooperative cancel: every lane runner carries the parent
            # run's flag, so one check per round — the lane dispatch
            # boundary — raises RunCancelled before the next shared
            # lowering; a cancel landing mid-segment aborts inside that
            # lane's reconcile transaction instead, and the exception
            # ladders below deliberately do not catch it.
            active[0].runner._check_cancelled()
            for ln in active:
                ln.round_reason = None
            cohort = [ln for ln in active if ln.convergent]
            solos = [ln for ln in active if not ln.convergent]
            if len(cohort) == 1:
                # A cohort of one gains nothing from the group path.
                cohort[0].convergent = False
                solos.append(cohort[0])
                cohort = []
            if cohort:
                self._advance_cohort(cohort)
            for ln in solos:
                if not ln.finished:
                    self._advance_solo(ln)

    def _advance_solo(self, ln: FleetLane) -> None:
        """One solo advance: exactly the ScenarioRunner.run loop body."""
        drv = ln.driver
        # Two windows of lookahead: the next one is pre-parsed while this
        # one dispatches (engine/replay.py _prelower_next).
        batches = [ln.by_step[s] for s in ln.keys[ln.i : ln.i + 2 * drv.k]]
        seg = drv.try_segment(batches)
        if seg is not None and ln.runner._commit_segment(
            ln.keys[ln.i : ln.i + len(seg.steps)],
            batches[: len(seg.steps)],
            seg,
            drv,
            ln.result,
        ):
            ln.i += len(seg.steps)
            return
        self._per_pass_head(ln)

    def _per_pass_head(self, ln: FleetLane) -> None:
        """Run the lane's head step on the per-pass host path (the window
        fallback), after dropping the lane's lowered-universe cache."""
        ln.driver._flush_incremental("fallback")
        ln.driver.fallback_steps += 1
        step = ln.keys[ln.i]
        done = ln.runner._run_step(step, ln.by_step[step], ln.result)
        ln.i += 1
        if done:
            ln.result.succeeded = True
            ln.done = True

    # -- per-lane degradation ------------------------------------------------

    def _lane_gate(self, ln: FleetLane, site: str) -> "BaseException | None":
        """Check the lane's private fault plane at a replay site: the
        containable exception (the lane degrades alone) or None."""
        if ln.faults is None:
            return None
        try:
            ln.faults.check(site)
            return None
        except (ReplayFallback, DeviceUnavailableError, SimulatorError, RuntimeError, OSError) as e:
            return e

    def _degrade_lane(self, ln: FleetLane, reason: str) -> None:
        """One lane leaves this round's shared path and runs its head step
        per-pass."""
        ln.round_reason = reason
        self.lane_fallbacks += 1
        self._per_pass_head(ln)

    def _note_divergence(self, ln: FleetLane) -> None:
        ln.convergent = False
        self.divergences += 1
        TRACE.event("replay.fleet_lane_fallback", lane=ln.idx, reason=ln.round_reason or "cursor_drift")
        logger.info(
            "fleet lane %d left the convergent cohort (%s); it continues on the solo device path",
            ln.idx, ln.round_reason or "cursor_drift",
        )

    # -- the shared window ---------------------------------------------------

    def _advance_cohort(self, cohort: list[FleetLane]) -> None:
        """Advance every convergent lane by one window: one shared
        lowering on the leader, one group dispatch, one per-lane decode
        and reconcile.  A lane that fails a per-lane gate degrades alone;
        a shared failure degrades every lane identically, which keeps the
        cohort convergent."""
        start_i = cohort[0].i
        # 1. Per-lane gates: the service-support screen (it also caches
        #    each lane driver's resolved profile config, which its decode
        #    reads), then the lane's private replay.lower plane.
        stay: list[FleetLane] = []
        for ln in cohort:
            if not ln.driver.service_supported():
                self._degrade_lane(ln, ln.driver._last_reject or "unsupported")
                continue
            e = self._lane_gate(ln, "replay.lower")
            if e is None:
                stay.append(ln)
            else:
                reason = str(e) if isinstance(e, ReplayFallback) else "lowering_fault"
                ln.driver._reject(reason)
                self._degrade_lane(ln, reason)
        if stay:
            self._dispatch_cohort(stay)
        # 2. Divergence: equal cursors over the shared stream imply equal
        #    stores, so a lane off the common cursor leaves the cohort.
        cursors = {ln.i for ln in cohort}
        if len(cursors) > 1:
            lead_i = max(cursors)
            for ln in cohort:
                if ln.i != lead_i:
                    self._note_divergence(ln)
        else:
            # Lanes that degraded through a private fault diverge even at
            # a common cursor unless every lane did.
            reasons = {ln.round_reason for ln in cohort}
            if len(reasons) > 1:
                for ln in cohort:
                    if ln.round_reason is not None:
                        self._note_divergence(ln)
        assert all(ln.i > start_i for ln in cohort), "fleet round made no progress"

    def _dispatch_cohort(self, stay: list[FleetLane]) -> None:
        lead = stay[0]
        drv = lead.driver
        keys, by_step = lead.keys, lead.by_step
        i = lead.i
        batches = [by_step[s] for s in keys[i : i + 2 * drv.k]]
        # Reset first, so a None return's reason can only be what this
        # window recorded (the pre-span head screen rejects silently).
        drv._last_reject = None
        plan = drv.prepare_segment(batches, check_lane_faults=False)
        self.shared_lowerings += 1
        if plan is None:
            # A shared rejection: every follower records the leader's
            # reason, as its solo run would, and the cohort degrades
            # identically.
            reason = drv._last_reject
            for ln in stay:
                if ln is not lead and reason is not None:
                    ln.driver._reject(reason)
                self._per_pass_head(ln)
            return
        # Per-lane dispatch gate: a lane whose private plane fires at
        # replay.dispatch leaves the group and degrades as a device error.
        ready: list[FleetLane] = []
        for ln in stay:
            e = self._lane_gate(ln, "replay.dispatch")
            if e is None:
                ready.append(ln)
            else:
                ln.driver._note_device_error(e)
                self._degrade_lane(ln, "device_error")
        if not ready:
            return
        outcome = self._group_dispatch(ready, lead, plan, batches)
        if outcome is None:
            return  # every ready lane already degraded identically
        pulled_state, pulled = outcome
        # Per-lane decode + reconcile against each lane's own store.
        lead.driver._last_plan = plan  # the cache-advance anchor (leader only)
        for j, ln in enumerate(ready):
            if self.vmap_cohort:
                lane_state = {k: v[j] for k, v in pulled_state.items()}
                lane_pulled = {k: v[j] for k, v in pulled.items()}
            else:
                lane_state, lane_pulled = pulled_state, pulled
            res = ln.driver._decode_outputs(plan, lane_state, lane_pulled)
            if isinstance(res, str):
                # A post-dispatch discard: deterministic over identical
                # inputs, so every lane lands here together.
                ln.driver._reject(res)
                self._per_pass_head(ln)
                continue
            if ln.runner._commit_segment(
                keys[i : i + len(res.steps)],
                batches[: len(res.steps)],
                res,
                ln.driver,
                ln.result,
            ):
                ln.i += len(res.steps)
            else:
                # Per-lane reconcile rollback (the lane's store is back at
                # the window start).
                self._degrade_lane(ln, "reconcile_fault")

    def _group_dispatch(self, ready, lead, plan, batches):
        """The group dispatch — the lane-stacked launch (vmap mode) or the
        leader's solo launch (dedupe) — on a watchdogged worker, overlapped
        with the leader's prelower of the next window.  Returns
        ``(pulled_state, pulled)`` or None after degrading every ready lane
        identically.  A kernel that fails to build or launch raises."""
        drv = lead.driver
        drv.load_kernel()
        stacked = self.vmap_cohort
        lane_ids = ",".join(str(ln.idx) for ln in ready)

        def work():
            with TRACE.span("replay.exec", segment=plan.segment, steps=plan.n_steps, lanes=len(ready)):
                if stacked:
                    wait_s = drv.watchdog_s if drv.watchdog_s > 0 else 300.0
                    return _fleet_exec(plan, len(ready), drv.service._device, wait_s=wait_s)
                # Dedupe: the leader's solo launch (the same reuse); its
                # outputs ARE every cohort lane's.
                return drv._device_exec(plan)

        err: "BaseException | None" = None
        try:
            with TRACE.span(
                "replay.dispatch",
                segment=drv.segment_seq,
                steps=plan.n_steps,
                lanes=len(ready),
                lane=lane_ids,
            ):
                # Every ready lane counts a timeout, so the cohort's
                # breakers stay in lockstep.
                out = drv._watchdogged(
                    work,
                    lambda: drv._prelower_next(plan, batches),
                    label=f"fleet dispatch ({len(ready)} lanes)",
                    counted=[ln.driver for ln in ready],
                    lanes=len(ready),
                )
        except ReplayParityError:
            raise  # a kernel bug, not a degradable condition
        except ReplayFallback as e:
            for ln in ready:
                ln.driver._reject(str(e))
                self._per_pass_head(ln)
            return None
        except SimulatorError as e:
            # An injected fault or a timeout; a RuntimeError (a kernel's
            # build or launch, a CUDA fault) propagates.
            err = e
        if err is not None:
            # A shared device failure: every lane walks the device_error
            # ladder its solo run would.
            for ln in ready:
                ln.driver._note_device_error(err)
                self._per_pass_head(ln)
            return None
        pulled_state, pulled, info = out
        if stacked:
            self.kernel_ms += info["kernel_ms"]
        else:
            drv.note_run(info)
        for ln in ready:
            ln.driver.note_dispatch_healthy(plan, adopt=(ln is lead))
        self.group_dispatches += 1
        return pulled_state, pulled
