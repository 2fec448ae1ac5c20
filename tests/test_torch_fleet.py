"""The port's fleet replay against ksim_tpu's, on the CPU.

- ``ScenarioRunner(fleet=S, device_replay=True)`` in both cohort modes
  (dedupe, the default, and ``KSIM_FLEET_VMAP=1``): every lane equals
  ksim_tpu's fleet lane and the solo device run, step by step, with the
  shared window lowered once (on the cohort leader);
- ``replay_segment_fleet_plain`` (rows 10-11's plain version) against
  ksim_tpu's ``_fleet_segment_fn`` on one lowered window, lane by lane;
- the refusals (bad configurations, ``KSIM_REPLAY_TP``), ``KSIM_FLEET_DP``
  taking the lane-stacked launch, a cancel at a
  dispatch boundary, a ``lane_ops`` lane on the solo path and a
  ``fleet_faults`` spec that degrades one lane.

Tolerance 0 everywhere: every output is an integer or a bool.  ksim_tpu
runs with x64 off (f32 mode), the port with ``exact=False``."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest
import torch

from ksim_tpu.engine.replay import ReplayDriver as JaxReplayDriver
from ksim_tpu.engine.replay import _fleet_exec as jax_fleet_exec
from ksim_tpu.scenario import Operation as JaxOperation
from ksim_tpu.scenario import ScenarioResult as JaxResult
from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu.scenario import churn_scenario as jax_churn
from ksim_tpu_torch.engine.replay import FALLBACK_REASONS, ReplayDriver, segment_from_arrays
from ksim_tpu_torch.errors import RunCancelled
from ksim_tpu_torch.kernels import replay_segment as segment_mod
from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scenario.runner import Operation, ScenarioResult, ScenarioRunner
from ksim_tpu_torch.state.cluster import ClusterStore
from tests.helpers import make_node, make_pod

SMALL = dict(n_nodes=48, n_events=200, ops_per_step=20)
KW = dict(max_pods_per_pass=1024, pod_bucket_min=128, device_segment_steps=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensor ops: one intra-op thread does
    them as fast as many, and keeps the suite's parallel workers from
    oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def x64(enabled: bool):
    before = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def _steps(res) -> list[tuple[int, int, int, int]]:
    return [(s.step, s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


def _port(**kw) -> ScenarioRunner:
    return ScenarioRunner(**KW, device_replay=True, exact=False, device="cpu", **kw)


@pytest.mark.parametrize("vmap", ["0", "1"], ids=["dedupe", "vmap"])
def test_fleet_lanes_equal_reference_fleet_and_solo(vmap, monkeypatch):
    with x64(False):
        jfleet = JaxRunner(**KW, device_replay=True, fleet=3)
        jfleet.run(jax_churn(0, **SMALL))
    solo_r = _port()
    solo = solo_r.run(churn_scenario(0, **SMALL))
    monkeypatch.setenv("KSIM_FLEET_VMAP", vmap)
    before = segment_mod.replay_segment_fleet.launches
    fleet_r = _port(fleet=3)
    agg = fleet_r.run(churn_scenario(0, **SMALL))
    assert agg.lanes is not None and len(agg.lanes) == 3
    for ln, jln in zip(fleet_r.fleet_lanes, jfleet.fleet_lanes):
        assert _steps(ln.result) == _steps(jln.result) == _steps(solo), ln.idx
        assert (ln.result.pods_scheduled, ln.result.unschedulable_attempts) == (
            solo.pods_scheduled, solo.unschedulable_attempts,
        )
        assert ln.driver.device_steps == solo_r.replay_driver.device_steps
    assert agg.pods_scheduled == 3 * solo.pods_scheduled
    stats = fleet_r.fleet_driver.stats()
    lowerings = stats["lane_lowerings"]
    assert sum(lowerings) == lowerings[0] > 0, stats
    assert lowerings == [len(d.lower_log) for d in (ln.driver for ln in jfleet.fleet_lanes)]
    assert stats["lanes_on_device"] == 1.0
    assert stats["cohort_mode"] == ("vmap" if vmap == "1" else "dedupe")
    assert stats["group_dispatches"] == len(solo_r.replay_driver.lower_log)
    # The plain fleet version ran the vmap cohort; on the CPU the wrapper
    # launches nothing.
    assert segment_mod.replay_segment_fleet.launches == before
    for ln in fleet_r.fleet_lanes[1:]:
        assert ln.driver._featurizer is None


def _tiny(op):
    """The reference's tiny vmap-cohort stream (3 nodes, 5 pod steps)."""
    for i in range(3):
        yield op(step=0, op="create", kind="nodes", obj=make_node(f"n-{i}", cpu="4", memory="8Gi"))
    for step in range(1, 6):
        yield op(step=step, op="create", kind="pods", obj=make_pod(f"p-{step}", cpu="500m", memory="512Mi"))


def test_fleet_vmap_cohort_tiny_stream(monkeypatch):
    monkeypatch.setenv("KSIM_FLEET_VMAP", "1")
    with x64(False):
        jfleet = JaxRunner(device_replay=True, device_segment_steps=4, fleet=3)
        jfleet.run(_tiny(JaxOperation))
    solo_r = ScenarioRunner(device_replay=True, device_segment_steps=4, exact=False, device="cpu")
    solo = solo_r.run(_tiny(Operation))
    assert solo_r.replay_driver.device_steps == 6
    fleet_r = ScenarioRunner(device_replay=True, device_segment_steps=4, fleet=3, exact=False, device="cpu")
    fleet_r.run(_tiny(Operation))
    stats = fleet_r.fleet_driver.stats()
    assert stats["cohort_mode"] == "vmap" and stats["lanes_on_device"] == 1.0
    for ln, jln in zip(fleet_r.fleet_lanes, jfleet.fleet_lanes):
        assert _steps(ln.result) == _steps(jln.result) == _steps(solo), ln.idx


def test_replay_segment_fleet_plain_equals_reference_fleet_segment():
    """One window lowered by each package (equal lowerings: tests/
    test_torch_replay.py), through ksim_tpu's vmapped ``_fleet_segment_fn``
    and the port's fleet plain version, two lanes; every lane equals the
    other package's, output for output and in the final state."""
    lanes = 2
    churn = dict(n_nodes=24, n_events=80, ops_per_step=12)
    with x64(False):
        jr = JaxRunner(max_pods_per_pass=64, pod_bucket_min=32)
        jby, jkeys = jr._group_by_step(list(jax_churn(1, **churn)))
        for s in jkeys[:2]:
            jr._run_step(s, jby[s], JaxResult())
        jplan = JaxReplayDriver(jr.store, jr.service, k=4).prepare_segment([jby[s] for s in jkeys[2:6]])
        ref_state, ref_outs = jax_fleet_exec(jplan, [jplan.state0] * lanes)
    tr = ScenarioRunner(max_pods_per_pass=64, pod_bucket_min=32, exact=False, device="cpu")
    tby, tkeys = tr._group_by_step(list(churn_scenario(1, **churn)))
    for s in tkeys[:2]:
        tr._run_step(s, tby[s], ScenarioResult())
    tplan = ReplayDriver(tr.store, tr.service, k=4).prepare_segment([tby[s] for s in tkeys[2:6]])
    const, ev, state0 = segment_from_arrays(
        dict(jplan.const, aux=jplan.aux), jplan.ev, jplan.state0, lanes=lanes
    )
    assert state0["valid"].shape[0] == lanes
    got_state, got_outs = segment_mod.replay_segment_fleet(tplan.statics, tplan.prog, const, ev, state0)
    assert set(got_outs) == set(ref_outs)
    for key, ref in ref_outs.items():
        np.testing.assert_array_equal(got_outs[key].numpy(), np.asarray(ref), err_msg=key)
    for key, ref in ref_state.items():
        ref = np.asarray(ref)
        np.testing.assert_array_equal(got_state[key].numpy().reshape(ref.shape), ref, err_msg=key)
    assert int(np.asarray(ref_outs["scheduled"]).sum()) > 0


def test_fleet_rejects_bad_config(monkeypatch):
    with pytest.raises(ValueError, match="device_replay"):
        ScenarioRunner(fleet=2, device="cpu")
    with pytest.raises(ValueError, match="at least 2"):
        ScenarioRunner(device_replay=True, fleet=1, device="cpu")
    with pytest.raises(ValueError, match="own stores"):
        ScenarioRunner(store=ClusterStore(), device_replay=True, fleet=2, device="cpu")
    with pytest.raises(ValueError, match="lane_ops requires fleet"):
        ScenarioRunner(device="cpu").run(iter(()), lane_ops={0: iter(())})
    with pytest.raises(ValueError, match="lane 5 outside"):
        ScenarioRunner(device_replay=True, fleet=2, fleet_faults="5:replay.lower=always", device="cpu").run(iter(()))
    with pytest.raises(ValueError, match=r"lane_ops lanes \[4\] outside"):
        ScenarioRunner(device_replay=True, fleet=4, device="cpu").run(iter(()), lane_ops={4: iter(())})
    with pytest.raises(ValueError, match="fleet_faults requires fleet"):
        ScenarioRunner(device_replay=True, fleet_faults="0:replay.lower=always", device="cpu")
    # The dp lane mesh is ported: a malformed KSIM_FLEET_DP is an error,
    # a good one takes the lane-stacked launch over a dp-row mesh.
    monkeypatch.setenv("KSIM_FLEET_DP", "two")
    with pytest.raises(ValueError, match="two"):
        ScenarioRunner(device_replay=True, fleet=2, device="cpu").run(iter(()))
    monkeypatch.setenv("KSIM_FLEET_DP", "2")
    runner = ScenarioRunner(device_replay=True, fleet=2, device="cpu")
    runner.run(iter(()))
    assert runner.fleet_driver.dp == 2 and runner.fleet_driver.stats()["cohort_mode"] == "vmap"


def test_fleet_refuses_the_replay_tp_mesh(monkeypatch):
    """``KSIM_REPLAY_TP`` above 1 is refused for a fleet run too: its
    lanes build their replay drivers through the same path as a solo
    run."""
    monkeypatch.setenv("KSIM_REPLAY_TP", "2")
    with pytest.raises(NotImplementedError, match="KSIM_REPLAY_TP"):
        _port(fleet=2).run(list(churn_scenario(0, **SMALL)))


def test_fleet_cancel_lands_at_dispatch_boundary():
    """A cancel raised mid-run aborts at the next lane dispatch boundary
    (the per-round check), with every lane's store at a committed segment
    boundary."""

    class FlipAfter:
        def __init__(self, n):
            self.n = n
            self.polls = 0

        def is_set(self):
            self.polls += 1
            return self.polls > self.n

    # The run polls once before the fleet builds; the first round once,
    # then once per reconciled step and lane (2 x 8): poll 19 is the
    # second round's check, at the dispatch boundary.
    flag = FlipAfter(18)
    fleet_r = _port(fleet=2, cancel=flag)
    with pytest.raises(RunCancelled):
        fleet_r.run(churn_scenario(0, **SMALL))
    assert flag.polls == 19
    for ln in fleet_r.fleet_lanes:
        assert ln.runner.store._txn is None
        assert ln.i == 8 and ln.driver.device_steps == 8  # the first window committed whole


def test_fleet_lane_ops_lane_runs_solo():
    """A per-lane stream rides the solo device path outside the cohort and
    equals its own solo run; the other lanes still share one lowering."""

    def other():
        return churn_scenario(7, n_nodes=32, n_events=120, ops_per_step=20)

    solo_base = _port().run(churn_scenario(0, **SMALL))
    solo_other = _port().run(other())
    fleet_r = _port(fleet=3)
    fleet_r.run(churn_scenario(0, **SMALL), lane_ops={1: other()})
    lanes = fleet_r.fleet_lanes
    assert _steps(lanes[0].result) == _steps(lanes[2].result) == _steps(solo_base)
    assert _steps(lanes[1].result) == _steps(solo_other)
    assert not lanes[1].convergent and not lanes[1].shared_stream
    assert len(lanes[1].driver.lower_log) > 0
    assert len(lanes[2].driver.lower_log) == 0


def test_fleet_faults_degrade_one_lane():
    """A lane-armed dispatch fault degrades that lane alone (its window
    head runs per-pass, then it continues solo); every lane still lands
    the solo counts."""
    solo = _port().run(churn_scenario(0, **SMALL))
    fleet_r = _port(fleet=3, fleet_faults="1:replay.dispatch=call:1")
    fleet_r.run(churn_scenario(0, **SMALL))
    lanes = fleet_r.fleet_lanes
    for ln in lanes:
        assert _steps(ln.result) == _steps(solo), ln.idx
    assert lanes[1].driver.unsupported == {"device_error": 1}
    assert lanes[1].driver.fallback_steps == 1 and not lanes[1].convergent
    for ln in (lanes[0], lanes[2]):
        assert ln.driver.unsupported == {} and ln.driver.fallback_steps == 0 and ln.convergent
    stats = fleet_r.fleet_driver.stats()
    assert stats["lane_fallbacks"] == 1 and stats["divergences"] == 1
    assert set(lanes[1].driver.unsupported) <= FALLBACK_REASONS
