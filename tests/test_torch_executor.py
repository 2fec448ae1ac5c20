"""The replay executor's other half on the port (CPU, plain kernel D).

The port's ReplayDriver runs each dispatch on a watchdogged worker while
the main thread pre-parses the next window, contains failed dispatches
behind a circuit breaker, reuses the device tensors of the universe's
constants across windows, and gates each shape rung's first launch
through the compile-once cache.  The small cases of ksim_tpu's
tests/test_replay_cache.py and tests/test_replay_faults.py, each against
the port, plus what the port does differently on purpose: a RuntimeError
from the launch (what a kernel that fails to build or launch raises)
surfaces and never feeds the breaker.  Where a case's stream and fault
are ones ksim_tpu's driver takes too, ksim_tpu's ScenarioRunner replays
the same stream with the same fault armed on its own fault plane, and
the executor's evidence (prelower windows / consumed / discarded /
faults, device errors, watchdog timeouts, the breaker's state, probes,
closes, reopens and cooldown, the unsupported histogram, the fault's
fired count, and per lane on a fleet) must equal the port's.  The one
counter left out of that comparison is ``dev_const``: the port turns
reuse on from the first dispatch, ksim_tpu probes it first, and the two
count different leaves.  Every comparison is exact: step triples, stored
placements and counters.
"""

from __future__ import annotations

import contextlib
import threading

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ksim_tpu_torch.engine.core as core_mod
import ksim_tpu_torch.engine.replay as replay_mod
from ksim_tpu.engine.compilecache import COMPILE_CACHE as JAX_COMPILE_CACHE
from ksim_tpu.faults import FAULTS as JAX_FAULTS
from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu.scenario import churn_scenario as jax_churn
from ksim_tpu.scenario.runner import Operation as JaxOperation
from ksim_tpu_torch.engine.compilecache import COMPILE_CACHE
from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.faults import FAULTS
from ksim_tpu_torch.kernels import build
from ksim_tpu_torch.obs import TRACE
from ksim_tpu_torch.scenario.generate import churn_scenario, make_node, make_pod
from ksim_tpu_torch.scenario.runner import Operation, ScenarioRunner
from ksim_tpu_torch.state.featurizer import Featurizer
from tests.helpers import random_cluster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean_fault_plane():
    FAULTS.reset()
    JAX_FAULTS.reset()
    yield
    FAULTS.reset()
    JAX_FAULTS.reset()


@contextlib.contextmanager
def x64(enabled: bool):
    before = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


@contextlib.contextmanager
def ring_on():
    """The trace plane's ring on for the block, its settings restored
    after (the plane is process-wide)."""
    active, ring = TRACE._active, TRACE._ring_on
    TRACE.reset()
    TRACE.enable(ring=True)
    try:
        yield
    finally:
        TRACE.reset()
        TRACE._active, TRACE._ring_on = active, ring


def _small_ops(extra=()):
    return list(churn_scenario(7, n_nodes=24, n_events=600, ops_per_step=40)) + list(extra)


def _signature(res, store):
    return (
        res.pods_scheduled,
        res.unschedulable_attempts,
        [(s.step, s.scheduled, s.unschedulable, s.pending_after) for s in res.steps],
        {f"{p['metadata']['namespace']}/{p['metadata']['name']}": p["spec"].get("nodeName")
         for p in store.list("pods")},
    )


def _run(ops, device, k=8, **kw):
    runner = ScenarioRunner(max_pods_per_pass=64, device_replay=device, device_segment_steps=k,
                            exact=False, device="cpu", **kw)
    res = runner.run(list(ops))
    return runner, _signature(res, runner.store)


@pytest.fixture(scope="module")
def small_base():
    return _run(_small_ops(), device=False)[1]


def _wait_for_abandoned_workers(timeout: float = 30.0) -> None:
    for t in threading.enumerate():
        if t.name == "replay-dispatch":
            t.join(timeout)


def _evidence(driver) -> dict:
    """The executor's counters both drivers report, from ``stats()``."""
    s = driver.stats()
    keys = ("device_steps", "fallback_steps", "device_round_trips", "device_errors",
            "watchdog_timeouts", "breaker_tripped", "unsupported", "prelower", "breaker")
    return {k: s[k] for k in keys}


def _ksim_tpu_run(ops, arm=(), *, fleet=None, warm=False, watchdog_s=None, monkeypatch=None, **kw):
    """ksim_tpu's ScenarioRunner with device replay over the same stream
    (the port's Operations, copied field by field), with ``arm``'s
    ``(site, schedule)`` faults armed on ksim_tpu's fault plane and read
    back after the run.  ``warm`` replays the stream once unarmed first,
    so a short watchdog times only the dispatch, never a cold XLA compile
    on the CPU.  Returns the runner and its fired counts per site."""
    ops = [JaxOperation(**dataclasses.asdict(op)) for op in ops]
    extra = {"fleet": fleet} if fleet else {}
    with x64(False):
        if warm:
            JaxRunner(device_replay=True, **extra, **kw).run(list(ops))
        if watchdog_s is not None:
            monkeypatch.setenv("KSIM_REPLAY_WATCHDOG_S", str(watchdog_s))
        JAX_FAULTS.reset()
        for site, schedule in arm:
            JAX_FAULTS.arm(site, schedule)
        runner = JaxRunner(device_replay=True, **extra, **kw)
        try:
            runner.run(list(ops))
            _wait_for_abandoned_workers()
            fired = {site: JAX_FAULTS.fired(site) for site, _ in arm}
        finally:
            JAX_FAULTS.reset()
    return runner, fired


def _assert_like_ksim_tpu(driver, ops, arm=(), **kw):
    """The port's driver, after its run with ``arm`` armed, reports the
    evidence ksim_tpu's driver reports on the same stream and fault."""
    fired = {site: FAULTS.fired(site) for site, _ in arm}
    ref, ref_fired = _ksim_tpu_run(ops, arm, **kw)
    assert fired == ref_fired
    assert _evidence(driver) == _evidence(ref.replay_driver)


# ---------------------------------------------------------------------------
# The double-buffered executor
# ---------------------------------------------------------------------------


def test_prelower_is_consumed_on_predicted_windows(small_base):
    """The happy path: every window after the first was pre-parsed while
    the previous one dispatched, and the run equals the per-pass path;
    the prelower spans fall inside the dispatch spans."""
    with ring_on():
        dev, sig = _run(_small_ops(), device=True)
        records = TRACE.ring_records()
    assert sig == small_base
    d = dev.replay_driver
    assert d.stats()["lower_cache"]["hits"] >= 1
    assert d.prelower_consumed >= 1 and d.prelower_discarded == 0
    assert d.prelower_windows == d.prelower_consumed
    dispatch = [(r["t"], r["t"] + r["d"]) for r in records if r["name"] == "replay.dispatch"]
    prelower = [(r["t"], r["t"] + r["d"]) for r in records if r["name"] == "replay.prelower"]
    assert len(prelower) == d.prelower_windows
    assert all(any(a <= p0 and p1 <= b for a, b in dispatch) for p0, p1 in prelower)
    # The worker's own spans: one per dispatch, on another thread, and
    # the prelower ran while one was in flight.
    execs = [r for r in records if r["name"] == "replay.exec"]
    main = {r["tid"] for r in records if r["name"] == "replay.lower"}
    assert len(execs) == d.device_round_trips and not main & {r["tid"] for r in execs}
    inside, total = replay_mod.prelower_overlap_seconds(records)
    assert 0 < inside <= total
    _assert_like_ksim_tpu(d, _small_ops(), max_pods_per_pass=64, device_segment_steps=8)


def test_unpredicted_window_shift_discards_the_prefix(small_base):
    """A failed first dispatch shifts the next window by one step: the
    prefix parsed for the window after it is discarded, never consumed
    against the wrong window."""
    FAULTS.arm("replay.dispatch", "call:1")
    dev, sig = _run(_small_ops(), device=True)
    assert sig == small_base
    d = dev.replay_driver
    assert FAULTS.fired("replay.dispatch") == 1
    assert d.device_errors == 1 and d.unsupported.get("device_error") == 1
    assert d.prelower_discarded >= 1
    assert d.stats()["lower_cache"]["invalidations"] == 0
    _assert_like_ksim_tpu(d, _small_ops(), [("replay.dispatch", "call:1")],
                          max_pods_per_pass=64, device_segment_steps=8)


def test_prelower_fault_degrades_that_window_only(small_base):
    FAULTS.arm("replay.prelower", "call:1")
    dev, sig = _run(_small_ops(), device=True)
    assert sig == small_base
    d = dev.replay_driver
    assert FAULTS.fired("replay.prelower") == 1
    assert d.prelower_faults == 1
    assert d.fallback_steps == 0
    assert d.stats()["lower_cache"]["invalidations"] == 0
    _assert_like_ksim_tpu(d, _small_ops(), [("replay.prelower", "call:1")],
                          max_pods_per_pass=64, device_segment_steps=8)


def test_hang_watchdog_degrades_the_window_and_leaves_kernel_ms_alone(monkeypatch):
    """A hung dispatch (3 s against a 1 s watchdog) degrades its window to
    the per-pass path; the run equals the per-pass run.  The abandoned
    worker wakes up, launches and decodes its own plan, and its kernel
    time never reaches the driver: every dispatch reports 5 ms here, and
    ``kernel_ms`` counts only the joined ones."""

    class FiveMs:
        def __init__(self, device) -> None:
            pass

        def stop(self) -> None:
            pass

        def ms(self) -> float:
            return 5.0

    monkeypatch.setattr(replay_mod, "_KernelClock", FiveMs)
    # ksim_tpu first: its warm-up runs without the watchdog.
    jref, jfired = _ksim_tpu_run(list(_tiny_stream()), [("replay.dispatch", "hang:3:1")], warm=True,
                                 watchdog_s=1, monkeypatch=monkeypatch, device_segment_steps=4)
    monkeypatch.setenv("KSIM_REPLAY_WATCHDOG_S", "1")
    ref = ScenarioRunner(device="cpu")
    base = _signature(ref.run(_tiny_stream()), ref.store)
    FAULTS.arm("replay.dispatch", "hang:3:1")
    runner = _tiny_runner()
    res = runner.run(_tiny_stream())
    _wait_for_abandoned_workers()
    assert _signature(res, runner.store) == base
    d = runner.replay_driver
    assert d.watchdog_timeouts == 1
    assert d.device_errors == 1 and d.unsupported.get("device_error") == 1
    assert not d.breaker_tripped
    assert d.device_steps > 0
    assert d.kernel_ms == 5.0 * d.device_round_trips
    assert FAULTS.fired("replay.dispatch") == jfired["replay.dispatch"] == 1
    assert _evidence(d) == _evidence(jref.replay_driver)


# ---------------------------------------------------------------------------
# The circuit breaker
# ---------------------------------------------------------------------------


def test_breaker_trips_after_n_and_is_sticky_by_default(monkeypatch, small_base):
    monkeypatch.setenv("KSIM_REPLAY_BREAKER_N", "2")
    monkeypatch.delenv("KSIM_REPLAY_BREAKER_COOLDOWN_S", raising=False)
    FAULTS.arm("replay.dispatch", "always")
    dev, sig = _run(_small_ops(), device=True)
    assert sig == small_base
    d = dev.replay_driver
    assert FAULTS.fired("replay.dispatch") == 2  # the breaker stops the bleeding
    assert d.breaker_tripped
    assert d.device_errors == 2 and d.unsupported.get("device_error") == 2
    assert d.unsupported.get("breaker_open", 0) > 0
    assert d.device_steps == 0 and d.fallback_steps == len(sig[2])
    assert d.breaker_probes == 0 and d.breaker_closes == 0
    assert d.stats()["breaker"]["cooldown_s"] == 0.0
    _assert_like_ksim_tpu(d, _small_ops(), [("replay.dispatch", "always")],
                          max_pods_per_pass=64, device_segment_steps=8)


#: A cooldown far below one per-pass step's time, even after every
#: doubling this stream can give it (2**29 of it is 0.5 ms): each window
#: after a failure is a probe, so the counts do not depend on the wall
#: clock and the two packages' runs compare exactly.
_COOLDOWN_S = 1e-12
_RECOVERY_KW = dict(max_pods_per_pass=1024, pod_bucket_min=128, device_segment_steps=8)


def _recovery_ops():
    return list(churn_scenario(0, n_nodes=100, n_events=1200, ops_per_step=40))


def _recovery_run():
    runner = ScenarioRunner(device_replay=True, exact=False, device="cpu", **_RECOVERY_KW)
    res = runner.run(_recovery_ops())
    return runner.replay_driver, res


def test_breaker_half_open_probe_closes(monkeypatch):
    """With a cooldown set, the open breaker admits one probe; the fault
    was transient, so the probe comes back healthy, the breaker closes
    and the rest of the run is on the device again."""
    monkeypatch.setenv("KSIM_REPLAY_BREAKER_N", "1")
    monkeypatch.setenv("KSIM_REPLAY_BREAKER_COOLDOWN_S", str(_COOLDOWN_S))
    arm = [("replay.dispatch", "first:1@device")]
    FAULTS.arm(*arm[0])
    d, _res = _recovery_run()
    assert d.breaker_probes == 1 and d.breaker_closes == 1 and d.breaker_reopens == 0
    assert d.breaker_tripped is False
    assert d.device_steps > 0
    b = d.stats()["breaker"]
    assert b["closes"] == d.breaker_closes
    assert b["cooldown_current_s"] == _COOLDOWN_S
    _assert_like_ksim_tpu(d, _recovery_ops(), arm, **_RECOVERY_KW)


def test_breaker_failed_probes_double_the_cooldown(monkeypatch):
    monkeypatch.setenv("KSIM_REPLAY_BREAKER_N", "1")
    monkeypatch.setenv("KSIM_REPLAY_BREAKER_COOLDOWN_S", str(_COOLDOWN_S))
    arm = [("replay.dispatch", "always@device")]
    FAULTS.arm(*arm[0])
    d, res = _recovery_run()
    assert d.breaker_tripped is True
    assert d.breaker_reopens >= 1 and d.breaker_closes == 0
    assert d.breaker_probes == d.breaker_reopens
    assert d.device_steps == 0 and d.fallback_steps == len(res.steps)
    b = d.stats()["breaker"]
    assert b["cooldown_current_s"] == min(_COOLDOWN_S * 2 ** d.breaker_reopens, 3600.0)
    _assert_like_ksim_tpu(d, _recovery_ops(), arm, **_RECOVERY_KW)


def _tiny_stream():
    for i in range(4):
        yield Operation(step=0, op="create", kind="nodes", obj=make_node(f"n-{i}", cpu="8", memory="16Gi"))
    for step in range(1, 5):
        yield Operation(step=step, op="create", kind="pods", obj=make_pod(f"p-{step}", cpu="500m", memory="512Mi"))


def _tiny_runner():
    return ScenarioRunner(device_replay=True, device_segment_steps=4, device="cpu")


def test_breaker_state_is_per_driver(monkeypatch):
    FAULTS.arm("replay.dispatch", "always")
    monkeypatch.setenv("KSIM_REPLAY_BREAKER_N", "1")
    r1 = _tiny_runner()
    r1.run(_tiny_stream())
    assert r1.replay_driver.breaker_tripped
    _assert_like_ksim_tpu(r1.replay_driver, list(_tiny_stream()), [("replay.dispatch", "always")],
                          device_segment_steps=4)
    monkeypatch.delenv("KSIM_REPLAY_BREAKER_N")
    FAULTS.reset()
    r2 = _tiny_runner()
    r2.run(_tiny_stream())
    assert not r2.replay_driver.breaker_tripped
    assert r2.replay_driver.device_steps > 0
    _assert_like_ksim_tpu(r2.replay_driver, list(_tiny_stream()), device_segment_steps=4)


@pytest.mark.parametrize("site", ["replay.lower", "replay.dispatch"])
def test_planted_type_error_surfaces(site):
    FAULTS.arm(site, "call:1", exc=TypeError)
    with pytest.raises(TypeError, match="injected fault"):
        _tiny_runner().run(_tiny_stream())


@pytest.mark.parametrize("how", ["launch", "injected"])
def test_planted_runtime_error_from_the_dispatch_surfaces(how, monkeypatch):
    """The port's deliberate difference from ksim_tpu: a RuntimeError from
    the dispatch — what a kernel that fails to build or launch, or a CUDA
    fault, raises — re-raises instead of becoming a device_error, and the
    breaker never sees it."""
    if how == "launch":
        def refused(*args, **kw):
            raise RuntimeError("ksim_replay_segment: CUDA error 700: an illegal memory access was encountered")

        monkeypatch.setattr(replay_mod, "replay_segment", refused)
        match = "CUDA error"
    else:
        FAULTS.arm("replay.dispatch", "call:1", exc=RuntimeError)
        match = "injected fault"
    runner = _tiny_runner()
    with pytest.raises(RuntimeError, match=match):
        runner.run(_tiny_stream())
    d = runner.replay_driver
    assert d.device_errors == 0 and not d.breaker_tripped
    assert "device_error" not in d.unsupported


def test_injected_lowering_fault_is_contained():
    base = ScenarioRunner(device="cpu").run(_tiny_stream())
    FAULTS.arm("replay.lower", "call:1")
    runner = _tiny_runner()
    dev = runner.run(_tiny_stream())
    assert [(s.step, s.scheduled, s.unschedulable) for s in dev.steps] == [
        (s.step, s.scheduled, s.unschedulable) for s in base.steps
    ]
    assert runner.replay_driver.unsupported.get("lowering_fault") == 1
    _assert_like_ksim_tpu(runner.replay_driver, list(_tiny_stream()), [("replay.lower", "call:1")],
                          device_segment_steps=4)


# ---------------------------------------------------------------------------
# Device-buffer reuse
# ---------------------------------------------------------------------------


def _reuse_run(monkeypatch, on: bool):
    """The 200-node churn with reuse on or off: (signature, per-dispatch
    (hits, misses, bytes), every constant tensor a launch read, with the
    bytes it held at that launch)."""
    monkeypatch.setenv("KSIM_REPLAY_DEV_CACHE", "1" if on else "0")
    packs, seen = [], []
    pack, kernel = replay_mod._pack_segment, replay_mod.replay_segment

    def counting_pack(*args, **kw):
        p = pack(*args, **kw)
        packs.append((p.hits, p.misses, p.bytes))
        return p

    def watching(st, prog, const, ev, state0):
        for part in ("node", "pods"):
            seen.extend((t, t.clone()) for t in const[part].values())
        for fam in const["aux"].values():
            seen.extend((t, t.clone()) for t in fam.values())
        return kernel(st, prog, const, ev, state0)

    monkeypatch.setattr(replay_mod, "_pack_segment", counting_pack)
    monkeypatch.setattr(replay_mod, "replay_segment", watching)
    runner = ScenarioRunner(max_pods_per_pass=1024, pod_bucket_min=128, device_replay=True,
                            device_segment_steps=4, exact=False, device="cpu")
    res = runner.run(list(churn_scenario(0, n_nodes=200, n_events=800, ops_per_step=50)))
    monkeypatch.undo()
    return _signature(res, runner.store), packs, seen, runner.replay_driver


def test_device_buffer_reuse_equals_no_reuse_and_never_sees_a_write(monkeypatch):
    """Reuse on and off give the same run; with it on, every dispatch
    after the first reuses some constant tensors (fewer bytes sent), and
    every constant tensor a launch read still holds, after the whole run,
    the bytes it held at that launch (kernel D never writes its
    constants, so a reused tensor is what was transferred)."""
    sig_off, packs_off, _seen, d_off = _reuse_run(monkeypatch, on=False)
    sig_on, packs_on, seen, d_on = _reuse_run(monkeypatch, on=True)
    assert sig_on == sig_off
    assert len(packs_on) == len(packs_off) >= 3
    assert packs_off[0] == packs_on[0]
    assert all(hits == 0 for hits, _m, _b in packs_off)
    assert all(hits > 0 for hits, _m, _b in packs_on[1:])
    assert all(on[2] < off[2] for on, off in zip(packs_on[1:], packs_off[1:]))
    assert d_on.dev_const_hits == sum(h for h, _m, _b in packs_on) > 0
    assert d_off.dev_const_hits == 0
    assert d_on.stats()["dev_const"]["bytes_per_dispatch"] == [b for _h, _m, b in packs_on]
    reused = {id(t) for t, _ in seen if sum(u is t for u, _ in seen) > 1}
    assert reused, "no constant tensor was read by two launches"
    for t, before in seen:
        assert torch.equal(t, before)


def test_segment_from_arrays_is_one_fresh_copy():
    """The transfer protocol without reuse: every tensor a fresh copy of
    its host array (never aliasing it), with equal values."""
    runner = ScenarioRunner(max_pods_per_pass=64, device_replay=True, device_segment_steps=4,
                            exact=False, device="cpu")
    ops = _small_ops()
    by_step, keys = runner._group_by_step(ops)
    drv = replay_mod.ReplayDriver(runner.store, runner.service, k=4)
    plan = drv.prepare_segment([by_step[s] for s in keys[:4]])
    const, ev, state0 = replay_mod.segment_from_arrays(plan.const, plan.ev, plan.state0)
    for k, t in ev.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(plan.ev[k]), err_msg=k)
    for k, t in state0.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(plan.state0[k]), err_msg=k)
    want = core_mod.device_aux(plan.const["aux"], plan.const["node"]["allocatable"].shape[0], torch.device("cpu"))
    assert list(const["aux"]) == list(want)
    for fam, fields in want.items():
        assert list(const["aux"][fam]) == list(fields), fam
        for name, t in fields.items():
            assert const["aux"][fam][name].dtype == t.dtype
            assert torch.equal(const["aux"][fam][name], t), f"{fam}.{name}"
    before = plan.const["node"]["allocatable"].copy()
    const["node"]["allocatable"].add_(1)
    np.testing.assert_array_equal(plan.const["node"]["allocatable"], before)


# ---------------------------------------------------------------------------
# The compile-once gate, the H2D cache and the prewarm
# ---------------------------------------------------------------------------


def test_compile_cache_rungs_equal_ksim_tpu():
    """The same 2-window stream through both packages' device paths: the
    port's gate records as many rungs (misses) and hits as ksim_tpu's
    compile cache."""
    ops = list(churn_scenario(7, n_nodes=24, n_events=600, ops_per_step=40))
    COMPILE_CACHE.reset()
    runner = ScenarioRunner(max_pods_per_pass=64, device_replay=True, device_segment_steps=8,
                            exact=False, device="cpu")
    runner.run(ops)
    assert runner.replay_driver.device_round_trips == 2
    port = COMPILE_CACHE.snapshot()
    with x64(False):
        JAX_COMPILE_CACHE.reset()
        jr = JaxRunner(max_pods_per_pass=64, device_replay=True, device_segment_steps=8)
        jr.run(list(jax_churn(7, n_nodes=24, n_events=600, ops_per_step=40)))
        ref = JAX_COMPILE_CACHE.snapshot()
        JAX_COMPILE_CACHE.reset()
    COMPILE_CACHE.reset()
    assert jr.replay_driver.device_round_trips == 2
    assert (port["misses"], port["hits"], port["rungs"]) == (ref["misses"], ref["hits"], ref["rungs"])
    assert port["misses"] >= 1


def test_prewarm_loads_only_what_is_built(monkeypatch, tmp_path):
    """The prewarm never builds: with no library under the build
    directory it loads nothing, and a file that will not load is
    skipped, not removed."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    before = COMPILE_CACHE.snapshot()["disk_prewarmed"]
    assert replay_mod.prewarm_aot_cache() == 0
    junk = build._target("replay_segment")
    junk.write_bytes(b"not a library")
    assert replay_mod.prewarm_aot_cache() == 0
    assert junk.exists()
    assert COMPILE_CACHE.snapshot()["disk_prewarmed"] == before


# ---------------------------------------------------------------------------
# The fleet's group dispatch on the watchdogged worker
# ---------------------------------------------------------------------------


def _fleet_sig(res):
    return [(s.step, s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


def test_fleet_group_timeout_degrades_every_lane_identically(monkeypatch):
    """A hung group dispatch times out once for the cohort: every ready
    lane's driver counts the timeout and the device error (the breakers
    stay in lockstep), runs its head step per-pass, and the cohort stays
    convergent, every lane equal to the solo run; the cohort leader alone
    lowers."""
    kw = dict(device_segment_steps=2, exact=False, device="cpu")
    ops = list(_tiny_stream())
    solo = ScenarioRunner(device_replay=True, **kw).run(ops)
    # ksim_tpu's fleet on the same stream and hang first: its warm-up
    # runs without the watchdog.
    jref, jfired = _ksim_tpu_run(ops, [("replay.dispatch", "hang:3:1")], fleet=3, warm=True,
                                 watchdog_s=1, monkeypatch=monkeypatch, device_segment_steps=2)
    monkeypatch.setenv("KSIM_REPLAY_WATCHDOG_S", "1")
    FAULTS.arm("replay.dispatch", "hang:3:1")
    fleet_r = ScenarioRunner(device_replay=True, fleet=3, **kw)
    fleet_r.run(ops)
    for t in threading.enumerate():
        if t.name == "replay-dispatch":
            t.join(30.0)
    lanes = fleet_r.fleet_lanes
    for ln in lanes:
        assert _fleet_sig(ln.result) == _fleet_sig(solo), f"lane {ln.idx}"
        assert ln.driver.watchdog_timeouts == 1
        assert ln.driver.device_errors == 1 and ln.driver.unsupported.get("device_error") == 1
        assert ln.convergent
        assert not ln.driver.breaker_tripped
    stats = fleet_r.fleet_driver.stats()
    assert stats["divergences"] == 0
    assert stats["lane_lowerings"][1:] == [0, 0]
    lead = lanes[0].driver
    assert lead.prelower_consumed >= 1
    assert all(ln.driver.dev_const_hits == 0 for ln in lanes[1:])
    assert lead.dev_const_hits > 0
    assert FAULTS.fired("replay.dispatch") == jfired["replay.dispatch"] == 1
    assert [_evidence(ln.driver) for ln in lanes] == [_evidence(ln.driver) for ln in jref.fleet_lanes]
    jstats = jref.fleet_driver.stats()
    for key in ("shared_lowerings", "group_dispatches", "lane_fallbacks", "divergences",
                "convergent_lanes", "lane_device_steps", "lane_fallback_steps", "lane_lowerings"):
        assert stats[key] == jstats[key], key
