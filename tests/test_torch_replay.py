"""The port's device-resident churn replay against ksim_tpu's, on the CPU.

- ``derive_interpod_plain`` against ``_derive_interpod`` on lowered
  windows of the churn scenario;
- ``replay_segment_plain`` (kernel D's plain version) against
  ``_segment_fn`` on one window lowered by ksim_tpu and fed to both
  through ``segment_from_arrays`` — every output and the whole final
  state — after checking that the port lowers the same window to the
  same arrays;
- the port's ``ScenarioRunner(device_replay=True)`` against ksim_tpu's,
  step by step;
- the unsupported-window fallbacks, each under its named reason;
- row 6's key layout (``derive_layout``), the kernel's view of the
  lowered node domains;
- ``KSIM_REPLAY_TP``: above 1 refused where the driver is built, 1 and 0
  the same replay as unset.

Tolerance 0 everywhere: every output is an integer or a bool.  ksim_tpu
runs with x64 on for exact mode and off for f32 mode."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest
import torch

from ksim_tpu.engine.replay import ReplayDriver as JaxReplayDriver
from ksim_tpu.engine.replay import _derive_interpod as jax_derive_interpod
from ksim_tpu.engine.replay import _pack_plan_buffers, _segment_fn
from ksim_tpu.scenario import Operation as JaxOperation
from ksim_tpu.scenario import ScenarioResult as JaxResult
from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu.scenario import churn_scenario as jax_churn
from ksim_tpu_torch.engine.replay import FALLBACK_REASONS, ReplayDriver, segment_from_arrays
from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.kernels.replay_segment import (
    derive_interpod,
    derive_interpod_plain,
    derive_layout,
    replay_segment,
    replay_segment_plain,
)
from ksim_tpu_torch.scenario.generate import churn_scenario, make_node, make_pod
from ksim_tpu_torch.scenario.runner import Operation, ScenarioResult, ScenarioRunner
from ksim_tpu_torch.state.cluster import ClusterStore
from tests.fixtures.preemption_victims import CASES as PREEMPTION_CASES
from tests.helpers import make_node as helpers_make_node
from tests.helpers import make_pod as helpers_make_pod
from tests.test_preemption_fixtures import case_objects

CHURN = dict(n_nodes=200, n_events=800, ops_per_step=50)
RUNNER = dict(max_pods_per_pass=1024, pod_bucket_min=128)


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


def _steps(res) -> list[tuple[int, int, int]]:
    return [(s.step, s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


def _lowered_pair(exact: bool, head_steps: int, k: int = 8):
    """Both packages advanced per-pass through the churn's first
    ``head_steps`` steps, then the next window lowered by each driver:
    (ksim_tpu plan, port plan).  Build under ``x64(exact)``."""
    jr = JaxRunner(**RUNNER)
    tr = ScenarioRunner(**RUNNER, exact=exact, device="cpu")
    jby, jkeys = jr._group_by_step(list(jax_churn(0, **CHURN)))
    tby, tkeys = tr._group_by_step(list(churn_scenario(0, **CHURN)))
    for s in jkeys[:head_steps]:
        jr._run_step(s, jby[s], ScenarioResult())
    for s in tkeys[:head_steps]:
        tr._run_step(s, tby[s], ScenarioResult())
    jplan = JaxReplayDriver(jr.store, jr.service, k=k).prepare_segment(
        [jby[s] for s in jkeys[head_steps : head_steps + k]]
    )
    tplan = ReplayDriver(tr.store, tr.service, k=k).prepare_segment(
        [tby[s] for s in tkeys[head_steps : head_steps + k]]
    )
    assert jplan is not None and tplan is not None
    return jplan, tplan


@pytest.fixture(scope="module")
def lowered():
    """``_lowered_pair(exact, head_steps)``, made once per pair of
    arguments in this module and shared by the tests that ask for it
    again (they only read the plans)."""
    pairs = {}

    def get(exact: bool, head_steps: int):
        if (exact, head_steps) not in pairs:
            with x64(exact):
                pairs[exact, head_steps] = _lowered_pair(exact, head_steps)
        return pairs[exact, head_steps]

    return get


def _reference_segment(plan):
    """ksim_tpu's segment program on its own lowered plan: (final state,
    outputs) as numpy."""
    const_dev, (ev_dev, state_dev) = _pack_plan_buffers(plan, (plan.ev, plan.state0))
    final, outs = _segment_fn(plan.statics, plan.prog, const_dev, ev_dev, state_dev)
    return (
        {k: np.asarray(v) for k, v in final.items()},
        {k: np.asarray(v) for k, v in outs.items()},
    )


def _assert_equal(ref: np.ndarray, got: torch.Tensor, what: str) -> None:
    ref = np.asarray(ref)
    got = got.numpy()
    if what.endswith("pass_count"):
        # ksim_tpu's transfer packing carries the 0-d counter as [1].
        ref, got = ref.reshape(-1, *ref.shape[2:]), got.reshape(-1)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_port_lowers_the_window_as_the_reference_does(exact, lowered):
    jplan, tplan = lowered(exact, 3)
    js, ts = jplan.statics, tplan.statics
    assert (ts.k, ts.q, ts.cap, ts.n_tk, ts.n_dom) == (js.k, js.q, js.cap, js.n_tk, js.n_dom)
    assert tplan.universe_keys == jplan.universe_keys
    assert tplan.node_names == jplan.node_names
    for tree in ("ev", "state0"):
        ref, got = getattr(jplan, tree), getattr(tplan, tree)
        for key in got:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=f"{tree}.{key}")
    for part in ("node", "pods"):
        for key, arr in tplan.const[part].items():
            np.testing.assert_array_equal(arr, jplan.const[part][key], err_msg=f"const.{part}.{key}")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_replay_segment_plain_equals_segment_body(exact, lowered):
    jplan, tplan = lowered(exact, 3)
    with x64(exact):
        ref_state, ref_outs = _reference_segment(jplan)
    const, ev, state0 = segment_from_arrays(dict(jplan.const, aux=jplan.aux), jplan.ev, jplan.state0)
    before = replay_segment.launches
    final, outs = replay_segment(tplan.statics, tplan.prog, const, ev, state0)
    assert replay_segment.launches == before  # CPU tensors: the plain version
    assert set(outs) == {k for k in ref_outs}
    for key in outs:
        _assert_equal(ref_outs[key], outs[key], f"outs.{key}")
    assert set(final) == set(ref_state)
    for key in final:
        _assert_equal(ref_state[key], final[key], f"state.{key}")
    # The window did real work.
    assert int(outs["scheduled"].sum()) > 0 and int(outs["unschedulable"].sum()) > 0


@pytest.mark.parametrize("head_steps", [2, 6, 11])
def test_derive_interpod_plain_equals_reference(head_steps, lowered):
    jplan, _ = lowered(True, head_steps)
    with x64(True):
        ipa = {k: getattr(jplan.aux["interpod"], k) for k in ("node_dom", "term_tk", "dom_t")}
        loc = {k: jplan.state0["ip_" + k] for k in ("cnt", "eat", "vw")}
        ref = jax_derive_interpod(loc, ipa, jplan.statics)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    got = derive_interpod_plain(
        {k: torch.from_numpy(np.array(v)) for k, v in loc.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in ipa.items()},
        jplan.statics.n_tk,
        jplan.statics.n_dom,
    )
    assert set(got) == set(ref)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    assert int(ref["total"].sum()) > 0  # bound pods carry inter-pod terms
    # The wrapper takes the plain version for CPU tensors.
    before = derive_interpod.launches
    again = derive_interpod(
        {k: torch.from_numpy(np.array(v)) for k, v in loc.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in ipa.items()},
        jplan.statics.n_tk,
        jplan.statics.n_dom,
    )
    assert derive_interpod.launches == before
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("head_steps", [2, 11])
def test_derive_layout_indexes_the_lowered_domains(head_steps, lowered):
    jplan, _ = lowered(True, head_steps)
    zone = np.array(jplan.aux["interpod"].node_dom)
    # The churn's one inter-pod key is the zone; a hostname-like key (one
    # node per domain, the live nodes only) is added beside it.
    host = np.where(zone[:, 0] >= 0, np.arange(zone.shape[0]), -1).astype(np.int32)
    node_dom = np.column_stack([zone, host])
    layout = derive_layout(torch.from_numpy(node_dom))
    ldom = layout.ldom.numpy()
    assert ldom.shape == node_dom.shape and len(layout.singleton) == node_dom.shape[1]
    for k, single in enumerate(layout.singleton):
        keyed = node_dom[:, k] >= 0
        ids = node_dom[keyed, k]
        assert single == (len(np.unique(ids)) == len(ids))
        if single:
            assert (ldom[:, k] == -1).all()
            continue
        assert (ldom[~keyed, k] == -1).all()
        local = ldom[keyed, k]
        assert 0 <= local.min() and local.max() < layout.dk
        # Two nodes share a compact index exactly when they share a domain.
        assert (np.equal.outer(local, local) == np.equal.outer(ids, ids)).all()
    assert layout.singleton == (False, True)


def test_device_replay_runner_equals_reference_per_step():
    with x64(False):
        jrun = JaxRunner(**RUNNER, device_replay=True, device_segment_steps=8)
        ref = jrun.run(list(jax_churn(0, **CHURN)))
    trun = ScenarioRunner(**RUNNER, device_replay=True, device_segment_steps=8, exact=False, device="cpu")
    got = trun.run(list(churn_scenario(0, **CHURN)))
    assert _steps(got) == _steps(ref)
    assert (got.events_applied, got.pods_scheduled, got.unschedulable_attempts) == (
        ref.events_applied, ref.pods_scheduled, ref.unschedulable_attempts,
    )
    drv = trun.replay_driver
    assert drv.device_steps >= 8
    assert drv.device_steps + drv.fallback_steps == len(got.steps)
    assert drv.device_steps == jrun.replay_driver.device_steps
    assert set(drv.unsupported) <= FALLBACK_REASONS


def _patch_stream() -> list[Operation]:
    ops = list(churn_scenario(0, n_nodes=40, n_events=400, ops_per_step=40))
    # A node label patch mid-stream: outside the replay's op vocabulary.
    ops.append(Operation(step=0, op="create", kind="nodes", obj=make_node("extra", cpu="8")))
    ops.append(Operation(step=4, op="patch", kind="nodes", name="extra",
                         obj={"metadata": {"labels": {"disktype": "nvme"}}}))
    return sorted(ops, key=lambda op: op.step)


def _priority_stream() -> list[Operation]:
    """Low-priority pods fill the nodes, then high-priority ones arrive:
    DefaultPreemption's victim search runs."""
    ops = [Operation(step=0, op="create", kind="nodes", obj=make_node(f"n{i}", cpu="2", memory="4Gi"))
           for i in range(4)]
    ops += [Operation(step=1, op="create", kind="pods", obj=make_pod(f"low-{i}", cpu="1", priority=1))
            for i in range(8)]
    ops += [Operation(step=2, op="create", kind="pods", obj=make_pod(f"high-{i}", cpu="1", priority=100))
            for i in range(3)]
    ops += [Operation(step=3, op="delete", kind="pods", name="low-0", namespace="default")]
    ops += [Operation(step=4, op="create", kind="pods", obj=make_pod("late", cpu="500m", priority=50))]
    return ops


@pytest.mark.parametrize(
    "case, reason",
    [("patch", "op:patch/nodes"), ("record_full", "record_full"), ("preemption", "preemption")],
)
def test_unsupported_windows_fall_back_with_their_reason(case, reason):
    """A patch op falls back per-pass under its reason.  record="full" and
    DefaultPreemption's victim search once fell back too, under reasons of
    the port's own; both run on the device path now: their reasons are
    gone and the windows equal the per-pass path."""
    kw = dict(RUNNER, exact=True, device="cpu")
    if case == "patch":
        ops = _patch_stream()
    elif case == "record_full":
        ops = list(churn_scenario(1, n_nodes=30, n_events=150, ops_per_step=30))
        kw["record"] = "full"
    else:
        ops = _priority_stream()
        kw["preemption"] = True
    base = ScenarioRunner(**kw)
    per_pass = base.run(list(ops))
    runner = ScenarioRunner(**kw, device_replay=True, device_segment_steps=4)
    got = runner.run(list(ops))
    assert _steps(got) == _steps(per_pass)
    assert got.events_applied == per_pass.events_applied
    drv = runner.replay_driver
    assert drv.device_steps + drv.fallback_steps == len(got.steps)
    if case == "patch":
        assert drv.unsupported.get(reason, 0) >= 1, drv.unsupported
        assert drv.device_steps > 0  # only the patched step's window fell back
        return
    assert reason not in FALLBACK_REASONS
    assert drv.unsupported == {} and drv.fallback_steps == 0 and drv.device_steps == len(got.steps)
    assert _pods(runner) == _pods(base)
    if case == "preemption":
        assert got.pods_scheduled > 0
        assert len(runner.store.list("pods")) < len(ops)  # victims were evicted


def _pods(runner) -> list:
    """Every pod's placement, nomination and result annotations."""
    return sorted(
        (p["metadata"]["name"], p.get("spec", {}).get("nodeName"), p.get("status", {}).get("nominatedNodeName"),
         p["metadata"].get("annotations", {}))
        for p in runner.store.list("pods")
    )


def _evictions(runner) -> list:
    order = []
    runner.service.add_eviction_listener(lambda ns, nm: order.append((ns, nm)))
    return order


def test_full_record_annotations_equal_reference_and_per_pass():
    """record="full" through the device path: the decoded annotations
    equal ksim_tpu's device path and the per-pass path, pod for pod."""

    kw = dict(record="full", max_pods_per_pass=64, pod_bucket_min=32)
    with x64(False):
        jrun = JaxRunner(**kw, device_replay=True, device_segment_steps=8)
        jres = jrun.run(jax_churn(0, n_nodes=24, n_events=160, ops_per_step=16))
    base = ScenarioRunner(**kw, exact=False, device="cpu")
    base_res = base.run(churn_scenario(0, n_nodes=24, n_events=160, ops_per_step=16))
    dev = ScenarioRunner(**kw, device_replay=True, device_segment_steps=8, exact=False, device="cpu")
    dev_res = dev.run(churn_scenario(0, n_nodes=24, n_events=160, ops_per_step=16))
    drv = dev.replay_driver
    assert drv.device_steps >= 4 and drv.fallback_steps == 0, drv.unsupported
    assert drv.device_steps == jrun.replay_driver.device_steps
    assert _steps(dev_res) == _steps(base_res) == _steps(jres)
    assert _pods(dev) == _pods(base)
    ref = {p["metadata"]["name"]: p["metadata"].get("annotations", {}) for p in jrun.store.list("pods")}
    got = {p["metadata"]["name"]: p["metadata"].get("annotations", {}) for p in dev.store.list("pods")}
    assert got == ref
    assert any(got.values())


@pytest.mark.parametrize("case", PREEMPTION_CASES, ids=[c["name"] for c in PREEMPTION_CASES])
def test_device_preemption_matches_fixtures(case):
    """The on-device victim search (kernel D's plain version) lands on the
    hand-derived nominated node and evicts the same victims in the same
    (reprieve) order, and the segment ran on the device path."""
    nodes, victims, pre = case_objects(case)
    store = ClusterStore()
    for n in nodes:
        store.create("nodes", n)
    for v in victims:
        store.create("pods", v)
    runner = ScenarioRunner(store=store, preemption=True, device_replay=True, device_segment_steps=4,
                            exact=False, device="cpu")
    evicted = _evictions(runner)
    runner.run(iter([Operation(step=1, op="create", kind="pods", obj=pre)]))
    assert runner.replay_driver.device_steps >= 1, runner.replay_driver.unsupported
    assert store.get("pods", "preemptor").get("status", {}).get("nominatedNodeName") == case["expected_nominated"]
    assert [nm for _ns, nm in evicted] == case["expected_victims"]


def _strata_stream(op):
    """3 nodes x 4 cpu saturate after 8 x 1.5-cpu pods; later arrivals of
    higher priority preempt the priority-0 stratum mid-segment (the stream
    of ksim_tpu's test_device_preemption_churn_matches_per_pass)."""
    for i in range(3):
        yield op(step=0, op="create", kind="nodes", obj=helpers_make_node(f"n-{i}", cpu="4", memory="16Gi"))
    for step in range(1, 17):
        pod = helpers_make_pod(f"p-{step}", cpu="1500m", memory="256Mi", priority=[0, 0, 5, 10][step % 4])
        pod["metadata"]["creationTimestamp"] = f"2026-01-{step:02d}T00:00:00Z"
        yield op(step=step, op="create", kind="pods", obj=pod)


def test_device_preemption_churn_equals_per_pass_and_reference():
    """The priority-strata churn with preemption on: the device path's
    steps, store and eviction order equal the per-pass path's and
    ksim_tpu's device path's."""

    def port(device_replay):
        runner = ScenarioRunner(preemption=True, device_replay=device_replay, device_segment_steps=4,
                                exact=False, device="cpu")
        ev = _evictions(runner)
        res = runner.run(_strata_stream(Operation))
        return runner, res, ev

    with x64(False):
        jrun = JaxRunner(preemption=True, device_replay=True, device_segment_steps=4)
        jev = _evictions(jrun)
        jres = jrun.run(_strata_stream(JaxOperation))
    base_r, base, base_ev = port(False)
    dev_r, dev, dev_ev = port(True)
    assert _steps(dev) == _steps(base) == _steps(jres)
    assert _pods(dev_r) == _pods(base_r)
    assert dev_ev == base_ev == jev
    assert base_ev, "the stream never preempted"
    assert dev_r.replay_driver.device_steps >= 8
    assert dev_r.replay_driver.unsupported == {}


def test_replay_segment_plain_preemption_full_record_equals_segment_body():
    """A window of the priority-strata churn with preemption on and
    record="full", lowered by both packages: kernel D's plain version
    equals ksim_tpu's segment program on every output (the victim
    search's nominations, victims and overflow; the streamed records on
    the attempted rows) and the final state."""
    kw = dict(preemption=True, record="full")
    with x64(False):
        jr = JaxRunner(**kw)
        jby, jkeys = jr._group_by_step(list(_strata_stream(JaxOperation)))
        for s in jkeys[:9]:
            jr._run_step(s, jby[s], JaxResult())
        jplan = JaxReplayDriver(jr.store, jr.service, k=4).prepare_segment([jby[s] for s in jkeys[9:13]])
        ref_state, ref_outs = _reference_segment(jplan)
    tr = ScenarioRunner(**kw, exact=False, device="cpu")
    tby, tkeys = tr._group_by_step(list(_strata_stream(Operation)))
    for s in tkeys[:9]:
        tr._run_step(s, tby[s], ScenarioResult())
    tplan = ReplayDriver(tr.store, tr.service, k=4).prepare_segment([tby[s] for s in tkeys[9:13]])
    assert tplan.statics.preempt and tplan.statics.record == "full"
    for key in ("priority", "imp_rank", "start_rank", "preempt_ok"):
        np.testing.assert_array_equal(tplan.const["pods"][key], jplan.const["pods"][key], err_msg=key)
    for key in ("name_rank", "want"):
        np.testing.assert_array_equal(tplan.ev[key], jplan.ev[key], err_msg=key)
    np.testing.assert_array_equal(tplan.const["resolv"], jplan.const["resolv"])
    const, ev, state0 = segment_from_arrays(dict(jplan.const, aux=jplan.aux), jplan.ev, jplan.state0)
    final, outs = replay_segment(tplan.statics, tplan.prog, const, ev, state0)
    assert set(outs) == set(ref_outs)
    P = const["pods"]["requests"].shape[0]
    att = torch.from_numpy(np.array(ref_outs["idx"])) < P  # [K, Q]
    for key in outs:
        if key in ("bits", "raw", "final"):
            # Only attempted rows are recorded (the reference's padded
            # rows hold a clamped pod's evaluation, which nothing reads).
            ref = np.asarray(ref_outs[key])[att.numpy()]
            np.testing.assert_array_equal(outs[key][att].numpy(), ref, err_msg=key)
        else:
            _assert_equal(ref_outs[key], outs[key], f"outs.{key}")
    for key in final:
        _assert_equal(ref_state[key], final[key], f"state.{key}")
    assert int((outs["nom"] >= 0).sum()) > 0  # the window preempted


def test_preemption_overflow_discards_the_segment():
    """A victim search with more candidate nodes than the bound (16)
    discards the segment before any store effect; the window runs
    per-pass, with the per-pass outcome."""

    def ops():
        for i in range(18):
            yield Operation(step=0, op="create", kind="nodes", obj=make_node(f"n-{i:02d}", cpu="1", memory="4Gi"))
        for i in range(18):
            yield Operation(step=1, op="create", kind="pods",
                            obj=make_pod(f"low-{i:02d}", cpu="1", memory="64Mi", priority=1))
        yield Operation(step=2, op="create", kind="pods", obj=make_pod("high", cpu="1", memory="64Mi", priority=100))

    def run(device_replay):
        runner = ScenarioRunner(preemption=True, device_replay=device_replay, device_segment_steps=4,
                                exact=False, device="cpu")
        ev = _evictions(runner)
        return runner, runner.run(ops()), ev

    base_r, base, base_ev = run(False)
    dev_r, dev, dev_ev = run(True)
    assert _steps(dev) == _steps(base)
    assert _pods(dev_r) == _pods(base_r)
    assert dev_ev == base_ev and len(base_ev) == 1
    drv = dev_r.replay_driver
    assert drv.unsupported.get("preemption_overflow", 0) >= 1, drv.unsupported
    assert drv.fallback_steps >= 1 and drv.device_steps + drv.fallback_steps == len(dev.steps)
    assert "preemption_overflow" in FALLBACK_REASONS


def test_node_axis_over_the_shared_memory_bound_raises_before_launch():
    """A padded node axis past the shared-memory layout's bound is refused
    with a ValueError naming the bound and the node count (no launch):
    for an 8-block cluster, the smallest kernels A and C launch unforced,
    each block holds whole tiles of 1024 slots, 139,264 padded nodes in
    all for this profile."""
    prm = chain.ChainParams()
    prm.N, prm.I, prm.MC, prm.DMAX, prm.sp_smem = 131072, 8, 2, 3, 1
    chain.check_smem(prm, cluster=8)  # 131,072 padded nodes fit
    fixed = chain.cluster_smem_bytes(prm, 8, 1024) - 13 * 131072 // 8
    assert fixed == 8 * 8 + 8 * 33 + 8 * 2 + 4 * (33 * chain.RED_MAX + chain.SCAN_INTS + 2 * chain.RED_MAX + 128) \
        + chain.SPREAD_CON_BYTES * 2 + 2 * 4 * 4 * 2 * 3
    prm.N = 262144
    bound = (chain.MAX_SMEM_BYTES - fixed - 7) // 13 // 1024 * 1024 * 8
    assert bound == 139264
    with pytest.raises(ValueError, match=rf"N=262144.*8-block cluster.*232448.*{bound} padded nodes"):
        chain.check_smem(prm, cluster=8)
    prm.N = 131072
    with pytest.raises(ValueError, match="N=131072"):
        chain.check_smem(prm, cluster=8, extra=32768)  # kernel D's domain scratch on top

def _placements(runner) -> dict:
    return {f"{p['metadata'].get('namespace', '')}/{p['metadata']['name']}": p.get("spec", {}).get("nodeName")
            for p in runner.store.list("pods")}


def test_replay_tp_mesh_is_refused_where_the_driver_is_built(monkeypatch):
    """``KSIM_REPLAY_TP`` above 1 (the reference's node mesh over devices,
    not ported) raises NotImplementedError naming the knob when a solo
    replay builds its driver, never runs as if unset; a value that is not
    an integer raises int()'s ValueError, as in the reference."""
    monkeypatch.setenv("KSIM_REPLAY_TP", "2")
    with pytest.raises(NotImplementedError, match="KSIM_REPLAY_TP"):
        ScenarioRunner(**RUNNER, device_replay=True, device="cpu").run(iter(()))
    tr = ScenarioRunner(**RUNNER, device="cpu")
    with pytest.raises(NotImplementedError, match="KSIM_REPLAY_TP .*engine/sharding.py"):
        ReplayDriver(tr.store, tr.service)
    monkeypatch.setenv("KSIM_REPLAY_TP", "two")
    with pytest.raises(ValueError, match="invalid literal for int"):
        ReplayDriver(tr.store, tr.service)


@pytest.mark.parametrize("width", ["1", "0"])
def test_replay_tp_width_one_replays_as_unset(width, monkeypatch):
    """``KSIM_REPLAY_TP`` of 1 or 0 is the single-device layout: the churn
    replays to the same steps, placements and device steps as with the
    knob unset."""
    ops = list(churn_scenario(0, n_nodes=40, n_events=300, ops_per_step=30))
    runs = {}
    for value in (None, width):
        if value is None:
            monkeypatch.delenv("KSIM_REPLAY_TP", raising=False)
        else:
            monkeypatch.setenv("KSIM_REPLAY_TP", value)
        run = ScenarioRunner(**RUNNER, device_replay=True, device_segment_steps=8, exact=False, device="cpu")
        res = run.run(list(ops))
        runs[value] = (_steps(res), _placements(run), run.replay_driver.device_steps)
    assert runs[width] == runs[None]
    assert runs[None][2] > 0 and any(node for node in runs[None][1].values())
