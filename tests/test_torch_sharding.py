"""The port's device mesh (ksim_tpu_torch/engine/sharding.py) against
ksim_tpu's, on the CPU.

ksim_tpu lays its engines over the eight virtual CPU devices the conftest
gives XLA; the port over eight CPU shards (sharding.CPU_SHARDS), where the
kernels' wrappers take their plain versions over the gathered shards
(kernels/sharded.py).  The same FeaturizedSnapshot (``snapshot_from_arrays``
of ksim_tpu's) goes through both, in exact mode (x64 on) and f32 mode (x64
off); the tolerance is equality: every output is an integer or a bool.

- batch evaluation at ``make_mesh(8, dp=2)``, ``schedule`` at
  ``make_mesh(8, dp=1)``, the sampled scan, and the per-pass churn through
  ``SchedulerService(shard_mesh=...)``;
- ``KSIM_FLEET_DP=2`` lanes against the solo run, with the mesh built, and
  its one-warning degradation on a host with too few devices;
- the mesh helpers' layouts against the reference's PartitionSpecs;
- the refusals left: ``KSIM_REPLAY_TP``, a service mesh with tp > 1
  reaching a replay driver, the staged route under tp > 1 and a fleet
  plan with tp > 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from ksim_tpu.engine import sharding as jax_sharding
from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.engine.profiles import default_plugins as jax_default_plugins
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.engine import fleet as fleet_mod
from ksim_tpu_torch.engine import sharding
from ksim_tpu_torch.engine.core import Engine, PluginExtender
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.state.featurizer import snapshot_from_arrays
from tests.helpers import make_node, make_pod, random_cluster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _pair(nodes, pods, record, exact, sampling_k=None, **kw):
    """(ksim_tpu Engine, port Engine) over one ksim_tpu-featurized
    snapshot; build under x64(exact)."""
    jf = JaxFeaturizer().featurize(nodes, pods, **kw)
    tf = snapshot_from_arrays(jf)
    ref = JaxEngine(jf, jax_default_plugins(jf), record=record, sampling_k=sampling_k)
    port = Engine(tf, default_plugins(tf), record=record, exact=exact, device="cpu", sampling_k=sampling_k)
    return ref, port


EXACT = pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])


@EXACT
@pytest.mark.parametrize("path", ["chunks", "fused"])
def test_batch_eval_sharded_matches_reference(exact, path):
    nodes, pods = random_cluster(3, n_nodes=30, n_pods=50)
    with x64(exact):
        ref, port = _pair(nodes, pods, "full" if path == "chunks" else "final", exact)
        ref.shard(jax_sharding.make_mesh(8, dp=2))
        port.shard(sharding.make_mesh(8, dp=2))
        a = ref.evaluate_batch() if path == "chunks" else ref.evaluate_batch_fused()
    b = port.evaluate_batch() if path == "chunks" else port.evaluate_batch_fused()
    for name in ("selected", "reason_bits", "scores", "total", "final_scores"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        np.testing.assert_array_equal(y, np.asarray(x), err_msg=name)


@EXACT
def test_schedule_sharded_matches_reference(exact):
    nodes, pods = random_cluster(3, n_nodes=30, n_pods=50)
    with x64(exact):
        ref, port = _pair(nodes, pods, "selection", exact)
        ref.shard(jax_sharding.make_mesh(8, dp=1))
        ra, sa = ref.schedule()
    single = Engine(port._feats, default_plugins(port._feats), record="selection", exact=exact, device="cpu")
    port.shard(sharding.make_mesh(8, dp=1))
    rb, sb = port.schedule()
    rc, sc = single.schedule()
    np.testing.assert_array_equal(rb.selected, np.asarray(ra.selected))
    np.testing.assert_array_equal(rb.selected, rc.selected)
    for name in ("requested", "nonzero_requested", "pod_count"):
        np.testing.assert_array_equal(getattr(sb, name), np.asarray(getattr(sa, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(sb, name), getattr(sc, name), err_msg=name)


@EXACT
def test_sampled_schedule_sharded_matches_reference(exact):
    nodes = [make_node(f"n{i:03d}", unschedulable=i % 7 == 3) for i in range(24)]
    pods = [make_pod(f"p{i}") for i in range(6)]
    with x64(exact):
        ref, port = _pair(nodes, [], "full", exact, sampling_k=5, queue_pods=pods)
        ref.shard(jax_sharding.make_mesh(8, dp=1))
        ra, _ = ref.schedule(sampling_start=2)
    port.shard(sharding.make_mesh(8, dp=1))
    rb, _ = port.schedule(sampling_start=2)
    np.testing.assert_array_equal(rb.selected, np.asarray(ra.selected))
    np.testing.assert_array_equal(rb.visited, np.asarray(ra.visited))
    assert rb.sampling_next_start == ra.sampling_next_start


def _churn(runner_cls, service_cls, store_cls, churn, mesh, **kw):
    store = store_cls()
    svc = service_cls(store, record="selection", preemption=False, max_pods_per_pass=64, shard_mesh=mesh, **kw)
    res = runner_cls(store, svc).run(churn(7, n_nodes=24, n_events=400, ops_per_step=40))
    bindings = {
        f"{p['metadata']['namespace']}/{p['metadata']['name']}": p["spec"].get("nodeName")
        for p in store.list("pods")
    }
    return (res.pods_scheduled, res.unschedulable_attempts, [s.scheduled for s in res.steps]), bindings


@EXACT
def test_churn_per_pass_sharded_matches_reference(exact):
    """The per-pass churn through ``SchedulerService(shard_mesh=...)``:
    the bindings, counts and per-step scheduled of ksim_tpu's service on
    its mesh, and of the port's unsharded service."""
    from ksim_tpu.scenario import ScenarioRunner as JaxRunner
    from ksim_tpu.scenario import churn_scenario as jax_churn
    from ksim_tpu.scheduler.service import SchedulerService as JaxService
    from ksim_tpu.state.cluster import ClusterStore as JaxStore
    from ksim_tpu_torch.scenario.generate import churn_scenario
    from ksim_tpu_torch.scenario.runner import ScenarioRunner
    from ksim_tpu_torch.scheduler.service import SchedulerService
    from ksim_tpu_torch.state.cluster import ClusterStore

    with x64(exact):
        ref = _churn(JaxRunner, JaxService, JaxStore, jax_churn, jax_sharding.make_mesh(8, dp=1))
    got = _churn(ScenarioRunner, SchedulerService, ClusterStore, churn_scenario, sharding.make_mesh(8, dp=1),
                 exact=exact, device="cpu")
    single = _churn(ScenarioRunner, SchedulerService, ClusterStore, churn_scenario, None,
                    exact=exact, device="cpu")
    assert got == ref
    assert got == single


def _fleet_run(monkeypatch, dp: "str | None"):
    from ksim_tpu_torch.scenario.generate import churn_scenario
    from ksim_tpu_torch.scenario.runner import ScenarioRunner

    kw = dict(max_pods_per_pass=1024, pod_bucket_min=128, device_segment_steps=8, exact=False, device="cpu")
    solo = ScenarioRunner(device_replay=True, **kw).run(churn_scenario(0, n_nodes=48, n_events=200, ops_per_step=20))
    if dp is not None:
        monkeypatch.setenv("KSIM_FLEET_DP", dp)
    fleet_r = ScenarioRunner(device_replay=True, fleet=2, **kw)
    fleet_r.run(churn_scenario(0, n_nodes=48, n_events=200, ops_per_step=20))
    return solo, fleet_r


def _steps(res):
    return [(s.scheduled, s.unschedulable) for s in res.steps], res.pods_scheduled, res.unschedulable_attempts


def test_fleet_dp_mesh_lanes_match_solo(monkeypatch):
    """KSIM_FLEET_DP=2 lays the lane-stacked launch's lanes over two CPU
    shards (as ksim_tpu's tests/test_replay_device.py lays them over two
    virtual devices): every lane lands the solo run's steps, and the mesh
    was built, not the single-device degradation."""
    solo, fleet_r = _fleet_run(monkeypatch, "2")
    fd = fleet_r.fleet_driver
    assert fd.dp == 2 and fd.vmap_cohort
    with fd._mesh_lock:
        assert fd._mesh and not fd._mesh_failed
        assert fd._mesh[(2, 1)].dp == 2
    stats = fd.stats()
    assert stats["lanes_on_device"] == 1.0 and stats["cohort_mode"] == "vmap"
    assert stats["group_dispatches"] > 0
    for ln in fleet_r.fleet_lanes:
        assert _steps(ln.result) == _steps(solo), ln.idx


def test_fleet_dp_on_too_few_devices_warns_and_stays_single_device(monkeypatch, caplog):
    """With fewer devices than KSIM_FLEET_DP (one H100 with
    KSIM_FLEET_DP=2), the fleet logs the reference's warning once and
    dispatches on one device; every lane still lands the solo run."""
    monkeypatch.setattr(fleet_mod, "FLEET_DEVICES", [torch.device("cpu")])
    with caplog.at_level(logging.WARNING, logger="ksim_tpu_torch.engine.fleet"):
        solo, fleet_r = _fleet_run(monkeypatch, "2")
    fd = fleet_r.fleet_driver
    with fd._mesh_lock:
        assert fd._mesh_failed and not fd._mesh
    warnings = [r for r in caplog.records if "KSIM_FLEET_DP=2 x tp=1 mesh unavailable" in r.getMessage()]
    assert len(warnings) == 1
    assert "fleet dispatch stays single-device" in warnings[0].getMessage()
    assert fd.stats()["lanes_on_device"] == 1.0
    for ln in fleet_r.fleet_lanes:
        assert _steps(ln.result) == _steps(solo), ln.idx


def _spec(layout) -> tuple:
    return tuple(layout.spec)


def test_mesh_helpers_match_reference_layouts():
    """Every helper's layout is the reference's PartitionSpec, axis by
    axis; make_mesh factors as the reference does and refuses too few
    devices; put / full round-trip each layout."""
    for n, shape in ((8, (2, 4)), (6, (2, 3)), (4, (2, 2)), (2, (1, 2)), (3, (1, 3)), (1, (1, 1))):
        m, jm = sharding.make_mesh(n), jax_sharding.make_mesh(n)
        assert (m.dp, m.tp) == shape == tuple(jm.devices.shape)
        assert m.axis_names == tuple(jm.axis_names)
    assert (sharding.make_mesh(8, dp=1).dp, sharding.make_mesh(8, dp=1).tp) == (1, 8)
    with pytest.raises(ValueError, match="cannot factor"):
        sharding.make_mesh(8, dp=3)
    with pytest.raises(ValueError, match="needs 16"):
        sharding.make_mesh(16)
    with pytest.raises(ValueError, match="fleet mesh dp=16"):
        sharding.fleet_mesh(16)
    assert sharding.fleet_mesh(2).dp == 2 and sharding.fleet_mesh(2, 2).tp == 2
    m, jm = sharding.make_mesh(8), jax_sharding.make_mesh(8)
    pairs = [
        (sharding.lane_sharding(m, 0), jax_sharding.lane_sharding(jm, 0)),
        (sharding.lane_sharding(m, 3), jax_sharding.lane_sharding(jm, 3)),
        (sharding.lane_node_sharding(m, 1), jax_sharding.lane_node_sharding(jm, 1)),
        (sharding.lane_node_sharding(m, 3), jax_sharding.lane_node_sharding(jm, 3)),
        (sharding.node_leading_sharding(m, 0), jax_sharding.node_leading_sharding(jm, 0)),
        (sharding.node_leading_sharding(m, 2), jax_sharding.node_leading_sharding(jm, 2)),
        (sharding.node_axis_sharding(m, 2, 1), jax_sharding.node_axis_sharding(jm, 2, 1)),
        (sharding.replicated_sharding(m, 2), jax_sharding.replicated_sharding(jm, 2)),
    ]
    pairs += list(zip(sharding.node_state_shardings(m), jax_sharding.node_state_shardings(jm)))
    for ours, theirs in pairs:
        ref = tuple(theirs.spec) + (None,) * (len(ours.spec) - len(tuple(theirs.spec)))
        assert _spec(ours) == ref, (ours.spec, theirs.spec)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 100, size=(8, 4, 3)).astype(np.int32))
    for layout in (sharding.lane_node_sharding(m, 3), sharding.node_axis_sharding(m, 3, 1),
                   sharding.replicated_sharding(m, 3), sharding.lane_sharding(m, 3)):
        laid = sharding.put(a, layout)
        assert len(laid.shards) == 8
        assert torch.equal(laid.full(), a), layout.spec
        assert all(s.data_ptr() != laid.shards[0].data_ptr() for s in laid.shards[1:])
    laid = sharding.put(a, sharding.node_leading_sharding(m, 3))
    assert laid.shard(1, 2).shape == (2, 4, 3)
    assert torch.equal(laid.shard(1, 2), a[4:6]) and torch.equal(laid.shard(0, 2), laid.shard(1, 2))
    with pytest.raises(ValueError, match="does not divide"):
        sharding.put(torch.zeros(6, 2), sharding.node_leading_sharding(m, 2))
    tree = {"f": {"node": a, "pod": a, "rep": a}}
    axes = {"f": {"node": "node", "pod": "pod", "rep": None}}
    out = sharding.shard_aux(tree, axes, m)
    assert _spec(out["f"]["node"].layout) == ("tp", None, None)
    assert _spec(out["f"]["pod"].layout) == ("dp", None, None)
    assert _spec(out["f"]["rep"].layout) == (None, None, None)
    lanes = sharding.shard_lane_axis({"x": a}, m)
    assert _spec(lanes["x"].layout) == ("dp", None, None)
    rep = sharding.replicate_tree({"x": a}, m)
    assert torch.equal(sharding.gather_tree(rep)["x"], a)


def test_engine_shard_lays_out_the_reference_axes():
    """Engine.shard lays the node state over tp, the pods over dp and the
    aux by the featurizer's AXES (the reference's _aux_host), keeps every
    shard its own tensor, and refuses a tp that does not divide the padded
    node axis."""
    nodes, pods = random_cluster(1, n_nodes=30, n_pods=20)
    with x64(True):
        _, port = _pair(nodes, pods, "selection", True)
    N = int(port._feats.nodes.valid.shape[0])
    with pytest.raises(ValueError, match="does not divide over tp=3"):
        Engine(port._feats, default_plugins(port._feats), device="cpu").shard(sharding.make_mesh(3))
    port.shard(sharding.make_mesh(8))
    assert _spec(port._node_state.requested.layout) == ("tp", None)
    assert port._node_state.valid.shard(0, 3).shape == (N // 4,)
    assert _spec(port._pods.index.layout) == ("dp",)
    assert _spec(port._aux["taints"]["node_taint_order"].layout) == ("tp", None)
    assert _spec(port._aux["taints"]["pod_tolerated"].layout) == ("dp", None)
    assert _spec(port._aux["taints"]["forbidding"].layout) == (None,)
    assert _spec(port._aux["affinity"]["term_ok"].layout) == ("tp", None)
    assert _spec(port._aux["interpod"]["dom_t"].layout) == ("tp", None)
    assert _spec(port._aux["spread"]["log_w64"].layout) == (None,)
    assert _spec(port._carries0["InterPodAffinity"]["total"].layout) == (None,)
    assert _spec(port._carries0["InterPodAffinity"]["cnt"].layout) == ("tp", None)


def test_refusals_left(monkeypatch):
    """What this port still refuses, each naming what waits: the replay's
    node mesh (KSIM_REPLAY_TP, and a service mesh with tp > 1 reaching a
    replay driver), the staged route under tp > 1, and a fleet plan with
    tp > 1.  A dp > 1 mesh reaching the replay falls back per pass with
    the reference's reason "shard_mesh"."""
    from ksim_tpu_torch.engine.fleet import FleetDriver
    from ksim_tpu_torch.engine.replay import ReplayDriver
    from ksim_tpu_torch.scheduler.service import SchedulerService
    from ksim_tpu_torch.state.cluster import ClusterStore

    store = ClusterStore()
    monkeypatch.setenv("KSIM_REPLAY_TP", "2")
    with pytest.raises(NotImplementedError, match="KSIM_REPLAY_TP.*kernel D's node shards"):
        ReplayDriver(store, SchedulerService(store, device="cpu"))
    monkeypatch.delenv("KSIM_REPLAY_TP")
    svc = SchedulerService(store, shard_mesh=sharding.make_mesh(8, dp=1), device="cpu")
    with pytest.raises(NotImplementedError, match="shard_mesh with tp > 1.*kernel D's node shards"):
        ReplayDriver(store, svc)
    svc = SchedulerService(store, record="selection", shard_mesh=sharding.make_mesh(8, dp=2), device="cpu")
    drv = ReplayDriver(store, svc)
    assert not drv.service_supported()
    assert drv.unsupported == {"shard_mesh": 1}
    one = SchedulerService(store, record="selection", shard_mesh=sharding.make_mesh(1, dp=1), device="cpu")
    assert ReplayDriver(store, one).service_supported()
    nodes, pods = random_cluster(1, n_nodes=16, n_pods=8)
    with x64(True):
        _, port = _pair(nodes, pods, "selection", True)
    plugins = default_plugins(port._feats)
    hooked = (dataclasses.replace(plugins[0], extender=PluginExtender(after_score=lambda s, p, a, x: x)),)
    eng = Engine(port._feats, hooked + tuple(plugins[1:]), record="selection", device="cpu")
    assert eng.route == "staged"
    with pytest.raises(NotImplementedError, match="kernel E's stages.*tp > 1"):
        eng.shard(sharding.make_mesh(8, dp=1))
    monkeypatch.setenv("KSIM_FLEET_DP", "2")
    fd = FleetDriver([])
    assert fd.dp == 2 and fd._worker_mesh().dp == 2
    with pytest.raises(NotImplementedError, match="tp > 1.*kernel D's node shards"):
        fd._worker_mesh(tp=2)
