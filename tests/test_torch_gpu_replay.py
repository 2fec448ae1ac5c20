"""Kernel D (replay_segment), its fleet launch (replay_segment_fleet) and
row 6's standalone entry (derive_interpod) against their plain PyTorch
versions on a CUDA device, element for element (tolerance 0), on small
churn replays with the whole default profile: record="selection", the
on-device DefaultPreemption victim search (the hand-derived fixtures and
a priority-strata churn), record="full" and inter-pod terms over 17
topology keys, at the cluster size the launch picks and at forced sizes
of 2, 8 and 16 blocks; a node axis past one block's shared-memory bound;
and the fleet runner in both cohort modes against the solo device run.

Marked ``gpu``; each test skips when there is no CUDA device.  This file
imports neither jax nor ksim_tpu:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_replay.py
"""

from __future__ import annotations

import ctypes

import pytest
import torch
from fixtures.preemption_victims import CASES as PREEMPTION_CASES

import ksim_tpu_torch.engine.replay as replay_mod
from ksim_tpu_torch.kernels import replay_segment as segment_mod
from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.scenario.generate import churn_scenario, make_node, make_pod
from ksim_tpu_torch.scenario.runner import Operation, ScenarioRunner
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import ClusterStore
from test_torch_clusters import WIDE_CONFIG, wide_cluster

pytestmark = pytest.mark.gpu

CHURN = dict(n_nodes=200, n_events=800, ops_per_step=50)
# Forced cluster sizes (kernels/replay_segment.py CLUSTER_SIZE).
CLUSTER_SIZES = (2, 8, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


def _capture(monkeypatch) -> list:
    """Every kernel-D dispatch of the device path from here on:
    (statics, prog, const, ev, state0, final, outs)."""
    segments = []
    kernel = replay_mod.replay_segment

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments.append((st, prog, const, ev, held, final, outs))
        return final, outs

    monkeypatch.setattr(replay_mod, "replay_segment", capture)
    return segments


def _replay(device: str, exact: bool, monkeypatch):
    """The churn through the device path; returns (result, the segments)."""
    segments = _capture(monkeypatch)
    runner = ScenarioRunner(max_pods_per_pass=1024, pod_bucket_min=128, device_replay=True,
                            device_segment_steps=8, exact=exact, device=device)
    return runner.run(list(churn_scenario(0, **CHURN))), segments


def _assert_plain_equal(segments) -> None:
    """Kernel D's outputs and final state equal its plain version's."""
    assert segments
    for st, prog, const, ev, state0, final, outs in segments:
        want_final, want_outs = segment_mod.replay_segment_plain(st, prog, const, ev, state0)
        assert set(outs) == set(want_outs)
        for key in want_outs:
            assert torch.equal(outs[key], want_outs[key]), key
        for key in want_final:
            assert torch.equal(final[key], want_final[key]), key


def case_objects(case):
    """(nodes, victims, preemptor) of one hand-derived preemption case
    (tests/test_preemption_fixtures.py case_objects, with the port's
    object builders)."""
    nodes = [make_node(nm, cpu=cpu, memory="8Gi") for nm, cpu in case["nodes"]]
    victims = []
    for spec in case["victims"]:
        name, node, cpu, prio, start = spec[:5]
        p = make_pod(name, cpu=cpu, memory=None, node_name=node, priority=prio)
        p["metadata"]["creationTimestamp"] = spec[5] if len(spec) > 5 else "2024-01-01T00:00:00Z"
        p.setdefault("status", {})["phase"] = "Running"
        if start:
            p["status"]["startTime"] = start
        victims.append(p)
    cpu, prio, policy = case["preemptor"]
    pre = make_pod("preemptor", cpu=cpu, memory=None, priority=prio)
    if policy:
        pre["spec"]["preemptionPolicy"] = policy
    return nodes, victims, pre


def priority_strata_stream():
    """3 nodes x 4 cpu saturate after 8 x 1.5-cpu pods; later arrivals of
    higher priority preempt the priority-0 stratum mid-segment."""
    for i in range(3):
        yield Operation(step=0, op="create", kind="nodes", obj=make_node(f"n-{i}", cpu="4", memory="16Gi"))
    for step in range(1, 17):
        pod = make_pod(f"p-{step}", cpu="1500m", memory="256Mi", priority=[0, 0, 5, 10][step % 4])
        pod["metadata"]["creationTimestamp"] = f"2026-01-{step:02d}T00:00:00Z"
        yield Operation(step=step, op="create", kind="pods", obj=pod)


def preemption_churn_stream(n_nodes: int = 2000, n_batch_nodes: int = 12, n_waves: int = 8, ops_per_step: int = 100):
    """A preemption-heavy churn: ``n_nodes`` 4-cpu nodes; a priority-100
    service tier fills all but ``n_batch_nodes`` of them (one 4-cpu pod
    each, ``ops_per_step`` per step), a priority-0 batch tier fills the
    rest (two 1.5-cpu pods each); then waves of 1.5-cpu arrivals at
    priority 5 and 10 that fit only by preemption, with two service
    completions every other wave freeing nodes for them.  Candidates of a
    search are the nodes holding lower-priority pods: the batch nodes and
    the freed ones, so late waves may pass the search's 16-node bound."""
    for i in range(n_nodes):
        yield Operation(step=0, op="create", kind="nodes", obj=make_node(f"node-{i:04d}", cpu="4", memory="16Gi"))
    step, made = 1, 0
    services = []
    while made < n_nodes - n_batch_nodes:
        for _ in range(min(ops_per_step, n_nodes - n_batch_nodes - made)):
            services.append(f"svc-{made:04d}")
            yield Operation(step=step, op="create", kind="pods",
                            obj=make_pod(services[-1], cpu="4", memory="1Gi", priority=100))
            made += 1
        step += 1
    for i in range(2 * n_batch_nodes):
        yield Operation(step=step, op="create", kind="pods",
                        obj=make_pod(f"batch-{i:02d}", cpu="1500m", memory="256Mi", priority=0))
    step += 1
    for wave in range(n_waves):
        for i in range(6):
            pod = make_pod(f"w{wave}-{i}", cpu="1500m", memory="256Mi", priority=[5, 10][(wave + i) % 2])
            pod["metadata"]["creationTimestamp"] = f"2026-02-{wave + 1:02d}T00:00:{i:02d}Z"
            yield Operation(step=step, op="create", kind="pods", obj=pod)
        if wave % 2 == 1:
            for name in services[wave : wave + 2]:
                yield Operation(step=step, op="delete", kind="pods", name=name, namespace="default")
        step += 2


def interpod_keys_stream(n_keys: int = 17, n_nodes: int = 24, n_steps: int = 12):
    """Inter-pod terms over ``n_keys`` topology keys (every fourth a
    hostname-like key, one domain per node; the others three domains of
    eight nodes): required anti-affinity, preferred affinity and preferred
    anti-affinity, one key per pod in turn, with a completion every third
    step."""
    keys = [f"topo.example.com/k{i:02d}" for i in range(n_keys)]
    for i in range(n_nodes):
        labels = {key: (f"n{i}" if j % 4 == 0 else f"d{(i * (j + 1)) % 3}") for j, key in enumerate(keys)}
        yield Operation(step=0, op="create", kind="nodes",
                        obj=make_node(f"n-{i:02d}", cpu="4", memory="16Gi", labels=labels))
    made = []
    for step in range(1, n_steps + 1):
        for q in range(4):
            j = step * 4 + q
            app = f"a{j % 3}"
            term = {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": keys[j % n_keys]}
            if j % 5 == 0:
                affinity = {"podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [term]}}
            elif j % 5 == 1:
                affinity = {"podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 7, "podAffinityTerm": term}]}}
            else:
                affinity = {"podAntiAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 10, "podAffinityTerm": term}]}}
            made.append(f"p-{j:03d}")
            yield Operation(step=step, op="create", kind="pods",
                            obj=make_pod(made[-1], cpu="500m", memory="512Mi", labels={"app": app},
                                         affinity=affinity))
        if step % 3 == 0:
            yield Operation(step=step, op="delete", kind="pods", name=made[step], namespace="default")


def wide_stream(n_nodes: int = 16, n_steps: int = 10):
    """A churn over tests/test_torch_clusters.py wide_cluster's nodes (six
    extended resources, 17 attach pools, 17 topology keys) and its queue's
    pods, volumes and bindings dropped (the device path takes neither):
    extended requests and spread constraints over the 17 keys, pod-0 with
    9 of them; four arrivals a step, a completion every third step."""
    nodes, pods, _ = wide_cluster(0, n_nodes=n_nodes, n_pods=4 * n_steps)
    for node in nodes:
        yield Operation(step=0, op="create", kind="nodes", obj=node)
    for step in range(1, n_steps + 1):
        for pod in pods[4 * (step - 1): 4 * step]:
            pod["spec"].pop("volumes", None)
            pod["spec"].pop("nodeName", None)
            yield Operation(step=step, op="create", kind="pods", obj=pod)
        if step % 3 == 0:
            yield Operation(step=step, op="delete", kind="pods", name=pods[step]["metadata"]["name"],
                            namespace="default")


def wide_runner(device, *, device_replay: bool, exact: bool = False) -> ScenarioRunner:
    """A runner whose service compiles WIDE_CONFIG: every profile table
    past its old fixed width, EBSLimits and GCEPDLimits beside
    NodeVolumeLimits."""
    store = ClusterStore()
    service = SchedulerService(store, config=WIDE_CONFIG, preemption=False, max_pods_per_pass=64,
                               pod_bucket_min=16, exact=exact, device=device)
    return ScenarioRunner(store=store, service=service, device_replay=device_replay, device_segment_steps=4,
                          exact=exact, device=device)


def store_view(runner) -> list:
    """Every pod's placement, nomination and result annotations."""
    return sorted(
        (p["metadata"]["name"], p.get("spec", {}).get("nodeName"), p.get("status", {}).get("nominatedNodeName"),
         p["metadata"].get("annotations", {}))
        for p in runner.store.list("pods")
    )


def _steps(res):
    return [(s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_replay_segment_kernel_matches_plain(cuda, exact, monkeypatch):
    before = segment_mod.replay_segment.launches
    segment_mod.reset_derive_runs()
    res, segments = _replay(cuda, exact, monkeypatch)
    assert segment_mod.replay_segment.launches - before == len(segments) > 0
    # Row 6 runs once per active step inside kernel D, which counts it.
    assert segment_mod.derive_runs() == sum(int(ev["active"].sum()) for _st, _p, _c, ev, *_ in segments)
    _assert_plain_equal(segments)
    cpu_res, _ = _replay("cpu", exact, monkeypatch)
    assert _steps(res) == _steps(cpu_res)


@pytest.mark.parametrize("smem", [True, False], ids=["shared", "global"])
def test_derive_interpod_kernel_matches_plain(cuda, smem, monkeypatch):
    _res, segments = _replay(cuda, False, monkeypatch)
    if not smem:
        monkeypatch.setattr(segment_mod, "DERIVE_SMEM_BYTES", 0)
    for st, _prog, const, _ev, state0, _final, _outs in segments:
        ipa = const["aux"]["interpod"]
        loc = {k: state0["ip_" + k] for k in ("cnt", "eat", "vw")}
        got = segment_mod.derive_interpod(loc, ipa, st.n_tk, st.n_dom)
        want = segment_mod.derive_interpod_plain(loc, ipa, st.n_tk, st.n_dom)
        for key in want:
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("case", PREEMPTION_CASES, ids=[c["name"] for c in PREEMPTION_CASES])
def test_replay_segment_kernel_preemption_fixtures(cuda, case, monkeypatch):
    """The victim search on the card lands on the hand-derived node and
    evicts the same victims in the same order, and kernel D equals its
    plain version on the segment."""
    nodes, victims, pre = case_objects(case)
    store = ClusterStore()
    for n in nodes:
        store.create("nodes", n)
    for v in victims:
        store.create("pods", v)
    segments = _capture(monkeypatch)
    runner = ScenarioRunner(store=store, preemption=True, device_replay=True, device_segment_steps=4,
                            exact=False, device=cuda)
    evicted = []
    runner.service.add_eviction_listener(lambda ns, nm: evicted.append(nm))
    runner.run(iter([Operation(step=1, op="create", kind="pods", obj=pre)]))
    assert runner.replay_driver.device_steps >= 1, runner.replay_driver.unsupported
    got = store.get("pods", "preemptor").get("status", {}).get("nominatedNodeName")
    assert got == case["expected_nominated"]
    assert evicted == case["expected_victims"]
    assert all(seg[0].preempt for seg in segments)
    _assert_plain_equal(segments)


@pytest.mark.parametrize("record", ["selection", "full"])
def test_replay_segment_kernel_preemption_churn_matches_per_pass(cuda, record, monkeypatch):
    """The priority-strata churn on the card: kernel D (victim search, and
    under record="full" the streamed records and the resolvability mask)
    equals its plain version, and the run equals the per-pass path's
    steps, store and eviction order."""

    def run(device_replay: bool, device: str):
        runner = ScenarioRunner(preemption=True, record=record, device_replay=device_replay,
                                device_segment_steps=4, exact=False, device=device)
        evicted = []
        runner.service.add_eviction_listener(lambda ns, nm: evicted.append(nm))
        res = runner.run(priority_strata_stream())
        return runner, _steps(res), store_view(runner), evicted

    segments = _capture(monkeypatch)
    runner, steps, store, evicted = run(True, cuda)
    assert runner.replay_driver.device_steps >= 8, runner.replay_driver.unsupported
    assert any(seg[0].preempt for seg in segments)
    assert any(bool((seg[6]["nom"] >= 0).any()) for seg in segments)  # a search nominated on the card
    _assert_plain_equal(segments)
    _r, want_steps, want_store, want_evicted = run(False, "cpu")
    assert (steps, store, evicted) == (want_steps, want_store, want_evicted)
    assert evicted


def test_replay_segment_kernel_full_record_matches_per_pass(cuda, monkeypatch):
    """record="full" through kernel D: the streamed records equal the
    plain version's and the decoded annotations the per-pass path's."""
    kw = dict(record="full", max_pods_per_pass=64, pod_bucket_min=32, exact=False)

    def stream():
        return churn_scenario(0, n_nodes=24, n_events=160, ops_per_step=16)

    segments = _capture(monkeypatch)
    dev = ScenarioRunner(**kw, device_replay=True, device_segment_steps=8, device=cuda)
    dev_res = dev.run(stream())
    assert dev.replay_driver.device_steps >= 4, dev.replay_driver.unsupported
    assert all(seg[0].record == "full" and seg[0].k == 4 for seg in segments)
    _assert_plain_equal(segments)
    base = ScenarioRunner(**kw, device="cpu")
    base_res = base.run(stream())
    assert _steps(dev_res) == _steps(base_res)
    assert store_view(dev) == store_view(base)


def test_replay_segment_fleet_kernel_matches_plain_and_solo(cuda, monkeypatch):
    """Rows 10-11: one launch of S blocks equals the fleet plain version
    and, lane by lane, the solo launch; row 6 runs S times per active
    step."""
    _res, segments = _replay(cuda, False, monkeypatch)
    lanes = 3
    for st, prog, const, ev, state0, final, outs in segments[:2]:
        stacked = {k: torch.stack([v] * lanes) for k, v in state0.items()}
        before = segment_mod.replay_segment_fleet.launches
        segment_mod.reset_derive_runs()
        got_final, got_outs = segment_mod.replay_segment_fleet(st, prog, const, ev, stacked)
        assert segment_mod.replay_segment_fleet.launches == before + 1
        assert segment_mod.derive_runs() == lanes * int(ev["active"].sum())
        want_final, want_outs = segment_mod.replay_segment_fleet_plain(st, prog, const, ev, stacked)
        for key in want_outs:
            assert torch.equal(got_outs[key], want_outs[key]), key
            for i in range(lanes):
                assert torch.equal(got_outs[key][i], outs[key]), key
        for key in want_final:
            assert torch.equal(got_final[key], want_final[key]), key
            for i in range(lanes):
                assert torch.equal(got_final[key][i], final[key].reshape(got_final[key][i].shape)), key


@pytest.mark.parametrize("vmap", ["0", "1"], ids=["dedupe", "vmap"])
def test_fleet_runner_on_card_equals_solo(cuda, vmap, monkeypatch):
    kw = dict(max_pods_per_pass=1024, pod_bucket_min=128, device_segment_steps=8, exact=False, device=cuda)

    def stream():
        return churn_scenario(0, n_nodes=48, n_events=200, ops_per_step=20)

    solo = ScenarioRunner(device_replay=True, **kw).run(stream())
    monkeypatch.setenv("KSIM_FLEET_VMAP", vmap)
    before = segment_mod.replay_segment_fleet.launches
    fleet = ScenarioRunner(device_replay=True, fleet=3, **kw)
    fleet.run(stream())
    stats = fleet.fleet_driver.stats()
    assert stats["lanes_on_device"] == 1.0
    assert stats["cohort_mode"] == ("vmap" if vmap == "1" else "dedupe")
    launched = segment_mod.replay_segment_fleet.launches - before
    assert launched == (stats["group_dispatches"] if vmap == "1" else 0)
    for ln in fleet.fleet_lanes:
        assert _steps(ln.result) == _steps(solo), ln.idx


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("size", CLUSTER_SIZES, ids=[f"cs{c}" for c in CLUSTER_SIZES])
def test_replay_segment_kernel_at_forced_cluster_sizes(cuda, size, exact, monkeypatch):
    """Every segment of the 200-node churn through kernel D on a cluster of
    ``size`` blocks equals the plain version, and the run the CPU's."""
    monkeypatch.setattr(segment_mod, "CLUSTER_SIZE", size)
    res, segments = _replay(cuda, exact, monkeypatch)
    assert segment_mod.replay_segment.last["cluster"] == size
    stats = segment_mod.replay_segment.last["stats"].tolist()
    assert stats[1] > 0 and stats[0] >= 3 * stats[1]  # attempts, and their cluster barriers
    _assert_plain_equal(segments)
    cpu_res, _ = _replay("cpu", exact, monkeypatch)
    assert _steps(res) == _steps(cpu_res)


@pytest.mark.parametrize("size", CLUSTER_SIZES, ids=[f"cs{c}" for c in CLUSTER_SIZES])
def test_replay_segment_kernel_preemption_at_forced_cluster_sizes(cuda, size, monkeypatch):
    """The victim search on a cluster of ``size`` blocks: the fixtures land
    on the hand-derived nodes and victims, the strata churn (selection and
    full) equals the per-pass path, and D equals its plain version on
    every segment."""
    monkeypatch.setattr(segment_mod, "CLUSTER_SIZE", size)
    for case in PREEMPTION_CASES:
        nodes, victims, pre = case_objects(case)
        store = ClusterStore()
        for n in nodes:
            store.create("nodes", n)
        for v in victims:
            store.create("pods", v)
        segments = _capture(monkeypatch)
        runner = ScenarioRunner(store=store, preemption=True, device_replay=True, device_segment_steps=4,
                                exact=False, device=cuda)
        evicted = []
        runner.service.add_eviction_listener(lambda ns, nm: evicted.append(nm))
        runner.run(iter([Operation(step=1, op="create", kind="pods", obj=pre)]))
        got = store.get("pods", "preemptor").get("status", {}).get("nominatedNodeName")
        assert (got, evicted) == (case["expected_nominated"], case["expected_victims"]), case["name"]
        _assert_plain_equal(segments)
    for record in ("selection", "full"):

        def run(device_replay: bool, device: str):
            runner = ScenarioRunner(preemption=True, record=record, device_replay=device_replay,
                                    device_segment_steps=4, exact=False, device=device)
            evicted = []
            runner.service.add_eviction_listener(lambda ns, nm: evicted.append(nm))
            res = runner.run(priority_strata_stream())
            return _steps(res), store_view(runner), evicted

        segments = _capture(monkeypatch)
        got = run(True, cuda)
        assert any(bool((seg[6]["nom"] >= 0).any()) for seg in segments)
        assert segment_mod.replay_segment.last["cluster"] == size
        _assert_plain_equal(segments)
        assert got == run(False, "cpu")


@pytest.mark.parametrize("size", (0,) + CLUSTER_SIZES, ids=["auto"] + [f"cs{c}" for c in CLUSTER_SIZES])
def test_replay_segment_kernel_17_topology_keys(cuda, size, monkeypatch):
    """Inter-pod terms over 17 topology keys through kernel D: equal to the
    plain version on every segment, and the run equal to the per-pass
    path's."""
    monkeypatch.setattr(segment_mod, "CLUSTER_SIZE", size)
    segments = _capture(monkeypatch)
    runner = ScenarioRunner(device_replay=True, device_segment_steps=4, exact=False, device=cuda)
    res = runner.run(interpod_keys_stream())
    assert runner.replay_driver.fallback_steps == 0, runner.replay_driver.unsupported
    assert max(seg[2]["aux"]["interpod"]["node_dom"].shape[1] for seg in segments) == 17
    _assert_plain_equal(segments)
    base = ScenarioRunner(device_segment_steps=4, exact=False, device="cpu").run(interpod_keys_stream())
    assert _steps(res) == _steps(base)


def test_replay_segment_kernel_past_the_one_block_bound(cuda, monkeypatch):
    """A churn over 17,700 nodes: a padded node axis past what one block's
    shared memory holds (about 17,590 nodes) runs on a cluster and equals
    the plain version."""
    segments = _capture(monkeypatch)
    runner = ScenarioRunner(max_pods_per_pass=256, pod_bucket_min=128, device_replay=True, device_segment_steps=4,
                            exact=False, device=cuda)
    runner.run(list(churn_scenario(0, n_nodes=17_700, n_events=17_700 + 320, ops_per_step=40)))
    assert runner.replay_driver.device_steps >= 4, runner.replay_driver.unsupported
    n = segments[0][2]["node"]["allocatable"].shape[0]
    assert n > 17_590
    assert segment_mod.replay_segment.last["cluster"] in segment_mod.SOLO_SIZES
    _assert_plain_equal(segments)


def test_replay_segment_fleet_8_lanes_at_the_chosen_cluster(cuda, monkeypatch):
    """Eight lanes in one launch, at the cluster size the occupancy query
    picks for them: each lane equals the solo launch, two lanes the fleet's
    plain version; the size is ``choose_cluster``'s on the card's occupancy
    answers, and every lane is resident at once where any size allows it;
    the C launch's shared memory equals the host mirror."""
    _res, segments = _replay(cuda, False, monkeypatch)
    st, prog, const, ev, state0, final, outs = max(
        segments, key=lambda seg: int((seg[6]["idx"] < seg[2]["pods"]["requests"].shape[0]).sum()))
    stacked = {k: torch.stack([v] * 8) for k, v in state0.items()}
    got_final, got_outs = segment_mod.replay_segment_fleet(st, prog, const, ev, stacked)
    ran = segment_mod.replay_segment_fleet.last
    assert ran["cluster"] in segment_mod.LANE_SIZES
    for i in range(8):
        for key in outs:
            assert torch.equal(got_outs[key][i], outs[key]), (i, key)
        for key in final:
            assert torch.equal(got_final[key][i], final[key].reshape(got_final[key][i].shape)), (i, key)
    two = {k: v[:2].contiguous() for k, v in stacked.items()}
    got_final, got_outs = segment_mod.replay_segment_fleet(st, prog, const, ev, two)
    want_final, want_outs = segment_mod.replay_segment_fleet_plain(st, prog, const, ev, two)
    for key in want_outs:
        assert torch.equal(got_outs[key], want_outs[key]), key
    for key in want_final:
        assert torch.equal(got_final[key], want_final[key]), key
    # The C side's shared memory per block equals kernels/replay_segment.py's.
    lib = segment_mod._load()
    run = segment_mod._Launch(st, prog, const, ev, lanes=1)
    s = {k: v.clone() for k, v in state0.items()}
    s["pass_count"] = s["pass_count"].reshape(1)
    prm = run.lane_params(s, segment_mod._segment_outputs(st, prog, run.P, run.N, (), run.device))
    for size in segment_mod.LANE_SIZES:
        threads = chain.cluster_threads(prm.chain.N, size)
        assert lib.ksim_segment_smem(ctypes.byref(prm), size, threads) == segment_mod.segment_smem_bytes(prm, size)
    fits = {size: lib.ksim_segment_fits(ctypes.byref(prm), 1, 8, size, 0) for size in segment_mod.LANE_SIZES}
    assert ran["cluster"] == segment_mod.choose_cluster(8, fits.get, segment_mod.LANE_SIZES), fits
    if max(fits.values()) >= 8:
        assert fits[ran["cluster"]] >= 8, fits
