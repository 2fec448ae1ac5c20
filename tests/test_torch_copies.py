"""The port's copies of jax-free ksim_tpu modules stay equal to their
originals: the same inputs give equal outputs.

- ``plugins/oracle.py`` (the host plugin oracle behind DefaultPreemption's
  fit checks): every per-node filter and score, and the cluster-wide
  spread and inter-pod functions, on random clusters;
- ``scheduler/preemption.py``: ``find_preemption`` on the hand-derived
  fixture cases and on random clusters with priorities;
- ``state/cluster.py``: one sequence of store operations (create, patch,
  rewrap, delete, transactions committed and rolled back, watches, the
  nodeName partitions) gives the same objects, events and epochs;
- ``state/priorities.py`` and ``scenario/generate.py``: equal outputs;
- ``obs.py`` (the part the port keeps): the same spans, events and
  environment give the same histograms, counters and ring."""

from __future__ import annotations

import copy

import pytest
import torch

from ksim_tpu import obs as jax_obs
from ksim_tpu.plugins import oracle as jax_oracle
from ksim_tpu.scenario import churn_scenario as jax_churn
from ksim_tpu.scheduler import preemption as jax_preemption
from ksim_tpu.state import priorities as jax_priorities
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu_torch import obs
from ksim_tpu_torch.plugins import oracle
from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scheduler import preemption
from ksim_tpu_torch.state import priorities
from ksim_tpu_torch.state.cluster import ClusterStore
from tests.fixtures.preemption_victims import CASES
from tests.helpers import make_node, make_pod, random_cluster
from tests.test_preemption_fixtures import case_objects

CLUSTERS = [(0, 12, 30), (5, 20, 40)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensor ops: one intra-op thread does
    them as fast as many, and keeps the suite's parallel workers from
    oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _split(nodes, pods):
    bound = [p for p in pods if p.get("spec", {}).get("nodeName")]
    pending = [p for p in pods if not p.get("spec", {}).get("nodeName")]
    return bound, pending


@pytest.mark.parametrize("seed, n_nodes, n_pods", CLUSTERS)
def test_oracle_equals_original(seed, n_nodes, n_pods):
    nodes, pods = random_cluster(seed, n_nodes, n_pods, bound_fraction=0.4)
    bound, pending = _split(nodes, pods)
    infos = {m: m.build_node_infos(nodes, bound) for m in (jax_oracle, oracle)}
    by_node = {}
    for p in bound:
        by_node.setdefault(p["spec"]["nodeName"], []).append(p)
    res = [("cpu", 1), ("memory", 1)]
    per_node = (
        ("node_unschedulable_filter", ()), ("taint_toleration_filter", ()),
        ("taint_toleration_score", ()), ("node_affinity_filter", (None,)),
        ("node_affinity_score", (None,)), ("fit_filter", ()), ("node_name_filter", ()),
        ("least_allocated_score", (res,)), ("most_allocated_score", (res,)),
        ("balanced_allocation_score", (["cpu", "memory"],)),
    )
    checked = 0
    for pod in pending:
        for name, extra in per_node:
            ref = [getattr(jax_oracle, name)(pod, i, *extra) for i in infos[jax_oracle]]
            got = [getattr(oracle, name)(pod, i, *extra) for i in infos[oracle]]
            assert got == ref, name
            checked += len(got)
        feasible = [True] * len(nodes)
        for name, args in (
            ("topology_spread_filter_all", (by_node,)),
            ("topology_spread_score_all", (by_node, feasible)),
            ("inter_pod_affinity_filter_all", (by_node, [])),
            ("inter_pod_affinity_score_all", (by_node, feasible, [], 1)),
        ):
            ref = getattr(jax_oracle, name)(pod, infos[jax_oracle], *args)
            got = getattr(oracle, name)(pod, infos[oracle], *args)
            assert got == ref, name
    assert checked > 0


def _decision(d):
    return d.nominated_node, [v["metadata"]["name"] for v in d.victims]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_find_preemption_equals_original_on_fixtures(case):
    nodes, victims, pre = case_objects(case)
    ref = jax_preemption.find_preemption(pre, nodes, victims)
    got = preemption.find_preemption(copy.deepcopy(pre), copy.deepcopy(nodes), copy.deepcopy(victims))
    assert _decision(got) == _decision(ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_preemption_equals_original_on_random_clusters(seed):
    nodes, pods = random_cluster(seed, 10, 40, bound_fraction=0.7)
    for i, p in enumerate(pods):
        p["spec"]["priority"] = i % 4
    bound, pending = _split(nodes, pods)
    decided = 0
    for pod in pending:
        pod = dict(pod, spec=dict(pod["spec"], priority=10))
        ref = jax_preemption.find_preemption(pod, nodes, bound)
        got = preemption.find_preemption(pod, nodes, bound)
        assert _decision(got) == _decision(ref)
        decided += ref.nominated_node is not None
    assert decided > 0
    assert preemption.candidate_count(2000) == jax_preemption.candidate_count(2000)


def _store_script(store, events: list) -> list:
    """One sequence of store operations; returns what a caller observes."""
    watch = store.watch(("pods", "nodes"))
    seen = []
    store.create("nodes", make_node("n1"))
    store.create("nodes", make_node("n2"))
    for i in range(4):
        store.create("pods", make_pod(f"p{i}"))
    seen.append(store.mutation_epoch)

    def bind(obj):
        obj["spec"]["nodeName"] = "n1"

    store.patch("pods", "p0", "default", bind)
    store.rewrap("pods", "p1", "default", lambda o: dict(o, spec=dict(o["spec"], nodeName="n2")))
    with store.transaction(epoch_exempt=True):
        store.patch("pods", "p2", "default", bind)
        store.delete("pods", "p3", "default")
    seen.append(store.mutation_epoch)
    try:
        with store.transaction():
            store.delete("pods", "p0", "default")
            raise RuntimeError("roll back")
    except RuntimeError:
        pass
    seen.append(sorted(p["metadata"]["name"] for p in store.pods_with_node()))
    seen.append(sorted(p["metadata"]["name"] for p in store.pods_without_node()))
    seen.append(sorted(p["metadata"]["name"] for p in store.pods_on_nodes({"n1"})))
    seen.append(store.contains("pods", "p3", "default"))
    store.delete("nodes", "n2")
    for p in store.list("pods"):
        md = p["metadata"]
        seen.append((md["name"], md["resourceVersion"], p["spec"].get("nodeName")))
    while True:
        ev = watch.next(timeout=0.01)
        if ev is None:
            break
        events.append((ev.event_type, ev.kind, ev.obj["metadata"]["name"]))
    watch.close()
    return seen


def test_cluster_store_equals_original():
    ref_events, got_events = [], []
    ref = _store_script(JaxStore(), ref_events)
    got = _store_script(ClusterStore(), got_events)
    assert got == ref
    assert got_events == ref_events and len(got_events) > 8


def test_priorities_and_generator_equal_originals():
    classes = [
        {"metadata": {"name": "high"}, "value": 1000},
        {"metadata": {"name": "dflt"}, "value": 7, "globalDefault": True},
    ]
    pods = [make_pod("a", priority=3), make_pod("b"), make_pod("c")]
    pods[2]["spec"]["priorityClassName"] = "high"
    ref = jax_priorities.build_priority_resolver(classes)
    got = priorities.build_priority_resolver(classes)
    assert [got(p) for p in pods] == [ref(p) for p in pods]
    ref_ops = list(jax_churn(7, n_nodes=30, n_events=400, ops_per_step=25))
    got_ops = list(churn_scenario(7, n_nodes=30, n_events=400, ops_per_step=25))
    assert [(o.step, o.op, o.kind, o.obj, o.name, o.namespace) for o in got_ops] == [
        (o.step, o.op, o.kind, o.obj, o.name, o.namespace) for o in ref_ops
    ]


def _trace_script(mod, environ: dict) -> dict:
    """Drive a fresh plane of ``mod`` (an obs module) through the spans
    and events the port records; return what a reader sees."""
    plane = mod.TracePlane()
    plane.configure_from_env(environ)
    plane.ensure_timing()
    for step in range(3):
        with plane.span("runner.step", step=step):
            plane.event("service.pass", attempts=step)
            with plane.span("service.schedule", pass_num=step) as sp:
                sp.set(scheduled=step)
    try:
        with plane.span("replay.dispatch", segment=0):
            raise RuntimeError("device")
    except RuntimeError:
        pass
    plane.event("replay.fallback", reason="record_full", segment=1)
    snap = plane.snapshot()
    hist = {name: h["count"] for name, h in snap["histograms"].items()}
    ring = [(r["ph"], r["name"], r.get("depth"), r["args"]) for r in plane.ring_records()]
    doc = plane.export_chrome()
    return {
        "active": plane.active,
        "ring_capacity": snap["ring"]["capacity"],
        "histograms": hist,
        "events": snap["events"],
        "phase_counts": {name: count for name, (_total, count) in plane.phase_totals().items()},
        "ring": ring,
        "chrome": sorted((e["ph"], e["name"]) for e in doc["traceEvents"] if e["ph"] != "M"),
    }


@pytest.mark.parametrize("environ", [
    {"KSIM_TRACE": "1"},
    {"KSIM_TRACE": "timing", "KSIM_TRACE_RING": "32"},
    {"KSIM_TRACE": "off", "KSIM_TRACE_OUT": "unused.json"},
], ids=["ring", "timing", "off"])
def test_trace_plane_equals_original(environ):
    assert set(obs.SPAN_NAMES) <= set(jax_obs.SPAN_NAMES)
    assert set(obs.EVENT_NAMES) <= set(jax_obs.EVENT_NAMES)
    assert _trace_script(obs, environ) == _trace_script(jax_obs, environ)
    samples = [1e-7, 3e-6, 0.004, 0.25, 7.0, 500.0]
    ref, got = jax_obs.LatencyHistogram(), obs.LatencyHistogram()
    for x in samples:
        ref.observe(x)
        got.observe(x)
    assert got.snapshot() == ref.snapshot()
