"""The port's SchedulerService against ksim_tpu's, on the CPU.

The same cluster objects go into one ClusterStore of each package; both
services run the same passes (record="full", so every pod carries the 13
result annotations and the result history) and must agree on every
placement, every pod's annotations, node, phase and nomination, the
evicted victims and the backoff table.  Scenarios: those of
tests/test_scheduler_service.py, a spread/affinity-heavy random cluster,
and the hand-derived DefaultPreemption cases of
tests/fixtures/preemption_victims.py.  ksim_tpu runs with x64 on (the
suite's default), the port in exact mode."""

from __future__ import annotations

import copy

import pytest
import torch

from ksim_tpu.scheduler import SchedulerService as JaxService
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import ClusterStore
from tests.fixtures.preemption_victims import CASES
from tests.helpers import make_node, make_pod, random_cluster
from tests.test_preemption_fixtures import case_objects


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensor ops: one intra-op thread does
    them as fast as many, and keeps the suite's parallel workers from
    oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stores(nodes, pods):
    out = []
    for cls in (JaxStore, ClusterStore):
        store = cls()
        for n in nodes:
            store.create("nodes", copy.deepcopy(n))
        for p in pods:
            store.create("pods", copy.deepcopy(p))
        out.append(store)
    return out


def _pod_view(store) -> dict:
    return {
        f"{p['metadata'].get('namespace')}/{p['metadata']['name']}": (
            p["spec"].get("nodeName"),
            p.get("status", {}).get("phase"),
            p.get("status", {}).get("nominatedNodeName"),
            dict(p["metadata"].get("annotations") or {}),
        )
        for p in store.list("pods")
    }


def _assert_same(jstore, jsvc, tstore, tsvc) -> None:
    assert _pod_view(tstore) == _pod_view(jstore)
    assert tsvc._backoff == jsvc._backoff
    assert tsvc._pass_count == jsvc._pass_count


def _passes(nodes, pods, svc_kw: dict, actions=("schedule",)):
    """Run ``actions`` on both services; each "schedule" compares the
    placements, and the stores are compared at the end."""
    jstore, tstore = _stores(nodes, pods)
    jsvc = JaxService(jstore, **svc_kw)
    tsvc = SchedulerService(tstore, **svc_kw, device="cpu")
    for act in actions:
        if act == "schedule":
            assert tsvc.schedule_pending() == jsvc.schedule_pending()
        elif act == "flush":
            jsvc.flush_backoff()
            tsvc.flush_backoff()
        else:  # ("node", obj): a node arrives
            jstore.create("nodes", copy.deepcopy(act[1]))
            tstore.create("nodes", copy.deepcopy(act[1]))
    _assert_same(jstore, jsvc, tstore, tsvc)
    return tstore


def _named(name, cpu, **kw):
    p = make_pod(name, cpu=cpu, **kw)
    p["metadata"]["creationTimestamp"] = "2024-01-01T00:00:00Z"
    return p


SCENARIOS = {
    "binds_and_annotates": lambda: _passes(
        [make_node("n1"), make_node("n2")], [_named("p1", "100m"), _named("p2", "100m")], {}
    ),
    "priority_contended": lambda: _passes(
        [make_node("n1", cpu="1", memory="1Gi")],
        [_named("low", "800m", priority=1), _named("high", "800m", priority=100)],
        {},
    ),
    "retry_history": lambda: _passes(
        [make_node("tiny", cpu="100m")], [_named("big", "2")], {"preemption": False},
        ("schedule", "flush", "schedule"),
    ),
    "backoff_then_flush": lambda: _passes(
        [make_node("n0", cpu="1", memory="8Gi")], [_named("big", "2", memory=None)],
        {"preemption": False},
        ("schedule", "schedule", ("node", make_node("n1", cpu="4", memory="8Gi")), "flush", "schedule"),
    ),
    "multiple_profiles": lambda: _passes(
        [make_node("n0", cpu="2", memory="8Gi")],
        [
            _named("a", "1", memory=None),
            dict(_named("b", "1", memory=None), spec=dict(_named("b", "1", memory=None)["spec"], schedulerName="second")),
        ],
        {"config": {"profiles": [{"schedulerName": "default-scheduler"}, {"schedulerName": "second"}]}},
    ),
    "random_spread_affinity": lambda: _passes(*random_cluster(3, 24, 48), {}, ("schedule", "flush", "schedule")),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_service_matches_reference(name):
    SCENARIOS[name]()


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_preemption_fixture_matches_reference(case):
    """Per-pass DefaultPreemption: the same nomination, the same victims
    evicted, the same postfilter annotations."""
    nodes, victims, pre = case_objects(case)
    tstore = _passes(nodes, victims + [pre], {"preemption": True})
    pod = tstore.get("pods", "preemptor", "default")
    assert pod.get("status", {}).get("nominatedNodeName") == case["expected_nominated"]
    left = {p["metadata"]["name"] for p in tstore.list("pods")}
    assert not left & set(case["expected_victims"])
