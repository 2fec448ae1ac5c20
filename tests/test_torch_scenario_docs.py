"""The port's copies of ``scenario/spec.py``, ``scenario/simulation.py``
and ``state/snapshot.py`` give the same results as ksim_tpu's on the same
documents and store.

- ``spec.py``: the KEP-140 operation documents (create / patch / delete /
  done), a trace-sourced scenario, the spec's fault section, the round
  trip through ``spec_from_operations`` and every refusal's message;
- ``simulation.py``: a KEP-184 SchedulerSimulation document, with an
  initial snapshot, replayed to the same status (the port's service on
  the CPU, exact mode, against ksim_tpu's in x64); the Failed phase;
- ``snapshot.py``: snap / export / load on the same store contents.

Every comparison is exact (JSON-equal)."""

from __future__ import annotations

import json

import pytest
import torch

from ksim_tpu.scenario import spec as jax_spec
from ksim_tpu.scenario.simulation import run_scheduler_simulation as jax_simulation
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu.state.snapshot import SnapshotService as JaxSnapshot
from ksim_tpu_torch.scenario import spec
from ksim_tpu_torch.scenario.simulation import run_scheduler_simulation
from ksim_tpu_torch.state.cluster import ClusterStore
from ksim_tpu_torch.state.snapshot import SnapshotService
from tests.helpers import make_node, make_pod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fields(ops) -> list[tuple]:
    return [(op.step, op.op, op.kind, op.obj, op.name, op.namespace) for op in ops]


def scenario_doc() -> dict:
    return {
        "kind": "Scenario",
        "metadata": {"name": "s1"},
        "spec": {"operations": [
            {"id": "node", "step": 0, "createOperation": {"object": {"kind": "Node", **make_node("n1", cpu="8")}}},
            {"id": "node2", "step": 0, "createOperation": {"object": {"kind": "Node", **make_node("n2", cpu="2")}}},
            {"id": "pod", "step": 1, "createOperation": {"object": {"kind": "Pod", **make_pod("p1", cpu="1")}}},
            {"id": "big", "step": 1, "createOperation": {"object": {"kind": "Pod", **make_pod("p2", cpu="6")}}},
            {"id": "label", "step": 2, "patchOperation": {
                "typeMeta": {"kind": "Node"}, "objectMeta": {"name": "n1"},
                "patch": '{"metadata": {"labels": {"zone": "a"}}}'}},
            {"id": "gone", "step": 2, "deleteOperation": {"typeMeta": {"kind": "Pod"},
                                                          "objectMeta": {"name": "p1", "namespace": "default"}}},
            {"id": "finish", "step": 3, "doneOperation": {}},
            {"id": "never", "step": 4, "deleteOperation": {"typeMeta": {"kind": "Node"},
                                                           "objectMeta": {"name": "n1"}}},
        ]},
    }


def _trace_doc(**trace) -> dict:
    return {"spec": {"source": {"trace": trace}}}


def test_operation_documents_equal_ksim_tpu():
    doc = scenario_doc()
    got = spec.operations_from_spec(doc)
    assert _fields(got) == _fields(jax_spec.operations_from_spec(doc))
    assert _fields(spec.load_scenario(json.dumps(doc))) == _fields(jax_spec.load_scenario(json.dumps(doc)))
    assert spec.spec_from_operations(got) == jax_spec.spec_from_operations(jax_spec.operations_from_spec(doc))
    target, patch = {"a": {"b": 1, "c": 2}, "d": [1, 2]}, {"a": {"b": None, "e": 3}, "d": [9]}
    assert spec.merge_patch(target, patch) == jax_spec.merge_patch(target, patch)


def test_trace_sourced_scenario_equals_ksim_tpu(monkeypatch):
    monkeypatch.setenv("KSIM_TRACES_DIR", "tests/fixtures/traces")
    for doc in (_trace_doc(name="borg_mini.jsonl", format="borg", nodes=8, opsPerStep=4),
                _trace_doc(path="tests/fixtures/traces/alibaba_batch_mini.csv", format="alibaba", nodes=4)):
        got = _fields(spec.operations_from_spec(doc))
        assert got and got == _fields(jax_spec.operations_from_spec(doc))


@pytest.mark.parametrize("doc", [
    {"spec": {"operations": [{"id": "x", "step": 0}]}},
    {"spec": {"operations": [{"step": 0, "createOperation": {"object": {"kind": "Gadget", "metadata": {"name": "g"}}}}]}},
    {},
    _trace_doc(name="x.jsonl", format="nope"),
    _trace_doc(format="borg"),
    {"spec": {"source": {"bogus": {}}}},
    _trace_doc(name="x.jsonl", format="borg", nodes="many"),
], ids=["no_op", "unknown_kind", "empty", "bad_format", "no_name", "bad_source", "bad_int"])
def test_refusals_equal_ksim_tpu(doc):
    with pytest.raises(spec.ScenarioSpecError) as got:
        spec.operations_from_spec(doc)
    with pytest.raises(jax_spec.ScenarioSpecError) as want:
        jax_spec.operations_from_spec(doc)
    assert str(got.value) == str(want.value)


def test_fault_sections_equal_ksim_tpu():
    doc = {"spec": {"faults": {"replay.dispatch": "call:2@device", "jobs.run": "first:1"}}}
    assert spec.faults_spec_from_doc(doc) == jax_spec.faults_spec_from_doc(doc)
    assert spec.faults_spec_from_doc({"spec": {}}) == ""
    bad = {"spec": {"faults": {"replay.dispatch": "always;service.schedule=always"}}}
    with pytest.raises(spec.ScenarioSpecError) as got:
        spec.faults_spec_from_doc(bad)
    with pytest.raises(jax_spec.ScenarioSpecError) as want:
        jax_spec.faults_spec_from_doc(bad)
    assert str(got.value) == str(want.value)


def _fill(store) -> None:
    store.create("nodes", make_node("n0", cpu="4"))
    store.create("pods", make_pod("web", labels={"app": "web"}))
    store.create("pods", make_pod("db", labels={"app": "db"}))
    store.create("namespaces", {"metadata": {"name": "default"}})
    store.create("namespaces", {"metadata": {"name": "kube-system"}})
    store.create("priorityclasses", {"metadata": {"name": "high"}, "value": 100})
    store.create("priorityclasses", {"metadata": {"name": "system-cluster-critical"}, "value": 2000000000})


def _strip(objs: list) -> list:
    out = []
    for o in objs:
        o = json.loads(json.dumps(o))
        md = o.get("metadata", {})
        for key in ("uid", "resourceVersion", "creationTimestamp"):
            md.pop(key, None)
        out.append(o)
    return sorted(out, key=lambda o: json.dumps(o, sort_keys=True))


def test_snapshot_service_equals_ksim_tpu():
    port_store, jax_store = ClusterStore(), JaxStore()
    _fill(port_store)
    _fill(jax_store)
    port, ref = SnapshotService(port_store), JaxSnapshot(jax_store)
    for sel in (None, {"matchLabels": {"app": "web"}}):
        got, want = port.snap(sel), ref.snap(sel)
        assert set(got) == set(want)
        for key in got:
            assert (_strip(got[key]) if isinstance(got[key], list) else got[key]) == (
                _strip(want[key]) if isinstance(want[key], list) else want[key]), key
    exported = ref.export_json()
    dst, jdst = ClusterStore(), JaxStore()
    SnapshotService(dst).import_json(exported)
    JaxSnapshot(jdst).import_json(exported)
    for kind in ("nodes", "pods", "namespaces", "priorityclasses"):
        assert _strip(dst.list(kind)) == _strip(jdst.list(kind)), kind


def _status(out: dict) -> dict:
    status = json.loads(json.dumps(out["status"]))
    status.get("result", {}).pop("wallSeconds", None)
    return status


def test_scheduler_simulation_equals_ksim_tpu(tmp_path):
    """A KEP-184 document with an initial snapshot and an inline scenario:
    the same status, step for step, and the same result file."""
    snap_store = JaxStore()
    snap_store.create("nodes", make_node("base", cpu="2"))
    snap_store.create("pods", make_pod("seed", cpu="1"))
    snap_path = tmp_path / "snap.json"
    snap_path.write_text(JaxSnapshot(snap_store).export_json())
    results = {}
    for name, fn, kw in (("port", run_scheduler_simulation, {"device": "cpu", "exact": True}),
                         ("ref", jax_simulation, {})):
        doc = {
            "kind": "SchedulerSimulation",
            "spec": {
                "simulator": {"initialSnapshotPath": str(snap_path), "recordMode": "full"},
                "scenario": scenario_doc(),
                "scenarioResultFilePath": str(tmp_path / f"{name}.json"),
            },
        }
        out = fn(doc, **kw)
        results[name] = (_status(out), _status(json.loads((tmp_path / f"{name}.json").read_text())))
    assert results["port"][0]["phase"] == "Succeeded"
    assert results["port"][0]["result"]["podsScheduled"] >= 1
    assert results["port"] == results["ref"]


def test_scheduler_simulation_failure_equals_ksim_tpu():
    doc = {"spec": {"scenario": {"spec": {"operations": [
        {"step": 0, "deleteOperation": {"typeMeta": {"kind": "Node"}, "objectMeta": {"name": "missing"}}},
    ]}}}}
    got = run_scheduler_simulation(doc, device="cpu")
    assert got["status"]["phase"] == "Failed"
    assert got["status"] == jax_simulation(doc)["status"]
