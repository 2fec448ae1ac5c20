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
- ``obs.py``: the same spans, events and environment give the same
  histograms, counters and ring; histogram merging, the fleet documents'
  merge, the Chrome-trace merge and the Prometheus text give the same on
  the same documents;
- ``config.py``: the same config.yaml and environment give the same
  SimulatorConfig, and the same refusals;
- the job plane's parts of ``obs.py`` (scoped planes with tags and a
  sink, the published snapshots and their readers) give the same
  records and documents; ``jobs/queue.py``'s pop order and bypass bound,
  and ``jobs/journal.py``'s line format and compaction fold, give the
  same on the same inputs."""

from __future__ import annotations

import copy
import dataclasses
import json
import random

import pytest
import torch
import yaml

from ksim_tpu import config as jax_config
from ksim_tpu import obs as jax_obs
from ksim_tpu.jobs import journal as jax_journal
from ksim_tpu.jobs.queue import JobQueue as JaxJobQueue
from ksim_tpu.plugins import oracle as jax_oracle
from ksim_tpu.scenario import churn_scenario as jax_churn
from ksim_tpu.scheduler import preemption as jax_preemption
from ksim_tpu.state import priorities as jax_priorities
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu_torch import config, obs
from ksim_tpu_torch.jobs import journal
from ksim_tpu_torch.jobs.queue import JobQueue
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


def _sans_producer(doc: dict) -> dict:
    doc = json.loads(json.dumps(doc))
    doc["otherData"].pop("producer")
    return doc


def test_fleet_documents_and_prometheus_equal_original():
    from tests.test_obs_fleet import _solo_doc, _worker_doc

    rng = random.Random(1234)
    parts = []
    for k in range(4):
        h = jax_obs.LatencyHistogram()
        for _ in range(10 * k):
            h.observe(10 ** rng.uniform(-7.5, 2.5))
        parts.append(h.snapshot())
    assert obs.merge_latency_snapshots(parts) == jax_obs.merge_latency_snapshots(parts)
    assert obs.LatencyHistogram.from_snapshot(parts[3]).snapshot() == parts[3]
    foreign = dict(parts[3], buckets=[[0.123456, 1]])
    for mod in (obs, jax_obs):
        with pytest.raises(ValueError, match="fixed histogram edges"):
            mod.LatencyHistogram().merge_snapshot(foreign)
    now = 1_000_000.0
    docs = {"wa": _worker_doc("wa", published_at=now, claims=2),
            "wb": _worker_doc("wb", published_at=now - 300, claims=3)}
    merged = obs.merge_fleet_docs(copy.deepcopy(docs), now=now)
    assert merged == jax_obs.merge_fleet_docs(copy.deepcopy(docs), now=now)
    for doc in (merged, _solo_doc()):
        text = obs.render_prometheus(doc)
        assert text == jax_obs.render_prometheus(doc)
        assert obs.parse_prometheus(text) == jax_obs.parse_prometheus(text)
    for bad in ("ksim_up 1\n", "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\n"):
        for mod in (obs, jax_obs):
            with pytest.raises(ValueError):
                mod.parse_prometheus(bad)
    ident, ref_ident = obs.process_identity(role="worker"), jax_obs.process_identity(role="worker")
    assert ident.keys() == ref_ident.keys()
    assert (ident["role"], ident["worker_id"], ident["pid"]) == (ref_ident["role"], ref_ident["worker_id"],
                                                                 ref_ident["pid"])
    assert obs.METRIC_NAMES == jax_obs.METRIC_NAMES
    assert [f["name"] for f in obs._EXPO_FAMILIES] == list(obs.METRIC_NAMES)


def test_chrome_trace_merge_equals_original():
    def trace(pid, epoch, events):
        return {"traceEvents": [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                                 "args": {"name": f"seed{pid}"}}, *events],
                "displayTimeUnit": "ms", "otherData": {"epoch_unix_s": epoch}}

    def ev(name, pid, ts, job):
        return {"name": name, "ph": "X", "pid": pid, "tid": 1, "ts": ts, "dur": 1.0, "args": {"job": job}}

    traces = {"fd": trace(1, 100.0, [ev("jobs.enqueue", 1, 5.0, "j1"), ev("jobs.enqueue", 1, 7.0, "j2")]),
              "w1": trace(2, 102.0, [ev("jobs.fleet_claim", 2, 10.0, "j1"), ev("jobs.run", 2, 30.0, "j1")]),
              "w2": {"traceEvents": [ev("service.schedule", 3, 1.0, "j3")], "otherData": {"pid": 3}}}
    for flows in (False, True):
        got = obs.merge_chrome_traces(copy.deepcopy(traces), flows=flows)
        want = jax_obs.merge_chrome_traces(copy.deepcopy(traces), flows=flows)
        assert _sans_producer(got) == _sans_producer(want)
        assert got["otherData"]["producer"] == "ksim_tpu_torch.obs"


CONFIG_CASES = {
    "defaults": ({}, {}),
    "yaml": ({"port": 1313, "host": "0.0.0.0", "corsAllowedOriginList": ["http://a", "http://b"],
              "kubeSchedulerConfigPath": "{dir}/sched.yaml", "externalImportEnabled": True,
              "externalSnapshotPath": "{dir}/snap.json", "resourceImportLabelSelector": {"matchLabels": {"a": "b"}},
              "etcdURL": "ignored"}, {}),
    "env over yaml": ({"port": 1313, "resourceSyncEnabled": True, "kubeConfig": "{dir}/kube.yaml"},
                      {"PORT": "2424", "KSIM_HOST": "10.1.2.3", "CORS_ALLOWED_ORIGIN_LIST": "http://x,http://y",
                       "RESOURCE_SYNC_ENABLED": "false", "EXTERNAL_IMPORT_ENABLED": "yes",
                       "KUBE_SCHEDULER_CONFIG_PATH": "{dir}/sched.yaml"}),
    "ambient kubeconfig": ({"resourceSyncEnabled": True}, {"KUBECONFIG": "{dir}/missing:{dir}/kube.yaml"}),
    "bad port": ({}, {"PORT": "eighty"}),
    "both sources": ({"externalImportEnabled": True, "externalSnapshotPath": "{dir}/snap.json",
                      "kubeConfig": "{dir}/kube.yaml"}, {}),
    "no source": ({"resourceSyncEnabled": True}, {}),
    "import and sync": ({"externalImportEnabled": True, "resourceSyncEnabled": True,
                         "externalSnapshotPath": "{dir}/snap.json"}, {}),
}
CONFIG_ENV = ("PORT", "KSIM_HOST", "CORS_ALLOWED_ORIGIN_LIST", "KUBE_SCHEDULER_CONFIG_PATH", "EXTERNAL_IMPORT_ENABLED",
              "RESOURCE_SYNC_ENABLED", "EXTERNAL_SNAPSHOT_PATH", "KUBE_CONFIG", "KUBECONFIG")


@pytest.mark.parametrize("case", CONFIG_CASES, ids=list(CONFIG_CASES))
def test_load_config_equals_original(case, tmp_path, monkeypatch):
    raw, env = (json.loads(json.dumps(x).replace("{dir}", str(tmp_path))) for x in CONFIG_CASES[case])
    (tmp_path / "sched.yaml").write_text(yaml.safe_dump({"profiles": [{"schedulerName": "from-yaml"}]}))
    (tmp_path / "kube.yaml").write_text("{}")
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(raw))
    for name in CONFIG_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    out = []
    for mod in (config, jax_config):
        try:
            out.append(dataclasses.asdict(mod.load_config(str(tmp_path / "config.yaml"))))
        except Exception as e:  # the refusals must match too
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]
    for mod in (config, jax_config):
        with pytest.raises(Exception, match="not found") as err:
            mod.load_config(str(tmp_path / "absent.yaml"))
        assert type(err.value).__name__ == "InvalidConfigError"


def _scoped_script(mod) -> dict:
    """Drive ``mod``'s global plane inside a job's scoped private plane
    (tags and a sink, as jobs/manager.py installs them), with a scope
    carried onto a second thread as the replay executor does; return
    what the private plane, the sink and the global plane saw."""
    root = mod.TracePlane()
    job = mod.TracePlane(tags={"job": "job-000007"})
    job.configure_from_env({"KSIM_TRACE": "1", "KSIM_TRACE_RING": "64"})
    sunk = []
    job.set_sink(lambda rec: sunk.append((rec["ph"], rec["name"], rec["args"])))
    import threading

    with root.scoped(job):
        root.ensure_timing()
        with root.span("runner.step", step=0):
            root.event("service.pass", attempts=2)
        scope, tags = root.scope(), root.scope_tags()

        def worker():
            with root.scoped(scope):
                with root.span("replay.dispatch", segment=1):
                    root.event("fault.fired", site="replay.dispatch")

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        totals = {name: count for name, (_total, count) in root.phase_totals().items()}
    root.event("jobs.enqueue", job="job-000008")  # outside the scope: the root's
    return {
        "scope_after": root.scope(),
        "tags": tags,
        "root_tags": root.scope_tags(),
        "sunk": sunk,
        "ring": [(r["ph"], r["name"], r.get("depth"), r["args"]) for r in job.ring_records()],
        "phase_counts": totals,
        "root_events": root.snapshot()["events"],
        "job_events": job.snapshot()["events"],
    }


def test_scoped_planes_and_publishing_equal_original(tmp_path):
    assert _scoped_script(obs) == _scoped_script(jax_obs)
    assert obs.OBS_DIR == jax_obs.OBS_DIR
    seqs = [obs.next_publish_seq() for _ in range(3)]
    assert seqs == sorted(seqs) and len(set(seqs)) == 3
    for mod, name in ((obs, "port"), (jax_obs, "jax")):
        d = tmp_path / name
        mod.publish_snapshot(str(d), {"process": {"worker_id": "w1"}, "counters": {"a": 1}}, worker_id="w1",
                             trace_doc={"traceEvents": []})
        mod.publish_snapshot(str(d), {"process": {"worker_id": "w2"}}, worker_id="w2")
        (d / "obs" / "torn.json").write_text('{"half": ')
    for d in ("port", "jax"):
        for reader in ("read_fleet_snapshots", "read_fleet_traces"):
            got = getattr(obs, reader)(str(tmp_path / d))
            assert got == getattr(jax_obs, reader)(str(tmp_path / d))
            assert got == getattr(obs, reader)(str(tmp_path / ("jax" if d == "port" else "port")))
    assert sorted(obs.read_fleet_snapshots(str(tmp_path / "port"))) == ["w1", "w2"]
    assert obs.read_fleet_snapshots(str(tmp_path / "nowhere")) == {}


QUEUE_SCRIPTS = {
    # (priority, cost) per put, pops interleaved where a put is None.
    "priority_then_fifo": [(0, 0), (5, 0), (0, 0), (5, 0), (1, 0)],
    "sjf_within_band": [(0, 50), (0, 10), (0, 30), (1, 90), (0, 10)],
    "starvation_bound": [(0, 1000)] + [(0, 1)] * 3 + [None] * 3 + [(0, 1)] * 6 + [None] * 4,
}


@pytest.mark.parametrize("script", sorted(QUEUE_SCRIPTS))
@pytest.mark.parametrize("max_bypass", [1, 2, None])
def test_job_queue_equals_original(script, max_bypass):
    """The same puts and pops give the same pop order, the same refusal
    at the limit and the same counters (``bypass_pops`` included)."""
    outs = []
    for cls in (JobQueue, JaxJobQueue):
        q = cls(8, max_bypass=max_bypass)
        order, n = [], 0
        for step in QUEUE_SCRIPTS[script]:
            if step is None:
                order.append(q.get(timeout=0))
                continue
            try:
                q.put(n, priority=step[0], cost=step[1])
            except Exception as e:
                order.append(type(e).__name__)
            n += 1
        while (item := q.get(timeout=0)) is not None:
            order.append(item)
        q.close()
        outs.append((order, q.stats(), q.get(timeout=0)))
    assert outs[0] == outs[1]


def test_journal_line_and_fold_equal_original():
    """``_line`` writes the same bytes, ``_decode_line`` accepts and
    refuses the same lines, and ``_fold_compact`` folds the same record
    stream (live and terminal jobs, checkpoints, cancels, foreign
    records) to the same compact stream."""
    recs = [
        {"t": "submit", "id": "a", "ordinal": 0, "priority": 0, "doc": {"x": [1, 2]}, "created": 1.0},
        {"t": "submit", "id": "b", "ordinal": 1, "priority": 3, "doc": {}, "created": 2.0},
        {"t": "state", "id": "a", "state": "running", "ts": 3.0},
        {"t": "checkpoint", "id": "a", "seq": 1, "cursor": 16, "segment": 1, "store": {}, "ts": 4.0},
        {"t": "cancel", "id": "b", "ts": 4.5},
        {"t": "checkpoint", "id": "a", "seq": 2, "cursor": 32, "segment": 2, "store": {}, "ts": 5.0},
        {"t": "state", "id": "b", "state": "cancelled", "ts": 6.0},
        {"t": "lease", "id": "a", "worker": "w1"},
        {"t": "state", "id": "ghost", "state": "running"},
        {"t": "submit", "id": "c", "ordinal": 2, "priority": 0, "doc": {}},
        {"t": "result", "id": "c", "result": {"podsScheduled": 3}},
        {"t": "state", "id": "c", "state": "succeeded", "ts": 7.0},
    ]
    lines = [journal._line(r) for r in recs]
    assert lines == [jax_journal._line(r) for r in recs]
    bad = [lines[0][:-1], lines[1].replace('"ordinal":1', '"ordinal":9'), "not json\n", '{"crc": 1}\n']
    for line in lines + bad:
        assert journal._decode_line(line) == jax_journal._decode_line(line)
    assert [journal._decode_line(line) for line in lines] == recs
    assert all(journal._decode_line(line) is None for line in bad)
    for prefix in range(len(recs) + 1):
        assert journal._fold_compact(copy.deepcopy(recs[:prefix])) == jax_journal._fold_compact(
            copy.deepcopy(recs[:prefix]))
