"""Webhook scheduler extenders and the lifecycle samples on the port, on
the CPU, against ksim_tpu.

The extender cases of tests/test_extender.py run through a fake extender
on 127.0.0.1 (no network): filter and prioritize (each pod evaluated by
``evaluate_batch``, kernel B on a card), the extender service the proxy
routes call, an ignorable failure, preemption, the flush by the watch
loop.  Placements and the four extender annotations equal ksim_tpu's
service on the same store.  The lifecycle samples (FifoSort,
NamePrefixGate, PlacementExport) load through ``builderImport`` from the
port's own modules; a ``ksim_tpu.`` import path is refused."""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from ksim_tpu.scheduler.service import SchedulerService as JaxService
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu_torch.errors import InvalidConfigError
from ksim_tpu_torch.scheduler.extender import (
    EXTENDER_BIND_RESULT_KEY,
    EXTENDER_FILTER_RESULT_KEY,
    EXTENDER_PREEMPT_RESULT_KEY,
    EXTENDER_PRIORITIZE_RESULT_KEY,
    override_extenders_cfg_to_simulator,
)
from ksim_tpu_torch.scheduler.profile import load_plugin_import
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import ClusterStore
from tests.helpers import make_node, make_pod

EXTENDER_KEYS = (
    EXTENDER_FILTER_RESULT_KEY, EXTENDER_PRIORITIZE_RESULT_KEY, EXTENDER_PREEMPT_RESULT_KEY,
    EXTENDER_BIND_RESULT_KEY,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _FakeExtender(BaseHTTPRequestHandler):
    """tests/test_extender.py's webhook: filters out nodes named *-banned,
    prefers *-favored (score 10, else 1)."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        names = body.get("nodenames") or [n["metadata"]["name"] for n in (body.get("nodes") or {}).get("items", [])]
        if self.path.endswith("/filter"):
            out = {"nodenames": [n for n in names if not n.endswith("-banned")],
                   "failedNodes": {n: "banned by extender" for n in names if n.endswith("-banned")}}
        elif self.path.endswith("/prioritize"):
            out = [{"host": n, "score": 10 if n.endswith("-favored") else 1} for n in names]
        else:
            out = {}
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture()
def fake_extender():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _FakeExtender)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _config(url, **extra):
    return {"extenders": [{"urlPrefix": url, "filterVerb": "filter", "prioritizeVerb": "prioritize", "weight": 1,
                           "nodeCacheCapable": True, **extra}]}


def _both(objs, config, **kw):
    """The port's service and ksim_tpu's, each on its own store holding
    ``objs``; returns [(store, service), ...] port first."""
    out = []
    for store_cls, service_cls, extra in ((ClusterStore, SchedulerService, {"device": "cpu"}),
                                          (JaxStore, JaxService, {})):
        store = store_cls()
        for kind, obj in objs:
            store.create(kind, json.loads(json.dumps(obj)))
        out.append((store, service_cls(store, config=config, **kw, **extra)))
    return out


def _annotations(store, name):
    annos = store.get("pods", name)["metadata"].get("annotations") or {}
    return {k: v for k, v in annos.items() if k in EXTENDER_KEYS}


def test_scheduling_respects_extender_filter_and_scores(fake_extender):
    objs = [("nodes", make_node("a-banned", cpu="64", memory="128Gi")), ("nodes", make_node("b-plain")),
            ("nodes", make_node("c-favored")), ("pods", make_pod("p0", cpu="100m")),
            ("pods", make_pod("p1", cpu="200m", memory="1Gi"))]
    (store, svc), (jstore, jsvc) = _both(objs, _config(fake_extender))
    placements = svc.schedule_pending()
    assert placements == jsvc.schedule_pending()
    assert placements["default/p0"] == "c-favored"
    for name in ("p0", "p1"):
        annos = _annotations(store, name)
        assert annos == _annotations(jstore, name) and set(annos) == set(EXTENDER_KEYS)
        assert (store.get("pods", name)["metadata"]["annotations"]
                == jstore.get("pods", name)["metadata"]["annotations"])
    filt = json.loads(_annotations(store, "p0")[EXTENDER_FILTER_RESULT_KEY])
    assert filt[fake_extender]["failedNodes"] == {"a-banned": "banned by extender"}
    prio = json.loads(_annotations(store, "p0")[EXTENDER_PRIORITIZE_RESULT_KEY])
    scores = {hp["host"]: hp["score"] for hp in prio[fake_extender]}
    assert scores["c-favored"] == 100 and scores["b-plain"] == 10  # weight * 100 / 10
    timings = svc.metrics.snapshot()["timings"]
    assert timings["engine"]["count"] == 2 and timings["extender_http"]["count"] == 4


def test_extender_service_routes_and_config_override(fake_extender):
    """What the proxy routes (/api/v1/extender/<verb>/<id>) call: the
    extender service by index, recording each call for the pod."""
    store = ClusterStore()
    svc = SchedulerService(store, config=_config(fake_extender, nodeCacheCapable=False), device="cpu")
    ext = svc.extender_service
    pod = make_pod("px")
    nodes = {"items": [make_node("n-banned"), make_node("n-ok")]}
    assert ext.filter(0, {"pod": pod, "nodes": nodes})["nodenames"] == ["n-ok"]
    assert [hp["score"] for hp in ext.prioritize(0, {"pod": pod, "nodenames": ["n-ok"]})] == [10]
    stored = ext.store.get_stored_result(pod)
    assert set(stored) == set(EXTENDER_KEYS)
    assert json.loads(stored[EXTENDER_PREEMPT_RESULT_KEY]) == {}
    out = override_extenders_cfg_to_simulator(_config("https://real.example.com", enableHTTPS=True), 1212)
    e = out["extenders"][0]
    assert e["urlPrefix"] == "http://localhost:1212/api/v1/extender/"
    assert (e["filterVerb"], e["prioritizeVerb"], e["enableHTTPS"]) == ("filter/0", "prioritize/0", False)


def test_ignorable_extender_failure():
    objs = [("nodes", make_node("n0")), ("pods", make_pod("p0"))]
    # An unreachable extender on a local port nothing listens on.
    unreachable = {"urlPrefix": "http://127.0.0.1:1", "filterVerb": "filter"}
    for ignorable, want in ((True, "n0"), (False, None)):
        cfg = {"extenders": [dict(unreachable, ignorable=ignorable)]}
        (store, svc), (_, jsvc) = _both(objs, cfg)
        got = svc.schedule_pending()
        assert got == jsvc.schedule_pending() == {"default/p0": want}


def test_extender_preemption_still_runs(fake_extender):
    objs = [("nodes", make_node("n0", cpu="2", memory="8Gi")),
            ("pods", make_pod("low", cpu="2", memory=None, node_name="n0", priority=1)),
            ("pods", make_pod("crit", cpu="1", memory=None, priority=100))]
    (store, svc), (jstore, jsvc) = _both(objs, _config(fake_extender))
    assert svc.schedule_pending() == jsvc.schedule_pending() == {"default/crit": None}
    assert store.get("pods", "crit")["status"]["nominatedNodeName"] == "n0"
    assert [p["metadata"]["name"] for p in store.list("pods")] == ["crit"]
    assert svc.schedule_pending() == jsvc.schedule_pending() == {"default/crit": "n0"}
    assert _annotations(store, "crit") == _annotations(jstore, "crit")


def test_proxy_results_flushed_by_watch_loop(fake_extender):
    """An external scheduler drives the proxy; the service's watch loop
    writes the recorded extender annotations onto the pod."""
    store = ClusterStore()
    store.create("nodes", make_node("n0"))
    svc = SchedulerService(store, config=_config(fake_extender), device="cpu")
    pod = make_pod("ext-pod")
    pod["spec"]["schedulerName"] = "someone-else"  # not ours to schedule
    store.create("pods", pod)
    svc.start()
    try:
        svc.extender_service.filter(0, {"pod": store.get("pods", "ext-pod"), "nodenames": ["n0"]})
        store.patch("pods", "ext-pod", "default", lambda o: o["spec"].__setitem__("nodeName", "n0"))
        deadline = time.monotonic() + 5
        found = False
        while time.monotonic() < deadline and not found:
            found = EXTENDER_FILTER_RESULT_KEY in (store.get("pods", "ext-pod")["metadata"].get("annotations") or {})
            time.sleep(0.05)
        assert found
    finally:
        svc.stop()


def test_extenders_keep_the_replay_per_pass(fake_extender):
    """The device replay refuses a service with extenders under ksim_tpu's
    reason, and the per-pass path runs the webhooks."""
    from ksim_tpu_torch.scenario.runner import Operation, ScenarioRunner

    ops = [Operation(step=0, op="create", kind="nodes", obj=make_node("n-favored")),
           Operation(step=0, op="create", kind="nodes", obj=make_node("n-plain")),
           Operation(step=1, op="create", kind="pods", obj=make_pod("p1"))]
    runner = ScenarioRunner(device_replay=True, device="cpu", config=_config(fake_extender))
    res = runner.run(ops)
    assert res.pods_scheduled == 1
    assert runner.store.get("pods", "p1")["spec"]["nodeName"] == "n-favored"
    assert runner.replay_driver.unsupported.get("extenders", 0) >= 1
    assert runner.replay_driver.device_steps == 0


# ---------------------------------------------------------------------------
# The lifecycle samples and builderImport
# ---------------------------------------------------------------------------


def _import_cfg(point: str, name: str, target: str) -> dict:
    return {"profiles": [{
        "plugins": {point: {"enabled": [{"name": name}]}},
        "pluginConfig": [{"name": name, "args": {"builderImport": f"ksim_tpu_torch.plugins.samples.{target}"}}],
    }]}


def test_fifo_sort_changes_scheduling_order():
    node = make_node("n1", pods=1)
    early_low = make_pod("early-low")
    early_low["metadata"]["creationTimestamp"] = "2024-01-01T00:00:00Z"
    late_high = make_pod("late-high", priority=100)
    late_high["metadata"]["creationTimestamp"] = "2024-01-02T00:00:00Z"
    objs = [("nodes", node), ("pods", early_low), ("pods", late_high)]

    def run(config):
        store = ClusterStore()
        for kind, obj in objs:
            store.create(kind, json.loads(json.dumps(obj)))
        return SchedulerService(store, config=config, preemption=False, device="cpu").schedule_pending()

    default = run({})
    assert (default["default/late-high"], default["default/early-low"]) == ("n1", None)
    fifo = run(_import_cfg("queueSort", "FifoSort", "lifecycle:FIFO_SORT_PLUGIN"))
    assert (fifo["default/early-low"], fifo["default/late-high"]) == ("n1", None)


def test_name_prefix_gate_keeps_pods_out_of_the_queue():
    store = ClusterStore()
    for obj in (make_node("n1"), make_pod("hold-me"), make_pod("free")):
        store.create("nodes" if obj["kind"] == "Node" else "pods", obj)
    svc = SchedulerService(store, config=_import_cfg("preEnqueue", "NamePrefixGate",
                                                     "lifecycle:NAME_PREFIX_GATE_PLUGIN"), device="cpu")
    assert svc.schedule_pending() == {"default/free": "n1"}
    assert not store.get("pods", "hold-me").get("spec", {}).get("nodeName")


def test_placement_export_writes_jsonl(tmp_path):
    cfg = _import_cfg("postBind", "PlacementExport", "lifecycle:PLACEMENT_EXPORT_PLUGIN")
    cfg["profiles"][0]["pluginConfig"][0]["args"]["sinkPath"] = str(tmp_path / "binds.jsonl")
    store = ClusterStore()
    store.create("nodes", make_node("n1"))
    for name in ("p1", "p2"):
        store.create("pods", make_pod(name))
    svc = SchedulerService(store, config=cfg, device="cpu")
    assert svc.schedule_pending() == {"default/p1": "n1", "default/p2": "n1"}
    lines = [json.loads(x) for x in (tmp_path / "binds.jsonl").read_text().splitlines()]
    assert sorted(lines, key=lambda r: r["pod"]) == [{"pod": "default/p1", "node": "n1"},
                                                     {"pod": "default/p2", "node": "n1"}]


def test_builder_import_refuses_ksim_tpu_paths(monkeypatch):
    spec = "ksim_tpu.plugins.samples.nodenumber:NODE_NUMBER_PLUGIN"
    with pytest.raises(InvalidConfigError, match="ksim_tpu_torch.plugins.samples.nodenumber:NODE_NUMBER_PLUGIN"):
        load_plugin_import(spec)
    cfg = {"profiles": [{"plugins": {"multiPoint": {"enabled": [{"name": "NodeNumber"}]}},
                         "pluginConfig": [{"name": "NodeNumber", "args": {"builderImport": spec}}]}]}
    with pytest.raises(InvalidConfigError):
        SchedulerService(ClusterStore(), config=cfg, device="cpu")
    # The port's own path loads, and the allowlist still narrows it.
    builder, encoders, _ = load_plugin_import("ksim_tpu_torch.plugins.samples.nodenumber:NODE_NUMBER_PLUGIN")
    assert callable(builder) and "nodenumber" in encoders
    monkeypatch.setenv("KSIM_ALLOWED_PLUGIN_MODULES", "ksim_tpu_torch.plugins.samples")
    load_plugin_import("ksim_tpu_torch.plugins.samples.lifecycle:FIFO_SORT_PLUGIN")
    with pytest.raises(ValueError, match="KSIM_ALLOWED_PLUGIN_MODULES"):
        load_plugin_import("ksim_tpu_torch.scheduler.profile:load_plugin_import")
    for bad, msg in (("no-colon", "must look like"), ("ksim_tpu_torch.nope:thing", "cannot load"),
                     ("ksim_tpu_torch.plugins.samples.nodenumber:missing_attr", "cannot load"),
                     ("ksim_tpu_torch.plugins.samples.nodenumber:__doc__", "callable builder")):
        monkeypatch.delenv("KSIM_ALLOWED_PLUGIN_MODULES", raising=False)
        with pytest.raises(ValueError, match=msg):
            load_plugin_import(bad)


def test_node_number_and_data_provider_through_the_service():
    """tests/test_samples_extenders.py's service flows on the port: the
    registry builder with the featurizer's extra encoder, and a data
    provider that runs once per featurization."""
    import numpy as np

    from ksim_tpu_torch.engine.annotations import SCORE_RESULT_KEY
    from ksim_tpu_torch.plugins.samples import (
        data_provider_builder, encode_node_number, node_number_builder, provider_encoder,
    )
    from ksim_tpu_torch.state.featurizer import Featurizer

    store = ClusterStore()
    store.create("nodes", make_node("big-5", cpu="64", memory="128Gi"))
    store.create("nodes", make_node("node-7", cpu="64", memory="128Gi"))
    store.create("pods", make_pod("app-7", cpu="100m"))
    cfg = {"profiles": [{"plugins": {"multiPoint": {"enabled": [{"name": "NodeNumber", "weight": 100}]}}}]}
    svc = SchedulerService(store, config=cfg, registry={"NodeNumber": node_number_builder()},
                           featurizer=Featurizer(extra_encoders={"nodenumber": encode_node_number}), device="cpu")
    assert svc.schedule_pending() == {"default/app-7": "node-7"}
    scores = json.loads(store.get("pods", "app-7")["metadata"]["annotations"][SCORE_RESULT_KEY])
    assert scores["node-7"]["NodeNumber"] == "10"

    calls = []

    def provider(nodes):
        calls.append(len(nodes))
        return np.asarray([90 if "green" in n["metadata"]["name"] else 5 for n in nodes])

    store = ClusterStore()
    store.create("nodes", make_node("dirty-dc", cpu="64", memory="128Gi"))
    store.create("nodes", make_node("green-dc", cpu="64", memory="128Gi"))
    store.create("pods", make_pod("p", cpu="100m"))
    svc = SchedulerService(
        store, config={"profiles": [{"plugins": {"multiPoint": {"enabled": [{"name": "Renewable", "weight": 10}]}}}]},
        registry={"Renewable": data_provider_builder("Renewable", provider)},
        featurizer=Featurizer(extra_encoders={"provider:Renewable": provider_encoder(provider)}), device="cpu",
    )
    assert svc.schedule_pending() == {"default/p": "green-dc"}
    assert calls
