"""The port's simulator server against ksim_tpu's, on the CPU.

Two ``SimulatorServer``s on ephemeral ports, one over ksim_tpu's
``DIContainer`` and one over the port's (``device="cpu"``), each with the
same snapshot imported before its watch loop starts, take the same
requests; every answer must be equal, byte for byte where the body is
JSON.  The watch loop retries an unschedulable pod on a wall-clock
cadence, so the clusters here place every pod in the first pass: the
export after the loop is then one pass's, in both.  (The unschedulable
path is held exactly by tests/test_torch_cmd.py's one-pass runs.)

The job routes are held the same way in tests/test_torch_jobs.py."""

from __future__ import annotations

import contextlib
import http.client
import json
import threading
import time
from http.server import ThreadingHTTPServer

import pytest
import torch

import ksim_tpu.obs as jax_obs
import ksim_tpu.scheduler.service as jax_service_mod
import ksim_tpu.server.http as jax_http
import ksim_tpu_torch.obs as port_obs
import ksim_tpu_torch.scheduler.service as port_service_mod
import ksim_tpu_torch.server.http as port_http
from ksim_tpu.server import DIContainer as JaxDI
from ksim_tpu.server import SimulatorServer as JaxServer
from ksim_tpu.state.snapshot import SnapshotService as JaxSnapshots
from ksim_tpu_torch.server import DIContainer, SimulatorServer
from ksim_tpu_torch.server.params import LRV_PARAMS
from ksim_tpu_torch.state.cluster import KINDS
from tests.helpers import make_node, make_pod, random_cluster
from tests.test_torch_engine import x64
from tests.test_torch_extenders import _FakeExtender

# Every pod of this cluster fits in the first pass (module docstring).
CLUSTER = (4, 24, 60)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _snapshot(seed: int, n_nodes: int, n_pods: int) -> dict:
    nodes, pods = random_cluster(seed, n_nodes, n_pods, bound_fraction=0.0)
    from ksim_tpu.state.cluster import ClusterStore as JaxStore

    store = JaxStore()
    for n in nodes:
        store.create("nodes", n)
    for p in pods:
        store.create("pods", p)
    return JaxSnapshots(store).snap()


@contextlib.contextmanager
def _pair(snapshot: "dict | None" = None, config: "dict | None" = None, exact: bool = True):
    """ksim_tpu's server and the port's, each with ``snapshot`` loaded
    before its loop starts; yields [jax, port] servers and shuts both
    down (loops joined) on exit.  ``exact=False`` is f32 mode: the port's
    container with ``exact=False``, ksim_tpu's with x64 off."""
    servers = []
    try:
        for di_cls, srv_cls, kw in ((JaxDI, JaxServer, {}),
                                    (DIContainer, SimulatorServer, {"device": "cpu", "exact": exact})):
            di = di_cls(scheduler_config=json.loads(json.dumps(config)) if config else None, **kw)
            if snapshot is not None:
                di.snapshot_service.load(json.loads(json.dumps(snapshot)))
            srv = srv_cls(di, port=0)
            servers.append(srv)
            di.scheduler_service.start()
            srv.start()
        yield servers
    finally:
        for srv in servers:
            srv.shutdown_server()
            srv.di.shutdown(timeout=30)


def _req(srv, method, path, body=None, headers=None):
    """One request; (status, headers, body bytes)."""
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
        c.request(method, path, data, {"Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def _both(servers, method, path, body=None, headers=None):
    """The same request to both servers; asserts equal status and body
    and returns the port's (status, body)."""
    (js, _, jb), (ps, _, pb) = (_req(s, method, path, body, headers) for s in servers)
    assert (ps, pb) == (js, jb), (method, path)
    return ps, pb


def _settled(servers, timeout=30.0):
    """Wait until no pod in either store is pending."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        pending = [sum(not p["spec"].get("nodeName") for p in s.di.store.list("pods")) for s in servers]
        if pending == [0, 0]:
            return
        time.sleep(0.05)
    raise AssertionError(f"pods still pending after {timeout}s: {pending}")


def test_export_configuration_and_reset():
    with _pair(_snapshot(*CLUSTER)) as servers:
        _settled(servers)
        _, body = _both(servers, "GET", "/api/v1/export")
        assert len(json.loads(body)["pods"]) == CLUSTER[2]
        _, cfg = _both(servers, "GET", "/api/v1/schedulerconfiguration")
        _both(servers, "GET", "/api/v1/schedulerconfiguration?format=yaml")
        # Only .profiles and .extenders are taken from a POST; scores
        # reweighted, then new pods scheduled under the new profile.
        new = json.loads(cfg)
        new["profiles"][0].setdefault("plugins", {})["multiPoint"] = {"enabled": [
            {"name": "NodeResourcesBalancedAllocation", "weight": 7},
            {"name": "ImageLocality", "weight": 5},
        ]}
        assert _both(servers, "POST", "/api/v1/schedulerconfiguration", new)[0] == 202
        _both(servers, "GET", "/api/v1/schedulerconfiguration")
        for i in range(3):
            pod = make_pod(f"late-{i}", cpu="250m", memory="256Mi")
            assert _both(servers, "POST", "/api/v1/resources/pods", pod)[0] == 201
            _settled(servers)
        _both(servers, "GET", "/api/v1/export")
        assert _both(servers, "PUT", "/api/v1/reset")[0] == 202
        _, body = _both(servers, "GET", "/api/v1/export")
        assert json.loads(body)["pods"] == []
        _both(servers, "GET", "/api/v1/schedulerconfiguration")


def _watch_lines(srv, query: str, n: int) -> list[bytes]:
    """The first ``n`` newline-delimited events of a listwatch stream."""
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        c.request("GET", "/api/v1/listwatchresources" + query)
        r = c.getresponse()
        assert r.status == 200
        return [r.readline() for _ in range(n)]
    finally:
        c.close()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_listwatch_and_resource_crud(exact):
    with x64(exact), _pair(_snapshot(*CLUSTER), exact=exact) as servers:
        _settled(servers)
        stores = [s.di.store for s in servers]
        n_objects = sum(len(stores[1].list(kind)) for kind in KINDS)
        assert n_objects == sum(len(stores[0].list(kind)) for kind in KINDS) >= CLUSTER[1] + CLUSTER[2]
        listed = [_watch_lines(s, "", n_objects) for s in servers]
        assert listed[1] == listed[0]
        rv = max(int(json.loads(line)["Obj"]["metadata"]["resourceVersion"]) for line in listed[1])
        node = make_node("crud-node", cpu="2", memory="4Gi")
        assert _both(servers, "POST", "/api/v1/resources/nodes", node)[0] == 201
        assert _both(servers, "POST", "/api/v1/resources/nodes", node)[0] == 409
        _, got = _both(servers, "GET", "/api/v1/resources/nodes/crud-node")
        stale = json.loads(got)
        fresh = dict(stale, metadata=dict(stale["metadata"], labels={"tier": "crud"}))
        assert _both(servers, "PUT", "/api/v1/resources/nodes/crud-node", fresh)[0] == 200
        # An update carries no resourceVersion precondition, in either.
        assert _both(servers, "PUT", "/api/v1/resources/nodes/crud-node", stale)[0] == 200
        assert _both(servers, "PUT", "/api/v1/resources/nodes/other-name", fresh)[0] == 400
        _both(servers, "GET", "/api/v1/resources/nodes/crud-node?format=yaml")
        _both(servers, "GET", "/api/v1/resources/pods?namespace=default")
        assert _both(servers, "GET", "/api/v1/resources/pods/default")[0] == 400
        assert _both(servers, "DELETE", "/api/v1/resources/nodes/crud-node")[0] == 200
        assert _both(servers, "GET", "/api/v1/resources/nodes/crud-node")[0] == 404
        assert _both(servers, "GET", "/api/v1/resources/widgets")[0] == 404
        # Resume every kind after ``rv``: the node's four writes.
        query = "?" + "&".join(f"{param}={rv}" for param in LRV_PARAMS.values())
        resumed = [_watch_lines(s, query, 4) for s in servers]
        assert resumed[1] == resumed[0]
        assert [json.loads(line)["EventType"] for line in resumed[1]] == ["ADDED", "MODIFIED", "MODIFIED", "DELETED"]


def test_metrics_trace_and_misc_routes(monkeypatch):
    # Fresh trace planes and one provider, the same in both packages, so
    # what earlier tests in this process recorded does not show.
    for http_mod, service_mod, obs_mod in ((jax_http, jax_service_mod, jax_obs),
                                           (port_http, port_service_mod, port_obs)):
        plane = obs_mod.TracePlane()
        plane.enable(ring=True)
        monkeypatch.setattr(http_mod, "TRACE", plane)
        monkeypatch.setattr(service_mod, "TRACE", plane)
        monkeypatch.setattr(obs_mod, "_providers", {"compile_cache": obs_mod._providers["compile_cache"]})
    with _pair(_snapshot(*CLUSTER)) as servers:
        _settled(servers)
        docs = [json.loads(_req(s, "GET", "/api/v1/metrics")[2]) for s in servers]
        assert sorted(docs[1]) == sorted(docs[0])
        assert docs[1]["counters"] == docs[0]["counters"]
        assert sorted(docs[1]["timings"]) == sorted(docs[0]["timings"])
        assert docs[1]["jobs"] == docs[0]["jobs"]
        assert sorted(docs[1]["faults"]) == sorted(docs[0]["faults"])
        assert sorted(docs[1]["process"]) == sorted(docs[0]["process"])
        assert sorted(docs[1]["trace"]["events"].items()) == sorted(docs[0]["trace"]["events"].items())
        families = []
        for srv, obs_mod in zip(servers, (jax_obs, port_obs)):
            status, headers, text = _req(srv, "GET", "/metrics")
            assert status == 200 and headers["Content-Type"].startswith("text/plain")
            fams = port_obs.parse_prometheus(text.decode())
            assert fams.keys() == obs_mod.parse_prometheus(text.decode()).keys()
            families.append({name: (f["kind"], len(f["samples"])) for name, f in fams.items()})
        assert families[1] == families[0]
        assert "ksim_counter_total" in families[1]
        # The fleet scope of a server without the job plane: a fleet of one.
        fleet = [port_obs.parse_prometheus(_req(s, "GET", "/metrics?scope=fleet")[2].decode()) for s in servers]
        assert ({n: (f["kind"], len(f["samples"])) for n, f in fleet[1].items()}
                == {n: (f["kind"], len(f["samples"])) for n, f in fleet[0].items()})
        merged = [json.loads(_req(s, "GET", "/api/v1/metrics?scope=fleet")[2]) for s in servers]
        assert merged[1]["counters"] == merged[0]["counters"] and len(merged[1]["workers"]) == 1
        fleet_traces = [json.loads(_req(s, "GET", "/api/v1/trace?scope=fleet")[2]) for s in servers]
        assert (sorted((e["ph"], e["name"]) for e in fleet_traces[1]["traceEvents"])
                == sorted((e["ph"], e["name"]) for e in fleet_traces[0]["traceEvents"]))
        traces = [json.loads(_req(s, "GET", "/api/v1/trace")[2]) for s in servers]
        events = [sorted((e["ph"], e["name"]) for e in doc["traceEvents"] if e["ph"] != "M") for doc in traces]
        assert events[1] == events[0] and ("X", "service.schedule") in events[1]
        _both(servers, "GET", "/api/v1/traces")
        _both(servers, "GET", "/api/v1/waitingpods")
        assert _both(servers, "POST", "/api/v1/waitingpods/default/nobody/allow", {})[0] == 404
        assert _both(servers, "GET", "/api/v1/nothing-here")[0] == 404
        assert _both(servers, "DELETE", "/api/v1/export")[0] == 404
        assert _both(servers, "POST", "/api/v1/extender/filter/0", {})[0] == 400
        assert _both(servers, "POST", "/api/v1/import", b"{not json")[0] == 400
        page = [_req(s, "GET", "/") for s in servers]
        assert page[1][0] == 200 and page[1][2] == page[0][2]
        for srv in servers:
            srv.cors_allowed_origins = ("http://ui.example",)
        pre = [_req(s, "OPTIONS", "/api/v1/export", headers={"Origin": "http://ui.example"}) for s in servers]
        keep = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods", "Access-Control-Allow-Headers",
                "Access-Control-Allow-Credentials")
        got = [(st, {k: h.get(k) for k in keep}) for st, h, _ in pre]
        assert got[1] == got[0] and got[1][0] == 204
        assert got[1][1]["Access-Control-Allow-Origin"] == "http://ui.example"


@pytest.fixture()
def fake_extender():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _FakeExtender)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def test_extender_proxy(fake_extender):
    config = {"extenders": [{"urlPrefix": fake_extender, "filterVerb": "filter", "prioritizeVerb": "prioritize",
                             "weight": 1, "nodeCacheCapable": False}]}
    with _pair(config=config) as servers:
        pod = make_pod("proxied")
        nodes = {"items": [make_node("n-banned"), make_node("n-favored"), make_node("n-plain")]}
        _, body = _both(servers, "POST", "/api/v1/extender/filter/0", {"pod": pod, "nodes": nodes})
        assert json.loads(body)["nodenames"] == ["n-favored", "n-plain"]
        _, body = _both(servers, "POST", "/api/v1/extender/prioritize/0", {"pod": pod, "nodes": nodes})
        scores = [hp["score"] for hp in json.loads(body)]
        assert scores[1] > scores[0] == scores[2]
        assert _both(servers, "POST", "/api/v1/extender/filter/3", {"pod": pod, "nodes": nodes})[0] == 400
        assert _both(servers, "POST", "/api/v1/extender/filter/-1", {"pod": pod, "nodes": nodes})[0] == 400
        assert _both(servers, "POST", "/api/v1/extender/nope/0", {})[0] == 404
        stored = [s.di.extender_service.store.get_stored_result(pod) for s in servers]
        assert stored[1] == stored[0] and stored[1]
