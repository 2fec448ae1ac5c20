"""The port's syncer, one-shot importer, kube-apiserver source and live
write-back against ksim_tpu's, on the CPU.

- ``Syncer``: two sources (one store of each package) take the same
  operations; each package's syncer mirrors its own into a destination,
  first by ``sync_once`` (with user filters and mutators), then live.
  The destinations end with the same objects and saw the same watch
  events, in the same order.
- ``OneShotImporter``: the same source snapshot lands as the same
  objects, the source's scheduler configuration ignored.
- ``KubeApiSource`` and ``LiveWriteBack``: two stub kube-apiservers
  (tests/test_kubeapi.py's) hold the same cluster; each package mirrors
  one through its ``Syncer``, schedules the mirror (the port on the CPU)
  and writes the binds and result annotations back.  Both stubs get the
  same requests and end in the same state, and a relist after a 410
  converges the same way.
- ``load_kubeconfig``: the same kubeconfig files give the same server,
  headers and TLS choice."""

from __future__ import annotations

import base64
import contextlib
import copy
import json
import threading
import time
from http.server import ThreadingHTTPServer

import pytest
import torch
import yaml

import ksim_tpu.syncer.kubeapi as jax_kubeapi
import ksim_tpu_torch.syncer.kubeapi as port_kubeapi
from ksim_tpu.oneshotimporter import OneShotImporter as JaxImporter
from ksim_tpu.scheduler.service import SchedulerService as JaxService
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu.state.snapshot import SnapshotService as JaxSnapshots
from ksim_tpu.syncer import Syncer as JaxSyncer
from ksim_tpu.syncer import SyncerOptions as JaxOptions
from ksim_tpu.syncer.writeback import LiveWriteBack as JaxWriteBack
from ksim_tpu_torch.oneshotimporter import OneShotImporter
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import KINDS, ClusterStore
from ksim_tpu_torch.state.snapshot import SnapshotService
from ksim_tpu_torch.syncer import Syncer, SyncerOptions
from ksim_tpu_torch.syncer.writeback import LiveWriteBack
from tests.helpers import make_node, make_pod
from tests.test_kubeapi import _ApiState, _Handler

# (package name, store, syncer, options, importer, snapshots, service,
# write-back, kubeapi module, service kwargs)
PACKAGES = {
    "ksim_tpu": (JaxStore, JaxSyncer, JaxOptions, JaxImporter, JaxSnapshots, JaxService, JaxWriteBack,
                 jax_kubeapi, {}),
    "port": (ClusterStore, Syncer, SyncerOptions, OneShotImporter, SnapshotService, SchedulerService,
             LiveWriteBack, port_kubeapi, {"device": "cpu"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _wait(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _initial_objects() -> list[tuple[str, dict]]:
    pod = make_pod("p0")
    pod["spec"]["serviceAccountName"] = "robot"
    pod["metadata"]["ownerReferences"] = [{"kind": "ReplicaSet", "name": "rs"}]
    pod["metadata"]["uid"] = "src-uid-42"
    pvc = {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
           "metadata": {"name": "claim", "namespace": "default"}, "spec": {}}
    pv = {"apiVersion": "v1", "kind": "PersistentVolume", "metadata": {"name": "vol"},
          "spec": {"claimRef": {"name": "claim", "namespace": "default", "uid": "stale-src-uid"}},
          "status": {"phase": "Bound"}}
    return [("nodes", make_node("n0")), ("nodes", make_node("drop")), ("nodes", make_node("keep")),
            ("pods", pod), ("pods", make_pod("bound", node_name="n0")),
            ("persistentvolumeclaims", pvc), ("persistentvolumes", pv),
            ("namespaces", {"metadata": {"name": "kube-system"}}), ("namespaces", {"metadata": {"name": "apps"}})]


def _live_ops(src) -> None:
    """The same live operations on a source store of either package."""
    src.create("pods", make_pod("p1"))
    src.patch("pods", "p1", "default", lambda o: o["metadata"].setdefault("labels", {}).__setitem__("x", "1"))
    src.patch("pods", "p1", "default", lambda o: o["spec"].__setitem__("nodeName", "n0"))  # filtered
    src.delete("pods", "p0")
    src.create("nodes", make_node("late"))
    src.delete("nodes", "keep")
    src.create("nodes", make_node("sentinel"))


def _options(options_cls):
    return options_cls(
        additional_filtering={"nodes": lambda o, d, e: o["metadata"]["name"] != "drop"},
        additional_mutating={"nodes": lambda o, d, e: {
            **o, "metadata": {**o["metadata"], "labels": {**o["metadata"].get("labels", {}), "synced": "true"}}}},
    )


def _events(stream) -> list:
    out = []
    while (ev := stream.next(timeout=0.2)) is not None:
        out.append(json.dumps(ev.to_json(), sort_keys=True))
    return out


def test_syncer_mirrors_the_same_objects_and_events():
    seen = {}
    for name, (store_cls, syncer_cls, options_cls, *_rest) in PACKAGES.items():
        src, dst = store_cls(), store_cls()
        for kind, obj in _initial_objects():
            src.create(kind, copy.deepcopy(obj))
        stream = dst.watch(KINDS)
        syncer = syncer_cls(src, dst, _options(options_cls))
        syncer.run()
        try:
            _wait(lambda: dst.contains("pods", "p0", "default"), what=f"{name} initial sync")
            _live_ops(src)
            _wait(lambda: dst.contains("nodes", "sentinel"), what=f"{name} live sync")
        finally:
            syncer.stop()
        seen[name] = (dst.dump(), _events(stream))
        stream.close()
    assert seen["port"] == seen["ksim_tpu"]
    dump, events = seen["port"]
    assert "drop" not in json.dumps(dump["nodes"]) and "nodeName" not in json.dumps(dump["pods"].get("default/p1"))
    assert len(events) > 10


def test_oneshot_importer_loads_the_same_objects():
    seen = {}
    for name, (store_cls, _syncer, _options_cls, importer_cls, snapshots_cls, *_rest) in PACKAGES.items():
        src, dst = store_cls(), store_cls()
        for kind, obj in _initial_objects():
            src.create(kind, copy.deepcopy(obj))

        class _SourceWithConfig(snapshots_cls):
            def snap(self, label_selector=None):
                doc = super().snap(label_selector)
                doc["schedulerConfig"] = {"profiles": [{"schedulerName": "from-the-source"}]}
                return doc

        importer_cls(snapshots_cls(dst), _SourceWithConfig(src)).import_cluster_resources({"matchLabels": {}})
        seen[name] = dst.dump()
    assert seen["port"] == seen["ksim_tpu"]
    assert seen["port"]["pods"]


@contextlib.contextmanager
def _stub_apiserver():
    state = _ApiState()
    handler = type("H", (_Handler,), {"state": state})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield state, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        state.drop_watches()
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def _stop_syncer(syncer, state) -> None:
    """Stop a syncer over a stub apiserver.  A watch reader parked in a
    socket read notices the stop only when its stream ends, so the stub
    drops its watches until the syncer has stopped."""
    stopper = threading.Thread(target=syncer.stop)
    stopper.start()
    while stopper.is_alive():
        state.drop_watches()
        stopper.join(timeout=0.05)


def _without_rvs(dump: dict) -> dict:
    """A store dump without resourceVersions: the source watches each kind
    on its own thread, so the order of the mirror's writes across kinds
    (and so their versions) varies from run to run, in either package."""
    out = json.loads(json.dumps(dump))
    for objs in out.values():
        for obj in objs.values():
            obj.get("metadata", {}).pop("resourceVersion", None)
    return out


def _stub_view(state) -> dict:
    """What a stub apiserver ended with: its objects (resourceVersions
    kept: the same request sequence gives the same ones) and the write
    requests it took."""
    with state.cond:
        return json.loads(json.dumps({
            "objects": state.objects, "binds": state.binding_posts, "patches": state.annotation_patches,
            "deletes": state.pod_deletes}))


def test_kubeapi_source_and_live_writeback_make_the_same_requests():
    seen = {}
    for name, (store_cls, syncer_cls, _o, _i, _s, service_cls, writeback_cls, kubeapi, kw) in PACKAGES.items():
        with _stub_apiserver() as (state, url):
            state.apply("nodes", "ADDED", make_node("n0", cpu="8", memory="16Gi"))
            state.apply("nodes", "ADDED", make_node("n1", cpu="2", memory="4Gi"))
            state.apply("pods", "ADDED", make_pod("live-pod", cpu="1", memory="1Gi"))
            state.apply("pods", "ADDED", make_pod("too-big", cpu="100", memory="1Ti"))
            src = kubeapi.KubeApiSource(url)
            listed = (src.list("nodes"), src.snap())
            store = store_cls()
            syncer = syncer_cls(src, store)
            syncer.run()
            wb = writeback_cls(src, store).start()
            try:
                _wait(lambda: len(store.list("pods")) == 2 and len(store.list("nodes")) == 2, what=f"{name} mirror")
                placements = service_cls(store, record="full", preemption=False, **kw).schedule_pending()
                _wait(lambda: len(state.annotation_patches) == 2 and state.binding_posts, what=f"{name} write-back")
                # A compaction with a lost delete: the 410 relist converges.
                state.forget("nodes", "n1")
                state.compact()
                state.drop_watches()
                _wait(lambda: not store.contains("nodes", "n1"), what=f"{name} relist")
            finally:
                wb.stop()
                _stop_syncer(syncer, state)
                src.close()
            seen[name] = (placements, listed, _stub_view(state), _without_rvs(store.dump()))
    assert seen["port"] == seen["ksim_tpu"]
    placements, _, view, _ = seen["port"]
    assert placements == {"default/live-pod": "n0", "default/too-big": None}
    assert view["binds"] == [["default", "live-pod", "n0"]]


def test_load_kubeconfig_reads_the_same_credentials(tmp_path):
    token = tmp_path / "token"
    token.write_text("from-file\n")
    users = [{"token": "sekret"}, {"username": "admin", "password": "pw"}, {"tokenFile": str(token)}]
    clusters = [{"server": "http://127.0.0.1:8080"}, {"server": "https://10.0.0.1:6443",
                                                      "insecure-skip-tls-verify": True}]
    checked = 0
    for i, user in enumerate(users):
        for j, cluster in enumerate(clusters):
            path = tmp_path / f"kubeconfig-{i}-{j}.yaml"
            path.write_text(yaml.safe_dump({
                "apiVersion": "v1", "kind": "Config", "current-context": "ctx",
                "contexts": [{"name": "ctx", "context": {"cluster": "c", "user": "u"}}],
                "clusters": [{"name": "c", "cluster": cluster}], "users": [{"name": "u", "user": user}]}))
            got, ref = port_kubeapi.load_kubeconfig(str(path)), jax_kubeapi.load_kubeconfig(str(path))
            assert got["server"] == ref["server"] and got["headers"] == ref["headers"]
            assert (got["ssl_context"] is None) == (ref["ssl_context"] is None)
            if got["ssl_context"] is not None:
                assert got["ssl_context"].check_hostname == ref["ssl_context"].check_hostname
            checked += 1
    assert checked == 6
    assert port_kubeapi.load_kubeconfig(str(tmp_path / "kubeconfig-1-0.yaml"))["headers"]["Authorization"] == (
        "Basic " + base64.b64encode(b"admin:pw").decode())
    bad = tmp_path / "exec.yaml"
    bad.write_text(yaml.safe_dump({
        "apiVersion": "v1", "kind": "Config", "current-context": "ctx",
        "contexts": [{"name": "ctx", "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": clusters[0]}], "users": [{"name": "u", "user": {"exec": {"command": "x"}}}]}))
    messages = []
    for mod in (port_kubeapi, jax_kubeapi):
        with pytest.raises(Exception) as err:
            mod.load_kubeconfig(str(bad))
        messages.append((type(err.value).__name__, str(err.value)))
    assert messages[0] == messages[1] and messages[0][0] == "InvalidConfigError"
