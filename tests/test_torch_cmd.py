"""The port's entrypoints against ksim_tpu's, on the CPU.

- ``cmd.scheduler.run_scheduler`` of both packages, on one snapshot file
  (with unschedulable pods, and with a KubeSchedulerConfiguration), writes
  byte-equal snapshots (the port's with ``--device cpu``);
- ``cmd.simulation.run_simulation`` on a small SchedulerSimulation
  document prints an equal status and returns an equal exit code;
- ``python -m ksim_tpu_torch.cmd.simulator --device cpu``, started as a
  process with a one-shot import config, exports what ksim_tpu's
  in-process ``DIContainer`` exports after the same import and one pass,
  and exits 0 on SIGTERM;
- the deprecated ``externalscheduler`` shim warns and schedules as
  ksim_tpu's does."""

from __future__ import annotations

import json
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch
import yaml

from ksim_tpu.cmd.scheduler import run_scheduler as jax_run_scheduler
from ksim_tpu.cmd.simulation import run_simulation as jax_run_simulation
from ksim_tpu.oneshotimporter import OneShotImporter as JaxImporter
from ksim_tpu.server import DIContainer as JaxDI
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu.state.snapshot import SnapshotService as JaxSnapshots
from ksim_tpu_torch.cmd.scheduler import run_scheduler
from ksim_tpu_torch.cmd.simulation import run_simulation
from tests.helpers import make_node, make_pod, random_cluster, sanitized_cpu_env
from tests.test_torch_scenario_docs import scenario_doc

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _write_snapshot(path: Path, seed: int, n_nodes: int, n_pods: int) -> None:
    nodes, pods = random_cluster(seed, n_nodes, n_pods, bound_fraction=0.0)
    store = JaxStore()
    for n in nodes:
        store.create("nodes", n)
    for p in pods:
        store.create("pods", p)
    path.write_text(JaxSnapshots(store).export_json())


# Two of the 60 pods are unschedulable under the default profile (seed
# 0); the config reweights the scores and drops the spread and inter-pod
# plugins, which places them all.
CONFIGS = {
    "default": None,
    "profile": {"profiles": [{"schedulerName": "default-scheduler", "plugins": {"multiPoint": {
        "enabled": [{"name": "NodeResourcesBalancedAllocation", "weight": 4}],
        "disabled": [{"name": "PodTopologySpread"}, {"name": "InterPodAffinity"}]}}}]},
}


@pytest.mark.parametrize("config", CONFIGS, ids=list(CONFIGS))
def test_scheduler_command_writes_the_same_snapshot(tmp_path, config):
    snap = tmp_path / "snap.json"
    _write_snapshot(snap, 0, 24, 60)
    argv = ["--snapshot", str(snap)]
    if CONFIGS[config] is not None:
        (tmp_path / "sched.yaml").write_text(yaml.safe_dump(CONFIGS[config]))
        argv += ["--config", str(tmp_path / "sched.yaml")]
    assert jax_run_scheduler(argv + ["--out", str(tmp_path / "ref.json")]) == 0
    assert run_scheduler(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    ref, got = (tmp_path / "ref.json").read_bytes(), (tmp_path / "port.json").read_bytes()
    assert got == ref
    unscheduled = sum(not p["spec"].get("nodeName") for p in json.loads(got)["pods"])
    assert unscheduled == (2 if config == "default" else 0)


def _status(text: str) -> dict:
    status = json.loads(text)
    status.get("result", {}).pop("wallSeconds", None)
    return status


def test_simulation_command_gives_the_same_status(tmp_path, capsys):
    snap_store = JaxStore()
    snap_store.create("nodes", make_node("base", cpu="2"))
    snap_store.create("pods", make_pod("seed", cpu="1"))
    (tmp_path / "snap.json").write_text(JaxSnapshots(snap_store).export_json())
    doc = {"kind": "SchedulerSimulation", "spec": {
        "simulator": {"initialSnapshotPath": str(tmp_path / "snap.json"), "recordMode": "full"},
        "scenario": scenario_doc()}}
    (tmp_path / "sim.yaml").write_text(yaml.safe_dump(doc))
    failing = {"spec": {"scenario": {"spec": {"operations": [
        {"step": 0, "deleteOperation": {"typeMeta": {"kind": "Node"}, "objectMeta": {"name": "missing"}}}]}}}}
    (tmp_path / "fail.yaml").write_text(yaml.safe_dump(failing))
    for name, want_rc, want_phase in (("sim.yaml", 0, "Succeeded"), ("fail.yaml", 1, "Failed")):
        out = {}
        for pkg, fn, extra in (("ref", jax_run_simulation, []), ("port", run_simulation, ["--device", "cpu"])):
            result = tmp_path / f"{pkg}-{name}.json"
            rc = fn([str(tmp_path / name), "--result", str(result)] + extra)
            out[pkg] = (rc, _status(capsys.readouterr().out), _status(json.dumps(json.loads(result.read_text())["status"])))
        assert out["port"] == out["ref"]
        assert out["port"][0] == want_rc and out["port"][1]["phase"] == want_phase


def _get(port: int, path: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.read()


def test_simulator_process_exports_what_ksim_tpu_exports(tmp_path):
    snap = tmp_path / "snap.json"
    _write_snapshot(snap, 4, 24, 60)  # every pod fits in one pass
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump({"externalImportEnabled": True, "externalSnapshotPath": str(snap)}))
    log = open(tmp_path / "simulator.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ksim_tpu_torch.cmd.simulator", "--config", str(cfg), "--port", "0",
         "--device", "cpu"],
        cwd=ROOT, env=sanitized_cpu_env({"OMP_NUM_THREADS": "1"}), stdout=log, stderr=subprocess.STDOUT,
    )
    try:
        # ksim_tpu's container: the same one-shot import, then one pass.
        file_store = JaxStore()
        JaxSnapshots(file_store).load(json.loads(snap.read_text()), ignore_err=True)
        ref_di = JaxDI()
        JaxImporter(ref_di.snapshot_service, JaxSnapshots(file_store)).import_cluster_resources(None)
        ref_di.scheduler_service.schedule_pending()
        want = ref_di.snapshot_service.snap()
        port = None
        deadline = time.monotonic() + 60
        while port is None and proc.poll() is None and time.monotonic() < deadline:
            m = re.search(r"simulator server started on :(\d+)", (tmp_path / "simulator.log").read_text())
            port = int(m.group(1)) if m else None
            time.sleep(0.05)
        assert port is not None, (tmp_path / "simulator.log").read_text()
        got = None
        while time.monotonic() < deadline:
            got = json.loads(_get(port, "/api/v1/export"))
            if all(p["spec"].get("nodeName") for p in got["pods"]):
                break
            time.sleep(0.1)
        assert got == want
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()


def test_external_scheduler_shim_warns_and_schedules_like_ksim_tpu():
    from ksim_tpu.externalscheduler import new_scheduler as jax_new_scheduler
    from ksim_tpu_torch.externalscheduler import Builder, new_scheduler
    from ksim_tpu_torch.scheduler.profile import Builder as PortBuilder
    from ksim_tpu_torch.scheduler.service import SchedulerService
    from ksim_tpu_torch.state.cluster import ClusterStore

    placed = []
    for store_cls, factory, kw in ((ClusterStore, new_scheduler, {"device": "cpu"}), (JaxStore, jax_new_scheduler, {})):
        store = store_cls()
        for i in range(3):
            store.create("nodes", make_node(f"n{i}", cpu=str(2 + i)))
        for i in range(4):
            store.create("pods", make_pod(f"p{i}", cpu="1"))
        with pytest.warns(DeprecationWarning, match="externalscheduler is deprecated"):
            svc = factory(store, **kw)
        placed.append(svc.schedule_pending())
    assert Builder is PortBuilder
    assert placed[0] == placed[1] and all(placed[0].values())
    with pytest.warns(DeprecationWarning):
        assert isinstance(new_scheduler(ClusterStore(), device="cpu"), SchedulerService)
