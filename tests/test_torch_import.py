"""The port stands alone: ksim_tpu_torch and chip_smoke.py import without
jax and without ksim_tpu, name neither in any import, and never run a
plain version quietly in place of a kernel."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.kernels.batch_eval import batch_eval
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan
from ksim_tpu_torch.state.featurizer import Featurizer
from tests.helpers import make_node, make_pod, random_cluster, sanitized_cpu_env

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ksim_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ksim_tpu")

_BLOCKED_IMPORT = """
import sys
for name in list(sys.modules):
    if name.split(".")[0] in {forbidden!r}:
        del sys.modules[name]

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import importlib, pkgutil
import ksim_tpu_torch
for m in pkgutil.walk_packages(ksim_tpu_torch.__path__, "ksim_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
for name in {modules!r}:
    assert name in sys.modules, name
print("imported", len(sys.modules))
"""

# The modules of the second and later slices, which the blocked import
# must reach.
SLICE_MODULES = (
    "ksim_tpu_torch.plugins.volumes",
    "ksim_tpu_torch.plugins.podtopologyspread",
    "ksim_tpu_torch.plugins.interpodaffinity",
    "ksim_tpu_torch.kernels.schedule_sampled",
    "ksim_tpu_torch.errors",
    "ksim_tpu_torch.obs",
    "ksim_tpu_torch.faults",
    "ksim_tpu_torch.util",
    "ksim_tpu_torch.state.cluster",
    "ksim_tpu_torch.state.priorities",
    "ksim_tpu_torch.plugins.oracle",
    "ksim_tpu_torch.scheduler.preemption",
    "ksim_tpu_torch.scheduler.permit",
    "ksim_tpu_torch.scheduler.profile",
    "ksim_tpu_torch.scheduler.service",
    "ksim_tpu_torch.scenario.runner",
    "ksim_tpu_torch.scenario.generate",
    "ksim_tpu_torch.engine.replay",
    "ksim_tpu_torch.kernels.replay_segment",
    "ksim_tpu_torch.engine.fleet",
    # The eighth slice: the executor's compile-once gate, the trace
    # plane, the scenario documents and the snapshot service.
    "ksim_tpu_torch.engine.compilecache",
    "ksim_tpu_torch.traces",
    "ksim_tpu_torch.traces.schema",
    "ksim_tpu_torch.traces.registry",
    "ksim_tpu_torch.traces.resample",
    "ksim_tpu_torch.traces.borg",
    "ksim_tpu_torch.traces.alibaba",
    "ksim_tpu_torch.traces.compile",
    "ksim_tpu_torch.traces.stream",
    "ksim_tpu_torch.scenario.spec",
    "ksim_tpu_torch.scenario.simulation",
    "ksim_tpu_torch.state.snapshot",
    # The ninth slice: the samples, the webhook extenders.
    "ksim_tpu_torch.plugins.samples",
    "ksim_tpu_torch.plugins.samples.nodenumber",
    "ksim_tpu_torch.plugins.samples.lifecycle",
    "ksim_tpu_torch.scheduler.extender",
)


def test_port_imports_with_jax_and_ksim_tpu_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(forbidden=set(FORBIDDEN), modules=SLICE_MODULES)],
        cwd=ROOT,
        env=sanitized_cpu_env(),
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


_BUILDER_IMPORT = """
import sys
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import ClusterStore
from ksim_tpu_torch.scenario.generate import make_node, make_pod

store = ClusterStore()
store.create("nodes", make_node("node-3", cpu="8", memory="16Gi"))
store.create("nodes", make_node("node-7", cpu="8", memory="16Gi"))
store.create("pods", make_pod("app-7", cpu="100m", memory="128Mi"))
cfg = {"profiles": [{
    "plugins": {"multiPoint": {"enabled": [{"name": "NodeNumber", "weight": 100}]}},
    "pluginConfig": [{"name": "NodeNumber", "args": {
        "builderImport": "ksim_tpu_torch.plugins.samples.nodenumber:NODE_NUMBER_PLUGIN"}}],
}]}
placed = SchedulerService(store, config=cfg, device="cpu").schedule_pending()
assert placed == {"default/app-7": "node-7"}, placed
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ksim_tpu"))
assert not loaded, loaded
print("ok")
"""


def test_builder_import_of_the_port_sample_loads_no_ksim_tpu():
    """A KubeSchedulerConfiguration that loads the port's NodeNumber by
    ``builderImport`` schedules with it, and no module of ksim_tpu (or
    jax) is in ``sys.modules`` afterwards."""
    proc = subprocess.run(
        [sys.executable, "-c", _BUILDER_IMPORT], cwd=ROOT, env=sanitized_cpu_env(), capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_ksim_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def _snapshot():
    feats = Featurizer().featurize(*random_cluster(0, 12, 20))
    return feats, default_plugins(feats)


def test_engine_defaults_to_cuda_and_never_falls_back():
    feats, plugins = _snapshot()
    if torch.cuda.is_available():
        assert Engine(feats, plugins).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(feats, plugins)


def test_cpu_tensors_take_the_plain_versions_without_launches():
    feats, plugins = _snapshot()
    before = schedule_scan.launches, batch_eval.launches, schedule_sampled.launches
    eng = Engine(feats, plugins, record="full", device="cpu")
    res, _ = eng.schedule()
    eng.evaluate_batch()
    sampled, _ = Engine(feats, plugins, record="full", device="cpu", sampling_k=4).schedule()
    assert (res.selected[:20] >= 0).any() and sampled.visited.any()
    assert (schedule_scan.launches, batch_eval.launches, schedule_sampled.launches) == before


def test_other_devices_raise():
    feats, plugins = _snapshot()
    eng = Engine(feats, plugins, record="selection", device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        eng.schedule()
    with pytest.raises(ValueError, match="cpu or cuda"):
        eng.evaluate_batch()
    eng = Engine(feats, plugins, record="selection", device="meta", sampling_k=2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        eng.schedule()


def test_service_and_runner_need_a_card_unless_the_cpu_is_asked_for():
    from ksim_tpu_torch.scenario.runner import ScenarioRunner
    from ksim_tpu_torch.scheduler.service import SchedulerService
    from ksim_tpu_torch.state.cluster import ClusterStore

    if torch.cuda.is_available():
        assert SchedulerService(ClusterStore())._device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SchedulerService(ClusterStore())
        with pytest.raises(RuntimeError, match="CUDA"):
            ScenarioRunner()
    assert ScenarioRunner(device="cpu").service._device.type == "cpu"


def test_unported_surfaces_refuse(monkeypatch, tmp_path):
    from ksim_tpu_torch.scenario.runner import ScenarioRunner
    from ksim_tpu_torch.scheduler.service import SchedulerService
    from ksim_tpu_torch.state.cluster import ClusterStore

    store = ClusterStore()
    with pytest.raises(NotImplementedError, match="shard_mesh"):
        SchedulerService(store, shard_mesh=object(), device="cpu")
    # Scheduler extenders and the profiler are ported: a config with
    # extenders compiles, and a profiled pass writes a Chrome trace
    # holding its "scheduling-pass" range.
    svc = SchedulerService(store, config={"extenders": [{"urlPrefix": "http://localhost:1"}]}, device="cpu")
    assert len(svc.extender_service.extenders) == 1
    store.create("nodes", make_node("n1"))
    store.create("pods", make_pod("p1"))
    svc = SchedulerService(store, device="cpu")
    svc.start_profiling(str(tmp_path))
    assert svc.schedule_pending() == {"default/p1": "n1"}
    path = svc.stop_profiling()
    assert svc.stop_profiling() is None
    assert path is not None and str(tmp_path) in path and "scheduling-pass" in open(path).read()
    # Fleet replay is ported; its lane mesh (KSIM_FLEET_DP) is not.
    monkeypatch.setenv("KSIM_FLEET_DP", "2")
    with pytest.raises(NotImplementedError, match="KSIM_FLEET_DP"):
        ScenarioRunner(device="cpu", device_replay=True, fleet=2).run(iter(()))
    monkeypatch.delenv("KSIM_FLEET_DP")
    # A legacy per-pool volume-limit plugin compiles and schedules beside
    # NodeVolumeLimits, as in ksim_tpu: an EBS volume per pod on nodes
    # that attach one each.
    from ksim_tpu.scheduler.service import SchedulerService as JaxSchedulerService
    from ksim_tpu.state.cluster import ClusterStore as JaxClusterStore

    legacy = {"profiles": [{"plugins": {"multiPoint": {"enabled": [{"name": "EBSLimits"}, {"name": "GCEPDLimits"}]}}}]}
    placed = []
    for store_cls, service_cls, kw in ((ClusterStore, SchedulerService, {"device": "cpu"}),
                                       (JaxClusterStore, JaxSchedulerService, {})):
        store = store_cls()
        for i in range(2):
            store.create("nodes", make_node(f"n{i}", extra_alloc={"attachable-volumes-aws-ebs": "1"}))
        for i in range(3):
            pod = make_pod(f"p{i}")
            pod["spec"]["volumes"] = [{"name": "d", "awsElasticBlockStore": {"volumeID": f"vol-{i}"}}]
            store.create("pods", pod)
        placed.append(service_cls(store, config=legacy, **kw).schedule_pending())
    assert placed[0] == placed[1]
    assert sum(node is not None for node in placed[0].values()) == 2  # one attach slot per node

    class _Stream(list):
        streaming_ops = True

    # Streaming ingest is ported as the solo path; a fleet refuses a
    # streaming source, as ksim_tpu's runner does.
    with pytest.raises(ValueError, match="streaming"):
        ScenarioRunner(device="cpu", device_replay=True, fleet=2).run(_Stream())
