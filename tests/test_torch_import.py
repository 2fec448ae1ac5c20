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

# The modules of the second and third slices, which the blocked import
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


def test_unported_surfaces_refuse():
    from ksim_tpu_torch.scenario.runner import ScenarioRunner
    from ksim_tpu_torch.scheduler.service import SchedulerService
    from ksim_tpu_torch.state.cluster import ClusterStore

    store = ClusterStore()
    with pytest.raises(NotImplementedError, match="extenders"):
        SchedulerService(store, config={"extenders": [{"urlPrefix": "http://localhost:1"}]}, device="cpu")
    with pytest.raises(NotImplementedError, match="shard_mesh"):
        SchedulerService(store, shard_mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="profiler"):
        SchedulerService(store, device="cpu").start_profiling("unused")
    with pytest.raises(NotImplementedError, match="fleet"):
        ScenarioRunner(device="cpu", device_replay=True, fleet=2)
    # A legacy per-pool volume-limit plugin compiles, and the Engine
    # refuses it: the kernels hold one NodeVolumeLimits instance.
    store = ClusterStore()
    store.create("nodes", make_node("n1"))
    store.create("pods", make_pod("p1"))
    legacy = {"profiles": [{"plugins": {"multiPoint": {"enabled": [{"name": "EBSLimits"}]}}}]}
    with pytest.raises(NotImplementedError, match="NodeVolumeLimits"):
        SchedulerService(store, config=legacy, device="cpu").schedule_pending()

    class _Stream(list):
        streaming_ops = True

    with pytest.raises(NotImplementedError, match="streaming"):
        ScenarioRunner(device="cpu").run(_Stream())
