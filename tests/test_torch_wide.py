"""Profiles past every width the kernels once held fixed, on the CPU: the
port's plain path against ksim_tpu, element for element (tolerance 0:
every output is an integer or a bool), in exact and f32 modes.

Each case widens one profile table on tests/test_torch_clusters.py
``wide_cluster``: 9 NodeResourcesFit score resources, 17
RequestedToCapacityRatio shape points, 9 BalancedAllocation resources, 17
NodeVolumeLimits pools, 17 spread topology keys, 9 constraints on one pod,
and the legacy per-pool EBSLimits and GCEPDLimits instances beside
NodeVolumeLimits; then all of them at once.  The kernels take the same tables as device arrays
(kernels/chain.py ``profile_tables``); tests/test_torch_gpu.py holds them
against these plain results on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ksim_tpu.engine.core as jax_core
import ksim_tpu.plugins.noderesources as jax_res
import ksim_tpu.plugins.volumes as jax_vol
from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.engine.profiles import default_plugins as jax_default_plugins
from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu.scheduler.service import SchedulerService as JaxService
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
import ksim_tpu_torch.engine.core as port_core
import ksim_tpu_torch.plugins.noderesources as port_res
import ksim_tpu_torch.plugins.volumes as port_vol
from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.state.featurizer import snapshot_from_arrays
from tests.test_torch_engine import assert_results_equal, assert_states_equal, x64
from test_torch_gpu_replay import store_view, wide_runner, wide_stream
from test_torch_clusters import WIDE_CASES, WIDE_CONFIG, WIDE_CONSTRAINTS, WIDE_KEYS, WIDE_POOLS, wide_cluster, wide_profile

torch.set_num_threads(1)

def wide_engines(case: str, record: str, exact: bool, seed: int = 0):
    """(ksim_tpu Engine, port Engine) on one ksim_tpu-featurized
    wide_cluster snapshot with the ``case`` profile.  Build under
    ``x64(exact)``."""
    nodes, pods, kw = wide_cluster(seed)
    jf = JaxFeaturizer().featurize(nodes, pods, **kw)
    tf = snapshot_from_arrays(jf)
    ref = JaxEngine(jf, wide_profile(case, jf, jax_core, jax_res, jax_vol, jax_default_plugins), record=record)
    port = Engine(tf, wide_profile(case, tf, port_core, port_res, port_vol, default_plugins), record=record,
                  exact=exact, device="cpu")
    return ref, port


def assert_wide(case: str, port) -> None:
    """The snapshot and profile really are past the old fixed width."""
    plugins = {sp.plugin.name: sp.plugin for sp in port._plugins}
    aux = port._aux
    if case in ("fit_resources", "all"):
        assert len(plugins["NodeResourcesFit"]._score_spec) == 9
    if case in ("fit_shape", "all"):
        assert len(plugins["NodeResourcesFit"]._shape) == 17
    if case in ("balanced_resources", "all"):
        assert len(plugins["NodeResourcesBalancedAllocation"]._spec) == 9
    if case == "volume_pools":
        assert len(plugins["NodeVolumeLimits"].pool_ids) >= WIDE_POOLS
        assert int(aux["volumes"]["attached_init"].sum()) > 0
    elif case == "spread_keys":
        assert len(plugins["PodTopologySpread"].tk_sizes) == WIDE_KEYS
    elif case == "spread_constraints":
        assert int(aux["spread"]["con_valid"][0].sum()) == WIDE_CONSTRAINTS
    elif case in ("legacy_volume_limits", "all"):
        tables = chain.profile_tables(port._prog, "cpu")
        assert tables["nvl_row"].tolist() == [
            i for i, sp in enumerate(port._prog.filters) if chain.is_volume_limits(sp.plugin)
        ]
        assert len(tables["nvl_row"]) == 3


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_profile_schedule_matches_reference(case, exact):
    with x64(exact):
        ref_engine, port = wide_engines(case, "full", exact)
        ref, ref_state = ref_engine.schedule()
    assert_wide(case, port)
    got, state = port.schedule(chunk=24)
    assert_results_equal(ref, got)
    assert_states_equal(ref_state, state)
    assert (got.selected >= 0).any()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_profile_batch_matches_reference(case, exact):
    with x64(exact):
        ref_engine, port = wide_engines(case, "full", exact)
        ref = ref_engine.evaluate_batch()
    assert_results_equal(ref, port.evaluate_batch(chunk=16))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_legacy_volume_limits_record_their_own_rows(exact):
    """EBSLimits and GCEPDLimits each record their own reason row, in the
    reference's filter order, and reject where their one pool is full."""
    with x64(exact):
        ref_engine, port = wide_engines("legacy_volume_limits", "full", exact)
        ref = ref_engine.evaluate_batch()
    got = port.evaluate_batch()
    assert got.filter_plugin_names == ref.filter_plugin_names
    names = got.filter_plugin_names
    assert names.index("EBSLimits") == names.index("NodeVolumeLimits") + 1
    for name in ("NodeVolumeLimits", "EBSLimits", "GCEPDLimits"):
        row = got.reason_bits[:, names.index(name)]
        np.testing.assert_array_equal(row, np.asarray(ref.reason_bits)[:, names.index(name)])
    assert got.reason_bits[:, names.index("NodeVolumeLimits")].any()


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_wide_config_device_path_matches_per_pass(exact):
    """The wide profile compiled from a KubeSchedulerConfiguration (9 Fit
    resources on a 17-point shape, 9 Balanced resources, EBSLimits and
    GCEPDLimits) over a churn of the wide nodes: the device path (kernel
    D's plain version here) equals the per-pass path step for step, and
    both equal ksim_tpu's service compiled from the same config, steps and
    stored pods alike: its device path in f32 mode, its per-pass path in
    exact mode (ksim_tpu's own device replay refuses this config under
    x64: its skipped-step branch keeps int32 raw scores where a step
    yields int64)."""
    dev = wide_runner("cpu", device_replay=True, exact=exact)
    res = dev.run(list(wide_stream()))
    per_pass = wide_runner("cpu", device_replay=False, exact=exact)
    base = per_pass.run(list(wide_stream()))
    with x64(exact):
        store = JaxStore()
        service = JaxService(store, config=WIDE_CONFIG, preemption=False, max_pods_per_pass=64, pod_bucket_min=16)
        ref_runner = JaxRunner(store=store, service=service, device_replay=not exact, device_segment_steps=4)
        ref = ref_runner.run(list(wide_stream()))
    steps = [(s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]
    assert steps == [(s.scheduled, s.unschedulable, s.pending_after) for s in base.steps]
    assert steps == [(s.scheduled, s.unschedulable, s.pending_after) for s in ref.steps]
    assert store_view(dev) == store_view(per_pass) == store_view(ref_runner)
    assert res.pods_scheduled > 0
    assert dev.replay_driver.device_steps >= 8, dev.replay_driver.unsupported
    enabled = {name for prof in dev.service._profiles.values() for name, _ in prof.enabled}
    assert {"EBSLimits", "GCEPDLimits"} <= enabled
