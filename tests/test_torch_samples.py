"""The score samples (NodeNumber, DataProviderScore) on the port against
ksim_tpu, on the CPU.

One ksim_tpu-featurized snapshot (with the samples' extra encoders) feeds
both engines: the whole default profile plus NodeNumber and two
DataProviderScore instances.  Every recorded tensor (reason codes, raw
scores, finals, totals, selections, and under sampling the visited
nodes) must be equal element for element, tolerance 0, in exact and f32
modes, through the plain versions of kernels A (``schedule``), C (the
sampled ``schedule``) and B (``evaluate_batch``, ``evaluate_batch_fused``).
A 300-event churn with NodeNumber then holds kernel D's plain version
against ksim_tpu's ``_segment_fn`` and its solo and fleet runs.  The
kernels' own sample rows are held against these plain versions on the
card (tests/test_torch_gpu.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.engine.profiles import default_plugins as jax_default_plugins
from ksim_tpu.plugins.samples import data_provider_builder as jax_data_provider_builder
from ksim_tpu.plugins.samples import encode_node_number as jax_encode_node_number
from ksim_tpu.plugins.samples import node_number_builder as jax_node_number_builder
from ksim_tpu.plugins.samples import provider_encoder as jax_provider_encoder
from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu.scenario import churn_scenario as jax_churn
from ksim_tpu.scheduler.service import SchedulerService as JaxService
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.engine.core import Engine, kernel_refusal
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.kernels.replay_segment import replay_segment
from ksim_tpu_torch.plugins.samples import data_provider_builder, node_number_builder
from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scenario.runner import ScenarioRunner
from ksim_tpu_torch.state.featurizer import snapshot_from_arrays
from test_torch_clusters import PROVIDERS, provider_fn, sample_cluster
from tests.test_torch_engine import assert_results_equal, assert_states_equal, x64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def sample_engines(record: str, exact: bool, *, reverse: bool, sampling_k=None):
    """(ksim_tpu Engine, port Engine) on one ksim_tpu-featurized snapshot
    of ``sample_cluster``: the default profile, NodeNumber (weight 3) and
    the two providers (weights 2 and 1).  Build under ``x64(exact)``."""
    nodes, pods = sample_cluster()
    enc = {"nodenumber": jax_encode_node_number}
    enc.update({f"provider:{n}": jax_provider_encoder(provider_fn(n)) for n in PROVIDERS})
    jf = JaxFeaturizer(extra_encoders=enc).featurize(nodes, pods)
    tf = snapshot_from_arrays(jf)
    j_extra = (jax_node_number_builder(reverse=reverse, weight=3)(jf, {}),) + tuple(
        jax_data_provider_builder(n, provider_fn(n), weight=w)(jf, {}) for n, w in zip(PROVIDERS, (2, 1))
    )
    t_extra = (node_number_builder(reverse=reverse, weight=3)(tf, {}),) + tuple(
        data_provider_builder(n, provider_fn(n), weight=w)(tf, {}) for n, w in zip(PROVIDERS, (2, 1))
    )
    ref = JaxEngine(jf, jax_default_plugins(jf) + j_extra, record=record, sampling_k=sampling_k)
    port = Engine(tf, default_plugins(tf) + t_extra, record=record, exact=exact, device="cpu",
                  sampling_k=sampling_k)
    return ref, port


def test_sample_cluster_exercises_every_branch():
    nodes, pods = sample_cluster()
    _, port = sample_engines("full", True, reverse=False)
    nn = port._feats.aux["nodenumber"]
    assert (nn.node_digit[: len(nodes)] == -1).any() and (nn.node_digit[: len(nodes)] >= 0).any()
    assert (nn.pod_digit == -1).any() and (nn.pod_digit >= 0).any()
    carbon = port._feats.aux["provider:Carbon"].provided_score
    assert (carbon < 0).any() and (carbon > 100).any()
    assert kernel_refusal(port._plugins) is None  # the samples have kernel code
    assert {chain.sample_id(sp.plugin) for sp in port._prog.scores} >= {14, 15}


@pytest.mark.parametrize(
    "exact, reverse, paths",
    [(True, False, ("scan", "batch")), (False, True, ("sampled", "fused"))],
    ids=["exact", "f32-reverse"],
)
def test_samples_schedule_and_batch_match_reference(exact, reverse, paths):
    """Kernel A's, C's and B's plain versions with the sample rows, every
    record tensor and the committed state: in exact mode the whole
    queue's scan and the chunked batch evaluation (record="full"), in f32
    mode with NodeNumber reversed the sampled scan (record="full") and the
    fused batch evaluation (record="final").  Each mode compiles two of
    ksim_tpu's programs, which is what this test's time goes to."""
    with x64(exact):
        if "scan" in paths:
            ref_engine, port = sample_engines("full", exact, reverse=reverse)
            ref, ref_state = ref_engine.schedule()
            ref_batch = ref_engine.evaluate_batch()
        else:
            ref_engine, port = sample_engines("full", exact, reverse=reverse, sampling_k=7)
            ref, ref_state = ref_engine.schedule(sampling_start=5)
            ref_f_engine, port_f = sample_engines("final", exact, reverse=reverse)
            ref_batch = ref_f_engine.evaluate_batch_fused(block=16)
    if "scan" in paths:
        got, state = port.schedule(chunk=24)
        batch = port.evaluate_batch(chunk=16)
    else:
        got, state = port.schedule(sampling_start=5)
        assert got.visited is not None
        batch = port_f.evaluate_batch_fused(block=16)
    assert_results_equal(ref, got)
    assert_states_equal(ref_state, state)
    assert_results_equal(ref_batch, batch)
    # The samples scored: NodeNumber both ways, the providers' finals
    # (negatives included) in the totals.
    si = got.plugin_names.index("NodeNumber")
    assert set(np.unique(got.scores[:, si])) == {0, 10}
    ci = got.plugin_names.index("Carbon")
    assert (got.final_scores[:, ci] < 0).any()
    assert got.final_scores.dtype == np.int32  # the samples declare no bound


# ---------------------------------------------------------------------------
# Kernel D: the churn with NodeNumber
# ---------------------------------------------------------------------------

CHURN = dict(n_nodes=40, n_events=300, ops_per_step=30)
KW = dict(max_pods_per_pass=1024, pod_bucket_min=128)
NN_CONFIG = {
    "profiles": [{
        "plugins": {"multiPoint": {"enabled": [{"name": "NodeNumber", "weight": 5}]}},
        "pluginConfig": [{"name": "NodeNumber", "args": {
            "builderImport": "{pkg}.plugins.samples.nodenumber:NODE_NUMBER_PLUGIN"}}],
    }]
}


def nn_config(pkg: str) -> dict:
    import copy

    cfg = copy.deepcopy(NN_CONFIG)
    arg = cfg["profiles"][0]["pluginConfig"][0]["args"]
    arg["builderImport"] = arg["builderImport"].format(pkg=pkg)
    return cfg


def _steps(res) -> list[tuple]:
    return [(s.step, s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


def _placements(store) -> dict:
    return {p["metadata"]["name"]: p["spec"].get("nodeName") for p in store.list("pods")}


def test_node_number_churn_kernel_d_matches_reference_and_fleet(monkeypatch):
    """A 300-event churn under a profile with NodeNumber: ksim_tpu's device
    replay (``_segment_fn``) and the port's (kernel D's plain version)
    agree step for step and pod for pod, with no per-pass fallback; the
    first lowered window's kernel-D plain run equals ``_segment_fn`` tensor
    for tensor; both fleet cohort modes equal the solo run on every lane."""
    from ksim_tpu.engine.replay import ReplayDriver as JaxReplayDriver
    from ksim_tpu_torch.engine.replay import ReplayDriver, segment_from_arrays
    from tests.test_torch_replay import _assert_equal, _reference_segment

    with x64(False):
        jstore = JaxStore()
        jsvc = JaxService(jstore, config=nn_config("ksim_tpu"), record="selection", preemption=False,
                          allow_plugin_imports=True, **KW)
        jrun = JaxRunner(store=jstore, service=jsvc, device_replay=True, device_segment_steps=8)
        ref = jrun.run(list(jax_churn(0, **CHURN)))
    port_kw = dict(KW, exact=False, device="cpu", config=nn_config("ksim_tpu_torch"), device_segment_steps=8)
    trun = ScenarioRunner(device_replay=True, **port_kw)
    got = trun.run(list(churn_scenario(0, **CHURN)))
    assert _steps(got) == _steps(ref)
    assert _placements(trun.store) == _placements(jstore)
    drv = trun.replay_driver
    assert drv.fallback_steps == 0 and drv.unsupported == {}, drv.unsupported
    assert drv.device_steps == jrun.replay_driver.device_steps == len(got.steps)
    enabled = {name for prof in trun.service._profiles.values() for name, _ in prof.enabled}
    assert "NodeNumber" in enabled

    # The first window, lowered by each package, through kernel D's plain
    # version against ksim_tpu's segment program (compiled by the run
    # above: the same statics).
    tr = ScenarioRunner(exact=False, device="cpu", config=nn_config("ksim_tpu_torch"), **KW)
    tby, tkeys = tr._group_by_step(list(churn_scenario(0, **CHURN)))
    with x64(False):
        jstore = JaxStore()
        jr = JaxRunner(store=jstore, service=JaxService(jstore, config=nn_config("ksim_tpu"), record="selection",
                                                        preemption=False, allow_plugin_imports=True, **KW))
        jby, jkeys = jr._group_by_step(list(jax_churn(0, **CHURN)))
        jplan = JaxReplayDriver(jr.store, jr.service, k=8).prepare_segment([jby[s] for s in jkeys[:8]])
        ref_state, ref_outs = _reference_segment(jplan)
    tplan = ReplayDriver(tr.store, tr.service, k=8).prepare_segment([tby[s] for s in tkeys[:8]])
    assert tplan.universe_keys == jplan.universe_keys
    taux = tplan.const["aux"]
    np.testing.assert_array_equal(taux["nodenumber"].pod_digit, jplan.aux["nodenumber"].pod_digit)
    np.testing.assert_array_equal(taux["nodenumber"].node_digit, jplan.aux["nodenumber"].node_digit)
    const, ev, state0 = segment_from_arrays(dict(jplan.const, aux=jplan.aux), jplan.ev, jplan.state0)
    assert "nodenumber" in const["aux"]
    final, outs = replay_segment(tplan.statics, tplan.prog, const, ev, state0)
    for key in outs:
        _assert_equal(ref_outs[key], outs[key], f"outs.{key}")
    for key in final:
        _assert_equal(ref_state[key], final[key], f"state.{key}")

    # The fleet, both cohort modes: every lane equals the solo run.
    for vmap in ("0", "1"):
        monkeypatch.setenv("KSIM_FLEET_VMAP", vmap)
        fleet_r = ScenarioRunner(device_replay=True, fleet=2, **port_kw)
        fleet_r.run(list(churn_scenario(0, **CHURN)))
        assert fleet_r.fleet_driver.stats()["lanes_on_device"] == 1.0
        for ln in fleet_r.fleet_lanes:
            assert _steps(ln.result) == _steps(got), (vmap, ln.idx)
            assert _placements(ln.runner.store) == _placements(trun.store), (vmap, ln.idx)
