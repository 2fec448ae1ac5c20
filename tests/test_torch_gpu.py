"""Kernels A (schedule_scan), B (batch_eval, and its pre-pass
node_summary) and C (schedule_sampled) against their plain PyTorch
versions on a CUDA device, element for element (tolerance 0), at small
size, with the whole default profile and with the wide profile (every
profile table past its old fixed width, EBSLimits and GCEPDLimits beside
NodeVolumeLimits; kernel D on it through a churn).  Kernels A and C run on
a thread-block cluster: their tests run at cluster sizes 2, 8 and 16
(kernels/chain.py CLUSTER_SIZE); kernel B's persistent grid at forced
sizes (kernels/batch_eval.py GRID) and past the old node bound.  The
score samples' rows (NodeNumber, DataProviderScore) in A, B, C and D, and
the refusal of a hooked profile on the card.

Marked ``gpu``; each test skips when there is no CUDA device.  This file
imports neither jax nor ksim_tpu, so it runs on a machine with a card
and without jax:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.kernels import chain
import ksim_tpu_torch.engine.core as port_core
import ksim_tpu_torch.plugins.noderesources as port_res
import ksim_tpu_torch.plugins.volumes as port_vol
from ksim_tpu_torch.kernels import batch_eval as batch_mod
from ksim_tpu_torch.kernels import replay_segment as segment_mod
from ksim_tpu_torch.kernels.batch_eval import batch_eval, batch_eval_plain, node_summary, node_summary_plain
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled, schedule_sampled_plain
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan, schedule_scan_plain
from ksim_tpu_torch.state.featurizer import Featurizer
from helpers import random_cluster
from test_torch_clusters import case_inputs, wide_cluster, wide_profile
from test_torch_gpu_replay import _assert_plain_equal, _capture, _steps, wide_runner, wide_stream

pytestmark = pytest.mark.gpu

FIELDS = ("selected", "total", "final_scores", "reason_bits", "scores", "visited")


class PlainEngine(Engine):
    """The same engine running the kernels' plain versions on the card."""

    _scan_fn = staticmethod(schedule_scan_plain)
    _sampled_fn = staticmethod(schedule_sampled_plain)
    _batch_fn = staticmethod(batch_eval_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


CLUSTERS = [2, 8, 16]


@pytest.fixture(params=CLUSTERS, ids=[f"cs{c}" for c in CLUSTERS])
def cluster(request, monkeypatch):
    """Kernels A and C on a cluster of this many blocks."""
    monkeypatch.setattr(chain, "CLUSTER_SIZE", request.param)
    return request.param


def _pair(case, record, exact, device, sampling_k=None):
    nodes, pods, kw = case_inputs(case)
    feats = Featurizer().featurize(nodes, pods, **kw)
    plugins = default_plugins(feats)
    kw = dict(record=record, exact=exact, device=device, sampling_k=sampling_k)
    return Engine(feats, plugins, **kw), PlainEngine(feats, plugins, **kw)


def _assert_equal(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.sampling_next_start == b.sampling_next_start


CASES = ["seed0", "images_ports", "unschedulable", "ports_commit", "spread_affinity", "volumes"]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("record", ["full", "final", "selection"])
@pytest.mark.parametrize("case", CASES)
def test_schedule_scan_kernel_matches_plain(cuda, cluster, case, record, exact):
    kernel, plain = _pair(case, record, exact, cuda)
    before = schedule_scan.launches
    got, state = kernel.schedule(chunk=16)
    assert schedule_scan.launches > before and schedule_scan.last["cluster"] == cluster
    want, want_state = plain.schedule(chunk=16)
    _assert_equal(got, want)
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name), getattr(want_state, name), err_msg=name)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", ["seed1", "images_ports", "spread_affinity2", "volumes2"])
def test_batch_eval_kernel_matches_plain(cuda, case, exact):
    kernel, plain = _pair(case, "full", exact, cuda)
    before = batch_eval.launches
    got = kernel.evaluate_batch(chunk=16)
    assert batch_eval.launches > before
    _assert_equal(got, plain.evaluate_batch(chunk=16))
    kernel, plain = _pair(case, "final", exact, cuda)
    _assert_equal(kernel.evaluate_batch_fused(), plain.evaluate_batch_fused())


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("record", ["full", "selection"])
@pytest.mark.parametrize("case,k,start", [
    ("seed0", 7, 5), ("seed0", 40, -3), ("spread_affinity", 5, 100), ("volumes", 3, 2),
])
def test_schedule_sampled_kernel_matches_plain(cuda, cluster, case, k, start, record, exact):
    kernel, plain = _pair(case, record, exact, cuda, sampling_k=k)
    before = schedule_sampled.launches
    got, state = kernel.schedule(chunk=16, sampling_start=start)
    assert schedule_sampled.launches > before and schedule_sampled.last["cluster"] == cluster
    want, want_state = plain.schedule(chunk=16, sampling_start=start)
    _assert_equal(got, want)
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name), getattr(want_state, name), err_msg=name)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_kernels_with_global_domain_scratch_match_plain(cuda, cluster, exact, monkeypatch):
    """PodTopologySpread's per-domain scratch in global memory (where it
    outgrows its shared-memory budget) instead of shared memory: for the
    cluster kernels, every block's partial rows, summed across the
    cluster."""
    monkeypatch.setattr(chain, "DOMAIN_SMEM_BYTES", 0)
    kernel, plain = _pair("spread_affinity", "full", exact, cuda)
    _assert_equal(kernel.schedule(chunk=16)[0], plain.schedule(chunk=16)[0])
    _assert_equal(kernel.evaluate_batch(chunk=16), plain.evaluate_batch(chunk=16))
    kernel, plain = _pair("spread_affinity", "full", exact, cuda, sampling_k=6)
    _assert_equal(kernel.schedule(sampling_start=9)[0], plain.schedule(sampling_start=9)[0])


def _scan_both(cuda, case, record, exact, sampling_k=None, start=0):
    nodes, pods, kw = case_inputs(case)
    feats = Featurizer().featurize(nodes, pods, **kw)
    plugins = default_plugins(feats)
    kw = dict(record=record, exact=exact, device=cuda, sampling_k=sampling_k)
    kernel, plain = Engine(feats, plugins, **kw), PlainEngine(feats, plugins, **kw)
    got, state = kernel.schedule(sampling_start=start)
    want, want_state = plain.schedule(sampling_start=start)
    _assert_equal(got, want)
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name), getattr(want_state, name), err_msg=name)
    return feats, got


@pytest.mark.parametrize("record", ["full", "selection"])
@pytest.mark.parametrize("case,threads", [
    ("ports_commit", 0),  # 8 padded nodes: fewer than a block's threads, and than 16 blocks
    ("seed2", 0),  # 32 padded nodes: not a multiple of a 16-block cluster's chunks
    ("seed0", 64),  # a tile wider than the node axis
    ("spread_affinity", 32),  # several tiles: each thread owns more than one node slot
])
def test_cluster_scan_on_small_and_ragged_node_axes(cuda, cluster, case, threads, record, monkeypatch):
    monkeypatch.setattr(chain, "CLUSTER_THREADS", threads)
    feats, _ = _scan_both(cuda, case, record, True)
    _scan_both(cuda, case, record, True, sampling_k=min(3, len(feats.nodes.names)), start=5)


@pytest.mark.parametrize("sampled", [False, True], ids=["A", "C"])
def test_padding_pods_under_selection_cost_no_chain(cuda, cluster, sampled):
    """Under record="selection" a padding pod records -1 and is never
    evaluated (the kernel counts the pods it evaluates); under "full" every
    row is evaluated."""
    wrapper = schedule_sampled if sampled else schedule_scan
    k = 5 if sampled else None
    feats, got = _scan_both(cuda, "seed1", "selection", False, sampling_k=k)  # 50 pods padded to 64
    n_pods = len(feats.pods.keys)
    assert n_pods < feats.pods.valid.shape[0]
    assert (got.selected[n_pods:] == -1).all()
    assert int(wrapper.last["stats"][1]) == n_pods
    _scan_both(cuda, "seed1", "full", False, sampling_k=k)
    assert int(wrapper.last["stats"][1]) == feats.pods.valid.shape[0]


@pytest.mark.parametrize("record", ["full", "selection"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_sampled_k_above_the_feasible_count_and_a_start_near_the_wrap(cuda, cluster, record, exact):
    """Most nodes cordoned: fewer than k feasible nodes, so every real node
    is visited; the start one node before the wrap."""
    nodes, _, _ = case_inputs("unschedulable")
    n_real, k = len(nodes), len(nodes) - 2
    _, got = _scan_both(cuda, "unschedulable", record, exact, sampling_k=k, start=n_real - 1)
    if record == "full":
        few = (got.reason_bits[:, :, :n_real] == 0).all(axis=1).sum(axis=1) < k
        assert few.sum() > 0 and got.visited[few, :n_real].all()


def test_refused_cluster_launch_raises(cuda, monkeypatch):
    """A cluster the kernel does not take is refused by the launch and
    raises; nothing smaller or plain runs in its place."""
    monkeypatch.setattr(chain, "MAX_CLUSTER", 32)
    monkeypatch.setattr(chain, "CLUSTER_SIZE", 32)
    kernel, _ = _pair("seed0", "selection", True, cuda)
    before = schedule_scan.launches
    with pytest.raises(RuntimeError, match="ksim_schedule_scan: CUDA error"):
        kernel.schedule()
    assert schedule_scan.launches == before


def test_main_path_cluster_is_at_least_eight_blocks(cuda, monkeypatch):
    """With no size asked for, the launch takes 16 blocks where the card
    has room for such a cluster, else 8."""
    monkeypatch.setattr(chain, "CLUSTER_SIZE", 0)
    kernel, plain = _pair("seed0", "selection", True, cuda)
    _assert_equal(kernel.schedule()[0], plain.schedule()[0])
    assert schedule_scan.last["cluster"] in (8, 16)


def _engines(feats, plugins, record, exact, device, sampling_k=None):
    kw = dict(record=record, exact=exact, device=device, sampling_k=sampling_k)
    return Engine(feats, plugins, **kw), PlainEngine(feats, plugins, **kw)


@pytest.mark.parametrize("case", ["seed0", "images_ports", "spread_affinity", "volumes", "wide"])
def test_node_summary_kernel_matches_plain(cuda, case):
    """The pre-pass's words, attach room, added preference sums and flags
    equal node_summary_plain's."""
    if case == "wide":
        nodes, pods, kw = wide_cluster(0)
        feats = Featurizer().featurize(nodes, pods, **kw)
        plugins = wide_profile("all", feats, port_core, port_res, port_vol, default_plugins)
    else:
        nodes, pods, kw = case_inputs(case)
        feats = Featurizer().featurize(nodes, pods, **kw)
        plugins = default_plugins(feats)
    eng = Engine(feats, plugins, record="full", device=cuda)
    prog, state, aux = eng._prog, eng._node_state, eng._aux
    carries = prog.init_carries(aux)
    before = node_summary.launches
    got = node_summary(prog, state, aux, carries)
    assert node_summary.launches == before + 1
    want = node_summary_plain(prog, state, aux, carries)
    for key in want:
        assert (got[key] is None) == (want[key] is None), key
        if want[key] is not None:
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("grid", [0, 1, 7, 64, 1000])
@pytest.mark.parametrize("record", ["full", "final", "selection"])
def test_batch_eval_persistent_grid_matches_plain(cuda, grid, record, monkeypatch):
    """Block b of the grid takes pods b, b + grid, ...: at the resident
    grid (0) and forced grids below, equal to (64) and above the pod
    count, on 64- and 50-pod chunks (not a multiple of 7)."""
    monkeypatch.setattr(batch_mod, "GRID", grid)
    kernel, plain = _pair("seed1", record, True, cuda)
    if record == "full":
        _assert_equal(kernel.evaluate_batch(chunk=50), plain.evaluate_batch(chunk=50))
    else:
        _assert_equal(kernel.evaluate_batch_fused(), plain.evaluate_batch_fused())
    last = batch_mod.batch_eval.last
    assert last["grid"] == grid if grid else 1 <= last["grid"] <= last["blocks_per_sm"] * last["sms"]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_batch_eval_past_the_old_node_bound(cuda, exact):
    """A padded node axis of 24,576 (above the one-block bound of about
    17,590 nodes): the node arrays in global memory, every record equal to
    the plain version."""
    nodes, pods = random_cluster(0, 20_000, 40)
    feats = Featurizer().featurize(nodes, pods)
    assert feats.nodes.valid.shape[0] > 17_590
    kernel, plain = _engines(feats, default_plugins(feats), "full", exact, cuda)
    _assert_equal(kernel.evaluate_batch(chunk=32), plain.evaluate_batch(chunk=32))
    assert batch_mod.batch_eval.last["smem_bytes"] < 5 * feats.nodes.valid.shape[0]  # no node array in it
    kernel, plain = _engines(feats, default_plugins(feats), "final", exact, cuda)
    _assert_equal(kernel.evaluate_batch_fused(), plain.evaluate_batch_fused())


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_wide_profile_kernels_match_plain(cuda, cluster, exact):
    """Kernels A, B and C on wide_cluster with every profile table past its
    old fixed width (9 Fit resources on a 17-point shape, 9 Balanced
    resources, 17 attach pools, 17 spread keys, 9 constraints on one pod)
    and EBSLimits and GCEPDLimits beside NodeVolumeLimits."""
    nodes, pods, kw = wide_cluster(0)
    feats = Featurizer().featurize(nodes, pods, **kw)
    plugins = wide_profile("all", feats, port_core, port_res, port_vol, default_plugins)
    kernel, plain = _engines(feats, plugins, "full", exact, cuda)
    got, state = kernel.schedule(chunk=16)
    want, want_state = plain.schedule(chunk=16)
    _assert_equal(got, want)
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name), getattr(want_state, name), err_msg=name)
    _assert_equal(kernel.evaluate_batch(chunk=16), plain.evaluate_batch(chunk=16))
    kernel, plain = _engines(feats, plugins, "full", exact, cuda, sampling_k=5)
    got, state = kernel.schedule(chunk=16, sampling_start=3)
    _assert_equal(got, plain.schedule(chunk=16, sampling_start=3)[0])


def test_wide_config_kernel_d_matches_plain(cuda, monkeypatch):
    """Kernel D over the wide churn with the wide profile compiled from a
    KubeSchedulerConfiguration: every segment equal to D's plain version,
    the run equal to the per-pass path's."""
    segments = _capture(monkeypatch)
    runner = wide_runner(cuda, device_replay=True)
    res = runner.run(list(wide_stream()))
    assert runner.replay_driver.device_steps >= 8, runner.replay_driver.unsupported
    assert segment_mod.replay_segment.launches > 0
    _assert_plain_equal(segments)
    base = wide_runner("cpu", device_replay=False).run(list(wide_stream()))
    assert _steps(res) == _steps(base)


# ---------------------------------------------------------------------------
# The score samples' rows (NodeNumber, DataProviderScore) and the refusal
# of a hooked profile.
# ---------------------------------------------------------------------------


def _sample_engines(record, exact, device, *, reverse, sampling_k=None, cls=Engine):
    from ksim_tpu_torch.plugins.samples import (
        data_provider_builder, encode_node_number, node_number_builder, provider_encoder,
    )
    from test_torch_clusters import PROVIDERS, provider_fn, sample_cluster

    enc = {"nodenumber": encode_node_number}
    enc.update({f"provider:{n}": provider_encoder(provider_fn(n)) for n in PROVIDERS})
    feats = Featurizer(extra_encoders=enc).featurize(*sample_cluster())
    plugins = default_plugins(feats) + (node_number_builder(reverse=reverse, weight=3)(feats, {}),) + tuple(
        data_provider_builder(n, provider_fn(n), weight=w)(feats, {}) for n, w in zip(PROVIDERS, (2, 1))
    )
    kw = dict(record=record, exact=exact, device=device, sampling_k=sampling_k)
    return cls(feats, plugins, **kw), PlainEngine(feats, plugins, **kw)


@pytest.mark.parametrize("reverse", [False, True], ids=["plain", "reverse"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_sample_rows_kernels_match_plain(cuda, cluster, exact, reverse):
    """Kernels A, C and B with NodeNumber and two DataProviderScore
    instances: every record equal to the plain versions on the card."""
    launches = schedule_scan.launches, schedule_sampled.launches, batch_eval.launches
    kernel, plain = _sample_engines("full", exact, cuda, reverse=reverse)
    got, state = kernel.schedule(chunk=24)
    want, want_state = plain.schedule(chunk=24)
    _assert_equal(got, want)
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name), getattr(want_state, name), err_msg=name)
    _assert_equal(kernel.evaluate_batch(chunk=16), plain.evaluate_batch(chunk=16))
    kernel, plain = _sample_engines("full", exact, cuda, reverse=reverse, sampling_k=7)
    _assert_equal(kernel.schedule(sampling_start=5)[0], plain.schedule(sampling_start=5)[0])
    for record in ("final", "selection"):
        kernel, plain = _sample_engines(record, exact, cuda, reverse=reverse)
        _assert_equal(kernel.evaluate_batch_fused(), plain.evaluate_batch_fused())
        _assert_equal(kernel.schedule()[0], plain.schedule()[0])
    now = schedule_scan.launches, schedule_sampled.launches, batch_eval.launches
    assert all(b > a for a, b in zip(launches, now))


def test_node_number_churn_kernel_d_matches_plain(cuda, monkeypatch):
    """Kernel D over a churn under a profile with NodeNumber: every
    segment equal to its plain version, the run equal to the per-pass
    path's."""
    from ksim_tpu_torch.scenario.generate import churn_scenario
    from ksim_tpu_torch.scenario.runner import ScenarioRunner

    cfg = {"profiles": [{
        "plugins": {"multiPoint": {"enabled": [{"name": "NodeNumber", "weight": 5}]}},
        "pluginConfig": [{"name": "NodeNumber", "args": {
            "builderImport": "ksim_tpu_torch.plugins.samples.nodenumber:NODE_NUMBER_PLUGIN"}}],
    }]}
    kw = dict(max_pods_per_pass=1024, pod_bucket_min=128, exact=False, config=cfg)
    ops = list(churn_scenario(0, n_nodes=200, n_events=1200, ops_per_step=60))
    segments = _capture(monkeypatch)
    runner = ScenarioRunner(device_replay=True, device_segment_steps=8, device=cuda, **kw)
    res = runner.run(list(ops))
    assert runner.replay_driver.fallback_steps == 0, runner.replay_driver.unsupported
    _assert_plain_equal(segments)
    base = ScenarioRunner(device="cpu", **kw).run(list(ops))
    assert _steps(res) == _steps(base)


def test_hooked_profile_is_refused_on_the_card(cuda):
    """A profile with a device hook raises NotImplementedError on the card
    before any launch (no kernel runs a Python hook); the CPU runs it, and
    the profile without the hook stays on the kernels."""
    from ksim_tpu_torch.engine.core import PluginExtender, ScoredPlugin

    feats = Featurizer().featurize(*random_cluster(3, 40, 64))
    ext = PluginExtender(after_score=lambda state, pods, aux, scores: scores + 7)
    plugins = tuple(
        ScoredPlugin(sp.plugin, sp.weight, sp.filter_enabled, sp.score_enabled,
                     extender=ext if sp.plugin.name == "NodeResourcesFit" else None)
        for sp in default_plugins(feats)
    )
    launches = schedule_scan.launches, batch_eval.launches
    with pytest.raises(NotImplementedError, match="device='cpu'"):
        Engine(feats, plugins, record="full", device=cuda)
    Engine(feats, plugins, record="full", device="cpu").evaluate_batch()
    assert (schedule_scan.launches, batch_eval.launches) == launches
    Engine(feats, default_plugins(feats), device=cuda).schedule()
    assert schedule_scan.launches > launches[0]


def test_lifecycle_markers_stay_on_the_kernels(cuda, tmp_path):
    """A profile with FifoSort, NamePrefixGate and PlacementExport (no
    filter, no score) schedules through kernel A on the card."""
    from ksim_tpu_torch.scheduler.service import SchedulerService
    from ksim_tpu_torch.state.cluster import ClusterStore

    nodes, pods = random_cluster(1, 40, 32, bound_fraction=0.0)
    store = ClusterStore()
    for obj in nodes:
        store.create("nodes", obj)
    for obj in pods:
        store.create("pods", obj)
    lifecycle = "ksim_tpu_torch.plugins.samples.lifecycle:"
    cfg = {"profiles": [{
        "plugins": {"queueSort": {"enabled": [{"name": "FifoSort"}]},
                    "preEnqueue": {"enabled": [{"name": "NamePrefixGate"}]},
                    "postBind": {"enabled": [{"name": "PlacementExport"}]}},
        "pluginConfig": [
            {"name": "FifoSort", "args": {"builderImport": lifecycle + "FIFO_SORT_PLUGIN"}},
            {"name": "NamePrefixGate", "args": {"builderImport": lifecycle + "NAME_PREFIX_GATE_PLUGIN"}},
            {"name": "PlacementExport", "args": {"builderImport": lifecycle + "PLACEMENT_EXPORT_PLUGIN",
                                                 "sinkPath": str(tmp_path / "binds.jsonl")}},
        ],
    }]}
    before = schedule_scan.launches
    placed = SchedulerService(store, config=cfg, device=cuda).schedule_pending()
    assert schedule_scan.launches > before
    bound = sum(v is not None for v in placed.values())
    assert bound > 0 and len((tmp_path / "binds.jsonl").read_text().splitlines()) == bound


def test_job_on_the_card_matches_the_cpu(cuda, tmp_path):
    """A small solo device-replay job through ``JobManager(device="cuda")``
    (kernel D per segment) ends with the same result document as the same
    job on ``device="cpu"``, but for its times and its kernel evidence,
    and journals the same checkpoint records: store, service carries and
    the per-step results, segment for segment."""
    import json

    from ksim_tpu_torch.jobs import JobJournal, JobManager
    from ksim_tpu_torch.jobs.journal import JOURNAL_NAME
    from ksim_tpu_torch.scenario.generate import churn_scenario
    from ksim_tpu_torch.scenario.spec import spec_from_operations

    ops = list(churn_scenario(0, n_nodes=24, n_events=300, ops_per_step=8))
    doc = {"spec": {"simulator": {"deviceReplay": True, "podBucketMin": 64}, "scenario": spec_from_operations(ops)}}
    seen = {}
    for device in ("cuda", "cpu"):
        jm = JobManager(workers=1, queue_limit=4, jobs_dir=str(tmp_path / device), checkpoint_every=1, device=device)
        try:
            job = jm.submit(json.loads(json.dumps(doc)))
            assert job.wait_done(600)
            state, result, error = job.result_view()
            assert state == "succeeded", error
        finally:
            jm.shutdown()
        cks = [{k: v for k, v in r.items() if k != "ts"}
               for r in JobJournal(str(tmp_path / device / JOURNAL_NAME)).replay() if r["t"] == "checkpoint"]
        result["result"].pop("wallSeconds")
        seen[device] = (result["result"], result["replay"]["device_steps"], result["replay"]["unsupported"], cks)
    assert seen["cuda"] == seen["cpu"]
    assert len(seen["cuda"][3]) == 3 and seen["cuda"][3][-1]["result"]["steps"]
