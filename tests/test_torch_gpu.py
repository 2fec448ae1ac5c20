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
the refusal of a hooked profile on the card.  Kernel E's stages: E1, E2, E3
and E4's selection with each pod row on a cluster of 1, 2, 8 or 16
blocks or of the launch's choice (kernels/chain_stages.py
STAGE_CLUSTER), at 1, 7 and 256 pod rows (E1 and E2 with the domain
scratch in shared and in global memory, over several tiles of a
cluster; E3 and E4's selection with padding pods and a row with no
feasible node), the committing selection on one cluster of each size
over eight pods in a row, E4's visit window on one cluster of each size
(40 and 6144 nodes, the starts and k of the CPU sweep, six pods in a row
with the start carried; walks over several cluster tiles on clusters of
1, 2 and 8 blocks) and over E1's feasible sets, and a refused cluster
launch raising.

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
from ksim_tpu_torch.engine.staged import StagedProgram
from ksim_tpu_torch.kernels import chain, chain_stages
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
from test_torch_clusters import (
    WINDOW_CASES,
    case_inputs,
    hooked_profile,
    torch_hooks,
    wide_cluster,
    wide_profile,
    window_case,
    window_ok,
)
from test_torch_gpu_replay import _assert_plain_equal, _capture, _steps, wide_runner, wide_stream

pytestmark = pytest.mark.gpu

FIELDS = ("selected", "total", "final_scores", "reason_bits", "scores", "visited")


class PlainEngine(Engine):
    """The same engine running the kernels' plain versions on the card."""

    _scan_fn = staticmethod(schedule_scan_plain)
    _sampled_fn = staticmethod(schedule_sampled_plain)
    _batch_fn = staticmethod(batch_eval_plain)
    _stages = chain_stages.PLAIN_STAGES


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
    """No longer refused (the name is kept): a profile with device hooks
    (test_torch_clusters.torch_hooks: each alone on a plugin, all six on
    PodTopologySpread) builds on the card with the "staged" route and runs
    through kernel E, never kernels A-C: the scan, the sampled scan, the
    chunked and the fused batch equal the same profile through kernel E's
    plain versions on the card.  The profile without hooks stays on kernel
    A."""
    feats = Featurizer().featurize(*random_cluster(3, 40, 64))
    hooked = hooked_profile(default_plugins(feats), torch_hooks())
    fused = schedule_scan.launches, schedule_sampled.launches, batch_eval.launches
    chain_stages.reset_launches()
    for record, sampling_k in (("full", None), ("full", 5), ("final", None)):
        eng = Engine(feats, hooked, record=record, device=cuda, sampling_k=sampling_k)
        plain = PlainEngine(feats, hooked, record=record, device=cuda, sampling_k=sampling_k)
        assert eng.route == plain.route == "staged"
        got, state = eng.schedule(chunk=24, sampling_start=3 if sampling_k else 0)
        want, want_state = plain.schedule(chunk=24, sampling_start=3 if sampling_k else 0)
        _assert_equal(got, want)
        for name in state._fields:
            np.testing.assert_array_equal(getattr(state, name), getattr(want_state, name), err_msg=name)
        if sampling_k is None:
            batch = (lambda e: e.evaluate_batch(chunk=16)) if record == "full" else (
                lambda e: e.evaluate_batch_fused(block=16))
            _assert_equal(batch(eng), batch(plain))
    assert (schedule_scan.launches, schedule_sampled.launches, batch_eval.launches) == fused
    assert all(n > 0 for n in chain_stages.launches().values()), chain_stages.launches()
    Engine(feats, default_plugins(feats), device=cuda).schedule()
    assert schedule_scan.launches > fused[0]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", ["seed0", "images_ports", "spread_affinity", "volumes"])
def test_chain_stages_match_plain(cuda, case, exact):
    """Kernel E's stages E1-E4 against their plain versions on the same
    inputs, one stage at a time, over the whole default profile (one
    launch group per stage): every pod of the snapshot in E1-E3 and E4's
    selection, the visit window and the committing selection for the
    first pods, the committed state and carries."""
    nodes, pods, kw = case_inputs(case)
    feats = Featurizer().featurize(nodes, pods, **kw)
    eng = Engine(feats, default_plugins(feats), record="full", exact=exact, device=cuda)
    staged = StagedProgram(eng._prog)
    fsub, ssub = staged.filter_groups[0].sub, staged.score_groups[0].sub
    state, batch, aux = eng._node_state, eng._pods, eng._aux
    carries = eng._prog.init_carries(aux)
    view = batch.view()
    before = chain_stages.launches()

    codes, ok = chain_stages.filter_stage(fsub, state, view, aux, carries)
    want_codes, want_ok = chain_stages.filter_stage_plain(fsub, state, view, aux, carries)
    torch.testing.assert_close(codes, want_codes, rtol=0, atol=0)
    torch.testing.assert_close(ok, want_ok, rtol=0, atol=0)
    raw = chain_stages.score_stage(ssub, state, view, aux, carries, ok)
    torch.testing.assert_close(raw, chain_stages.score_stage_plain(ssub, state, view, aux, carries, ok), rtol=0, atol=0)
    norm = chain_stages.normalize_stage(ssub, state, view, aux, carries, raw, ok)
    torch.testing.assert_close(norm, chain_stages.normalize_stage_plain(ssub, state, view, aux, carries, raw, ok),
                               rtol=0, atol=0)
    P, N = ok.shape
    weights = torch.tensor([sp.weight for sp in eng._prog.scores], dtype=torch.int32, device=cuda)

    def outs(rows, final_dtype=torch.int16):
        return {"selected": torch.empty(rows, dtype=torch.int32, device=cuda),
                "total": torch.empty((rows, N), dtype=torch.int32, device=cuda),
                "final": torch.empty((rows, norm.shape[1], N), dtype=final_dtype, device=cuda)}

    got, want = outs(P), outs(P)
    chain_stages.select_stage(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, got)
    chain_stages.select_stage_plain(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, want)
    for key in got:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)

    n_real = int(feats.nodes.count)
    k_state, k_carries = chain.fresh_scan_state(eng._prog, state, carries)
    p_state, p_carries = chain.fresh_scan_state(eng._prog, state, carries)
    start_k = torch.tensor([n_real - 2], dtype=torch.int32, device=cuda)
    start_p = start_k.clone()
    for i in range(min(P, 8)):
        pod = batch.rows(i, i + 1)
        sample, visited, start_k = chain_stages.window_stage(ok[i:i + 1], start_k, pod.valid, n_real, 3)
        want_sample, want_visited, start_p = chain_stages.window_stage_plain(ok[i:i + 1], start_p, pod.valid,
                                                                             n_real, 3)
        torch.testing.assert_close(sample, want_sample, rtol=0, atol=0)
        torch.testing.assert_close(visited, want_visited, rtol=0, atol=0)
        torch.testing.assert_close(start_k, start_p, rtol=0, atol=0)
        got, want = outs(1), outs(1)
        chain_stages.select_stage(staged.commit_sub, k_state, pod, aux, k_carries, norm[i:i + 1], weights,
                                  ok[i:i + 1], got, commit=True)
        chain_stages.select_stage_plain(staged.commit_sub, p_state, pod, aux, p_carries, norm[i:i + 1], weights,
                                        ok[i:i + 1], want, commit=True)
        torch.testing.assert_close(got["selected"], want["selected"], rtol=0, atol=0)
    for name in k_state._fields:
        torch.testing.assert_close(getattr(k_state, name), getattr(p_state, name), rtol=0, atol=0)
    for name, want in p_carries.items():
        got = k_carries[name]
        for key in (want if isinstance(want, dict) else [None]):
            torch.testing.assert_close(got if key is None else got[key], want if key is None else want[key],
                                       rtol=0, atol=0)
    after = chain_stages.launches()
    assert all(after[k] > before[k] for k in after), after


STAGE_CLUSTERS = [0, 1, 2, 8, 16]
STAGE_CASES = ["seed0", "images_ports", "spread_affinity", "volumes", "seed1", "random700"]


def _stage_feats(case: str):
    """The featurized snapshot of a stage test case."""
    if case.startswith("random"):  # random700: 1024 padded nodes; random2100: 4096
        return Featurizer().featurize(*random_cluster(3, int(case[6:]), 64))
    nodes, pods, kw = case_inputs(case)
    return Featurizer().featurize(nodes, pods, **kw)


def _stage_inputs(case: str, exact: bool, rows: int, device):
    """E1's and E2's inputs over the whole default profile (one launch
    group each): ``rows`` pod rows cycling over the snapshot's pods,
    padding pods included where the snapshot has them (seed1: 50 pods
    padded to 64)."""
    feats = _stage_feats(case)
    eng = Engine(feats, default_plugins(feats), record="full", exact=exact, device=device)
    staged = StagedProgram(eng._prog)
    batch = eng._pods
    idx = torch.arange(rows, device=device) % batch.valid.shape[0]
    view = type(batch)(*(x[idx] for x in batch)).view()
    subs = (staged.filter_groups[0].sub, staged.score_groups[0].sub)
    return subs, eng._node_state, view, eng._aux, eng._prog.init_carries(eng._aux)


def _stages_equal(subs, state, view, aux, carries):
    """E1 and E2 against their plain versions (tolerance 0), and what each
    launch ran against kernels/chain.py's mirror of the launch; returns
    what each ran."""
    fsub, ssub = subs
    codes, ok = chain_stages.filter_stage(fsub, state, view, aux, carries)
    want_codes, want_ok = chain_stages.filter_stage_plain(fsub, state, view, aux, carries)
    torch.testing.assert_close(codes, want_codes, rtol=0, atol=0)
    torch.testing.assert_close(ok, want_ok, rtol=0, atol=0)
    raw = chain_stages.score_stage(ssub, state, view, aux, carries, ok)
    torch.testing.assert_close(raw, chain_stages.score_stage_plain(ssub, state, view, aux, carries, ok), rtol=0, atol=0)
    ran = chain_stages.filter_stage.last, chain_stages.score_stage.last
    for sub, last, stage in zip(subs, ran, ("filter", "score")):
        _ran_as_mirrored(sub, last, stage)
    return ran


def _ran_as_mirrored(sub, last: dict, stage: str) -> None:
    """What a cluster stage's launch ran is what kernels/chain.py's mirror
    of the launch says."""
    prm = sub.kernel_tables["stage_params"][1]
    assert last["threads"] == chain.stage_threads(prm.N, last["cluster"]), last
    assert last["smem_bytes"] == chain.stage_smem_bytes(prm, last["cluster"], stage), last


def _geometry_as_asked(last: dict, size: int, rows: int) -> None:
    """A forced size ran as forced; the launch's choice is 16 or 8 for one
    row and one block of 256 threads once the rows exceed half the SMs."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if size:
        assert last["cluster"] == size, last
    else:
        assert last["cluster"] <= chain.stage_cluster_cap(rows, sms), last
        assert rows > 1 or last["cluster"] in (8, 16), last
        assert 2 * rows <= sms or (last["cluster"], last["threads"]) == (1, 256), last


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("rows", [1, 7, 256])
@pytest.mark.parametrize("case", STAGE_CASES)
@pytest.mark.parametrize("size", STAGE_CLUSTERS, ids=[f"cs{c}" for c in STAGE_CLUSTERS])
def test_filter_and_score_stages_on_clusters_match_plain(cuda, size, case, rows, exact, monkeypatch):
    """E1 and E2 with each pod row on a cluster of 1, 2, 8 or 16 blocks,
    or of the size the launch chooses (cs0): 16 or 8 for one row, one
    block of 256 threads once the rows exceed half the card's SMs."""
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", size)
    for last in _stages_equal(*_stage_inputs(case, exact, rows, cuda)):
        _geometry_as_asked(last, size, rows)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("rows", [1, 7, 256])
@pytest.mark.parametrize("size", STAGE_CLUSTERS, ids=[f"cs{c}" for c in STAGE_CLUSTERS])
def test_filter_and_score_stages_with_global_domain_scratch_match_plain(cuda, size, rows, exact, monkeypatch):
    """PodTopologySpread's per-domain scratch in global memory: one row
    pair per (cluster, rank) of the launch."""
    monkeypatch.setattr(chain, "DOMAIN_SMEM_BYTES", 0)
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", size)
    subs, state, view, aux, carries = _stage_inputs("spread_affinity", exact, rows, cuda)
    _stages_equal(subs, state, view, aux, carries)
    for sub in subs:
        prm = sub.kernel_tables["stage_params"][1]
        assert prm.sp_smem == 0 and prm.MC * prm.DMAX > 0


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_filter_and_score_stages_with_several_tiles_per_cluster_match_plain(cuda, exact, monkeypatch):
    """4096 padded nodes on clusters of two blocks of 512 threads: each
    thread owns four node slots, one in each of the cluster's tiles."""
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", 2)
    for last in _stages_equal(*_stage_inputs("random2100", exact, 7, cuda)):
        assert (last["cluster"], last["threads"]) == (2, 512)


def test_refused_stage_cluster_launch_raises(cuda, monkeypatch):
    """A cluster E1 and E2 do not take is refused and raises; nothing
    smaller, one-block or plain runs in its place."""
    monkeypatch.setattr(chain, "MAX_CLUSTER", 32)
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", 32)
    (fsub, ssub), state, view, aux, carries = _stage_inputs("seed0", True, 1, cuda)
    before = chain_stages.launches()
    with pytest.raises(RuntimeError, match=r"ksim_chain_stages\(filter\): CUDA error"):
        chain_stages.filter_stage(fsub, state, view, aux, carries)
    ok = torch.ones((1, state.valid.shape[0]), dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match=r"ksim_chain_stages\(score\): CUDA error"):
        chain_stages.score_stage(ssub, state, view, aux, carries, ok)
    assert chain_stages.launches() == before


def _e34_inputs(case: str, exact: bool, rows: int, device):
    """E3's and E4 select's inputs over the whole default profile:
    ``rows`` pod rows cycling over the snapshot's pods (a PodBatch), the
    feasible set and the raw and normalized scores from the plain
    versions, the weights and the recorded final dtype."""
    feats = _stage_feats(case)
    eng = Engine(feats, default_plugins(feats), record="full", exact=exact, device=device)
    staged = StagedProgram(eng._prog)
    idx = torch.arange(rows, device=device) % eng._pods.valid.shape[0]
    batch = type(eng._pods)(*(x[idx] for x in eng._pods))
    state, aux = eng._node_state, eng._aux
    carries = eng._prog.init_carries(aux)
    fsub, ssub = staged.filter_groups[0].sub, staged.score_groups[0].sub
    ok = chain_stages.filter_stage_plain(fsub, state, batch.view(), aux, carries)[1]
    raw = chain_stages.score_stage_plain(ssub, state, batch.view(), aux, carries, ok)
    norm = chain_stages.normalize_stage_plain(ssub, state, batch.view(), aux, carries, raw, ok)
    weights = torch.tensor([sp.weight for sp in eng._prog.scores], dtype=torch.int32, device=device)
    return staged, state, batch, aux, carries, ok, raw, norm, weights, eng._prog.dtypes[1]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("rows", [1, 7, 256])
@pytest.mark.parametrize("case", STAGE_CASES)
@pytest.mark.parametrize("size", STAGE_CLUSTERS, ids=[f"cs{c}" for c in STAGE_CLUSTERS])
def test_normalize_and_select_stages_on_clusters_match_plain(cuda, size, case, rows, exact, monkeypatch):
    """E3 and E4's selection with each pod row on a cluster of 1, 2, 8 or
    16 blocks, or of the size the launch chooses (cs0), against their
    plain versions with tolerance 0: the normalized rows, the selection,
    the totals and the finals.  Padding pods come in where the snapshot
    has them (seed1 at 256 rows); with more than one row the last has no
    feasible node (it selects -1)."""
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", size)
    staged, state, batch, aux, carries, ok, raw, _, weights, final_dtype = _e34_inputs(case, exact, rows, cuda)
    if rows > 1:
        ok = ok.clone()
        ok[-1] = False
    ssub, view = staged.score_groups[0].sub, batch.view()
    norm = chain_stages.normalize_stage(ssub, state, view, aux, carries, raw, ok)
    want_norm = chain_stages.normalize_stage_plain(ssub, state, view, aux, carries, raw, ok)
    torch.testing.assert_close(norm, want_norm, rtol=0, atol=0)
    _ran_as_mirrored(ssub, chain_stages.normalize_stage.last, "normalize")
    _geometry_as_asked(chain_stages.normalize_stage.last, size, rows)
    N = ok.shape[1]
    got, want = ({"selected": torch.empty(rows, dtype=torch.int32, device=cuda),
                  "total": torch.empty((rows, N), dtype=torch.int32, device=cuda),
                  "final": torch.empty((rows, norm.shape[1], N), dtype=final_dtype, device=cuda)} for _ in range(2))
    chain_stages.select_stage(staged.commit_sub, state, batch, aux, carries, want_norm, weights, ok, got)
    chain_stages.select_stage_plain(staged.commit_sub, state, batch, aux, carries, want_norm, weights, ok, want)
    for key in got:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    if rows > 1:
        assert int(got["selected"][-1]) == -1
    _ran_as_mirrored(staged.commit_sub, chain_stages.select_stage.last, "select")
    _geometry_as_asked(chain_stages.select_stage.last, size, rows)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", STAGE_CASES)
@pytest.mark.parametrize("size", STAGE_CLUSTERS, ids=[f"cs{c}" for c in STAGE_CLUSTERS])
def test_committing_selection_on_clusters_matches_plain(cuda, size, case, exact, monkeypatch):
    """The scan's committing selection on one cluster of each size, eight
    pods in a row (each commit reads the last one's state), against
    select_stage_plain(commit=True): the selections, the node state, every
    carry and InterPodAffinity's term totals, which every case but
    "volumes" changes."""
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", size)
    staged, state, batch, aux, carries, ok, _, norm, weights, _ = _e34_inputs(case, exact, 8, cuda)
    k_state, k_carries = chain.fresh_scan_state(staged.prog, state, carries)
    p_state, p_carries = chain.fresh_scan_state(staged.prog, state, carries)
    total0 = p_carries["InterPodAffinity"]["total"].clone()
    for i in range(8):
        pod = batch.rows(i, i + 1)
        got, want = ({"selected": torch.empty(1, dtype=torch.int32, device=cuda)} for _ in range(2))
        chain_stages.select_stage(staged.commit_sub, k_state, pod, aux, k_carries, norm[i:i + 1], weights,
                                  ok[i:i + 1], got, commit=True)
        chain_stages.select_stage_plain(staged.commit_sub, p_state, pod, aux, p_carries, norm[i:i + 1], weights,
                                        ok[i:i + 1], want, commit=True)
        torch.testing.assert_close(got["selected"], want["selected"], rtol=0, atol=0)
        _ran_as_mirrored(staged.commit_sub, chain_stages.select_stage.last, "select")
        _geometry_as_asked(chain_stages.select_stage.last, size, 1)
    for name in k_state._fields:
        torch.testing.assert_close(getattr(k_state, name), getattr(p_state, name), rtol=0, atol=0)
    for name, want_c in p_carries.items():
        got_c = k_carries[name]
        for key in (want_c if isinstance(want_c, dict) else [None]):
            torch.testing.assert_close(got_c if key is None else got_c[key], want_c if key is None else want_c[key],
                                       rtol=0, atol=0)
    assert case == "volumes" or not torch.equal(p_carries["InterPodAffinity"]["total"], total0)


def _window_as_asked(last: dict, n_nodes: int, size: int) -> None:
    """The window ran one cluster of the forced size (or the launch's 16
    or 8 for one pod), as kernels/chain.py's mirror of the launch says."""
    prm = chain.ChainParams()
    prm.N = n_nodes
    assert last["threads"] == chain.stage_threads(n_nodes, last["cluster"]), last
    assert last["smem_bytes"] == chain.stage_smem_bytes(prm, last["cluster"], "window"), last
    _geometry_as_asked(last, size, 1)


def _windows_equal(oks, start: int, valid, n_real: int, k: int, cuda) -> None:
    """The window kernel against window_stage_plain over the pods of
    ``oks`` in a row, each from the start the last one left: sample,
    visited and the next start, exactly."""
    start_k = torch.tensor([start], dtype=torch.int32, device=cuda)
    start_p = start_k.clone()
    for i, ok in enumerate(oks):
        v = torch.tensor([valid[i]], device=cuda)
        got = chain_stages.window_stage(ok, start_k, v, n_real, k)
        want = chain_stages.window_stage_plain(ok, start_p, v, n_real, k)
        for part, a, b in zip(("sample", "visited", "next start"), got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=lambda m: f"pod {i} {part}: {m}")
        start_k, start_p = got[2], want[2]


@pytest.mark.parametrize("n_nodes, start, k", WINDOW_CASES, ids=[f"{n}-{s}-{k}" for n, s, k in WINDOW_CASES])
@pytest.mark.parametrize("size", STAGE_CLUSTERS, ids=[f"cs{c}" for c in STAGE_CLUSTERS])
def test_window_stage_on_clusters_matches_plain(cuda, size, n_nodes, start, k, monkeypatch):
    """E4's visit window on one cluster of 1, 2, 8 or 16 blocks, or of the
    launch's size (cs0), against window_stage_plain: the case's filter
    result and start, then five more pods with filter results of their
    own (pod 2 is padding: no rotation), the start carried on the card.
    At 6144 nodes the walk crosses 20, 5 and 2 cluster tiles on clusters
    of 1, 2 and 8 blocks, one on 16."""
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", size)
    ok0, s, n_real, kk = window_case(n_nodes, start, k)
    oks = [torch.from_numpy(ok0 if i == 0 else window_ok(n_nodes, seed=i))[None].to(cuda) for i in range(6)]
    before = chain_stages.window_stage.launches
    _windows_equal(oks, s, [i != 2 for i in range(6)], n_real, kk, cuda)
    assert chain_stages.window_stage.launches == before + 6
    _window_as_asked(chain_stages.window_stage.last, n_nodes, size)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("size", STAGE_CLUSTERS, ids=[f"cs{c}" for c in STAGE_CLUSTERS])
def test_window_stage_over_filter_results_matches_plain(cuda, size, exact, monkeypatch):
    """The window over E1's feasible sets of random700 (1024 padded nodes,
    700 real), eight pods in a row from the last real node, at k 3 and 50."""
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", size)
    (fsub, _), state, view, aux, carries = _stage_inputs("random700", exact, 8, cuda)
    ok = chain_stages.filter_stage(fsub, state, view, aux, carries)[1]
    n_real = int(_stage_feats("random700").nodes.count)
    for k in (3, 50):
        _windows_equal([ok[i:i + 1] for i in range(8)], n_real - 1, [True] * 8, n_real, k, cuda)
    _window_as_asked(chain_stages.window_stage.last, ok.shape[1], size)


def test_refused_normalize_and_select_cluster_launch_raises(cuda, monkeypatch):
    """A cluster E3 and E4's selection do not take is refused and raises,
    the committing selection's and the window's too; nothing smaller,
    one-block or plain runs in its place."""
    monkeypatch.setattr(chain, "MAX_CLUSTER", 32)
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", 32)
    staged, state, batch, aux, carries, ok, raw, norm, weights, _ = _e34_inputs("seed0", True, 1, cuda)
    before = chain_stages.launches()
    with pytest.raises(RuntimeError, match=r"ksim_chain_stages\(normalize\): CUDA error"):
        chain_stages.normalize_stage(staged.score_groups[0].sub, state, batch.view(), aux, carries, raw, ok)
    for commit in (False, True):
        out = {"selected": torch.empty(1, dtype=torch.int32, device=cuda)}
        with pytest.raises(RuntimeError, match=r"ksim_chain_stages\(select\): CUDA error"):
            chain_stages.select_stage(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, out,
                                      commit=commit)
    start = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match=r"ksim_chain_stages\(window\): CUDA error"):
        chain_stages.window_stage(ok[:1], start, batch.valid[:1], int(ok.shape[1]), 3)
    assert chain_stages.launches() == before


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
