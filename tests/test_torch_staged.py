"""The staged route (kernel E's stages, engine/staged.py) on the CPU,
against ksim_tpu, tolerance 0 in exact and f32 modes.

- Each stage's plain version against its ksim_tpu counterpart on one
  snapshot: E1 against ``_eval_filters`` (reason codes and ok), E2 against
  ``_eval_scores``' raw scores, E3 against ``_final_from_raw`` at weight 1
  (before the weight), E4 against ``_select``, ``_sample_visited`` and the
  committed state and carries.
- Every device hook (tests/test_torch_hooks.py's profile: each alone on a
  plugin, all six on PodTopologySpread) through the scan, the sampled
  scan, ``evaluate_batch_chunks`` and ``evaluate_batch_fused``.
- E4's window against ``_sample_visited`` over a sweep of node counts
  (40, 6144, with padding slots whose ok is true), rotating starts (0, a
  tile boundary, the last real node, past the real nodes) and k (1, 7,
  500, more than the feasible count), a padding pod among them, and
  over consecutive pods with the start carried.
- A filter and score plugin with no kernel code, written once in jnp and
  once in torch.
- A hooked SchedulerService pass, and a per-pass ScenarioRunner churn with
  a hooked profile.

tests/test_torch_gpu.py holds kernel E against these plain versions on the
card."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.engine.core import _Program as JaxProgram
from ksim_tpu.engine.core import PluginExtender as JaxPluginExtender
from ksim_tpu.engine.core import ScoredPlugin as JaxScoredPlugin
from ksim_tpu.engine.profiles import default_plugins as jax_default_plugins
from ksim_tpu.plugins.base import FilterOutput as JaxFilterOutput
from ksim_tpu.plugins.base import PodView as JaxPodView
from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu.scheduler.service import SchedulerService as JaxService
from ksim_tpu.state.cluster import ClusterStore as JaxStore
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.engine.core import Engine, PluginExtender, ScoredPlugin, engine_route
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.engine.staged import StagedProgram
from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.kernels.chain_stages import (
    filter_stage_plain,
    normalize_stage_plain,
    score_stage_plain,
    select_stage_plain,
    window_stage_plain,
)
from ksim_tpu_torch.plugins.base import FilterOutput
from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scenario.runner import ScenarioRunner
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import ClusterStore
from ksim_tpu_torch.state.featurizer import snapshot_from_arrays
from tests.helpers import random_cluster
from tests.test_torch_clusters import WINDOW_CASES, window_case, window_ok
from tests.test_torch_engine import assert_results_equal, assert_states_equal, engines, x64
from tests.test_torch_hooks import HOOKS, _hooked

SAMPLING_K = 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _equal(got, want, what: str) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=what)


def _jax_pod(pb) -> JaxPodView:
    return JaxPodView(requests=pb.requests, nonzero_requests=pb.nonzero_requests,
                      tolerates_unschedulable=pb.tolerates_unschedulable, has_requests=pb.has_requests,
                      index=pb.index)


def _reference_window(ok: np.ndarray, start: int, n_real: int, k: int):
    """ksim_tpu's _sample_visited (it reads only ``sampling_k`` off its
    program): (visited, sample, next start) as numpy."""
    visited, sample, nxt = JaxProgram._sample_visited(SimpleNamespace(sampling_k=k), jnp.asarray(ok),
                                                      jnp.int32(start), n_real)
    return np.asarray(visited), np.asarray(sample), int(nxt)


@pytest.mark.parametrize("valid", [True, False], ids=["pod", "padding"])
@pytest.mark.parametrize("n_nodes, start, k", WINDOW_CASES, ids=[f"{n}-{s}-{k}" for n, s, k in WINDOW_CASES])
def test_window_plain_matches_sample_visited(n_nodes, start, k, valid):
    """window_stage_plain (E4's window) against _sample_visited, exactly:
    the visited mask, the sample and the next start; a padding pod keeps
    its start (the reference's scan does not rotate for it)."""
    ok, s, n_real, kk = window_case(n_nodes, start, k)
    visited_r, sample_r, next_r = _reference_window(ok, s, n_real, kk)
    sample, visited, nxt = window_stage_plain(torch.from_numpy(ok)[None], torch.tensor([s], dtype=torch.int32),
                                              torch.tensor([valid]), n_real, kk)
    _equal(visited[0], visited_r, "E4 window visited")
    _equal(sample[0], sample_r, "E4 window sample")
    _equal(nxt, [next_r if valid else s], "E4 window next start")
    assert not visited_r[n_real:].any() and sample_r.sum() == min(kk, ok[:n_real].sum())


@pytest.mark.parametrize("n_nodes", [40, 6144])
def test_window_plain_carries_the_start_like_the_reference(n_nodes):
    """Eight pods in a row, each with its own filter result, the start
    carried from one to the next as the reference's sampled scan carries
    it (pod 3 is padding: no rotation), at k 7 and 500."""
    n_real = n_nodes - 3 if n_nodes == 40 else 5000
    for k in (7, 500) if n_nodes > 500 else (7,):
        start_r = start_p = n_real - 2
        start_t = torch.tensor([start_p], dtype=torch.int32)
        for i in range(8):
            ok = window_ok(n_nodes, seed=i + 1)
            valid = i != 3
            visited_r, sample_r, next_r = _reference_window(ok, start_r, n_real, k)
            start_r = next_r if valid else start_r
            sample, visited, start_t = window_stage_plain(torch.from_numpy(ok)[None], start_t, torch.tensor([valid]),
                                                          n_real, k)
            _equal(visited[0], visited_r, f"pod {i} visited")
            _equal(sample[0], sample_r, f"pod {i} sample")
            _equal(start_t, [start_r], f"pod {i} next start")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_stages_match_reference(exact):
    """E1-E4's plain versions, stage by stage, on the whole default
    profile (one launch group per stage), against ksim_tpu's pieces:
    ``evaluate_batch``'s record="full" program (tests/test_torch_engine.py
    compiles the same one) gives ``_eval_filters``' codes and ok,
    ``_eval_scores``' raw scores, ``_final_from_raw``'s finals (the
    normalized times the weight), the total and ``_select``;
    ``_sample_visited`` and the commit run on its arrays."""
    with x64(exact):
        ref_engine, eng = engines("seed1", "full", exact)
        ref = ref_engine.evaluate_batch()
        jprog, jstate, jaux = ref_engine._prog, ref_engine._node_state, ref_engine._aux
        jcarries = jprog.init_carries(jaux)
        pod0 = jax.tree_util.tree_map(lambda x: x[0], ref_engine._pods)
        ok_r = (np.asarray(ref.reason_bits) == 0).all(axis=1) & np.asarray(jstate.valid)[None, :]
        start, n_real = 5, int(eng._feats.nodes.count)
        sampler = type(jprog)(jprog.plugins, "full", sampling_k=SAMPLING_K)
        visited_r, sample_r, next_r = sampler._sample_visited(jnp.asarray(ok_r[0]), jnp.int32(start), n_real)
        best0 = jnp.where(pod0.valid, int(ref.selected[0]), -1)
        state_r = jstate.commit(best0, pod0.requests, pod0.nonzero_requests)
        carries_r = jprog._commit_carries(jcarries, _jax_pod(pod0), best0, jaux)
    staged = StagedProgram(eng._prog)
    assert [len(g.rows) for g in staged.filter_groups] == [len(eng._prog.filters)]
    assert [len(g.rows) for g in staged.score_groups] == [len(eng._prog.scores)]
    fsub, ssub = staged.filter_groups[0].sub, staged.score_groups[0].sub
    state, pods_t, aux = eng._node_state, eng._pods, eng._aux
    carries = eng._prog.init_carries(aux)
    view = pods_t.view()
    weights = np.array([sp.weight for sp in eng._prog.scores])
    assert (weights > 0).all()

    codes, ok = filter_stage_plain(fsub, state, view, aux, carries)
    _equal(codes, ref.reason_bits, "E1 reason codes")
    _equal(ok, ok_r, "E1 ok")
    raw = score_stage_plain(ssub, state, view, aux, carries, ok)
    _equal(raw, ref.scores, "E2 raw scores")
    norm = normalize_stage_plain(ssub, state, view, aux, carries, raw, ok)
    _equal(norm, np.asarray(ref.final_scores) // weights[None, :, None], "E3 normalized")

    P, N = ok.shape
    out = {"selected": torch.empty(P, dtype=torch.int32), "total": torch.empty((P, N), dtype=torch.int32),
           "final": torch.empty(tuple(norm.shape), dtype=torch.int32)}
    select_stage_plain(staged.commit_sub, state, pods_t, aux, carries, norm, torch.from_numpy(weights).to(torch.int32),
                       ok, out)
    _equal(out["total"], ref.total, "E4 total")
    _equal(out["final"], ref.final_scores, "E4 finals")
    _equal(out["selected"], ref.selected, "E4 selected")

    sample, visited, nxt = window_stage_plain(ok[:1], torch.tensor([start], dtype=torch.int32), pods_t.valid[:1],
                                              n_real, SAMPLING_K)
    _equal(visited[0], visited_r, "E4 window visited")
    _equal(sample[0], sample_r, "E4 window sample")
    _equal(nxt, [int(next_r)], "E4 window next start")

    # The commit of pod 0, in place into fresh copies.
    cstate, ccarries = chain.fresh_scan_state(eng._prog, state, carries)
    row = {"selected": torch.empty(1, dtype=torch.int32), "total": None, "final": None}
    select_stage_plain(staged.commit_sub, cstate, pods_t.rows(0, 1), aux, ccarries, norm[:1],
                       torch.from_numpy(weights).to(torch.int32), ok[:1], row, commit=True)
    assert int(row["selected"][0]) == int(best0) >= 0
    for field in cstate._fields:
        _equal(getattr(cstate, field), getattr(state_r, field), f"E4 commit state.{field}")
    for name, want in carries_r.items():
        got = ccarries[name]
        for key in (want if isinstance(want, dict) else [None]):
            _equal(got if key is None else got[key], want if key is None else want[key], f"E4 commit {name} {key}")


@pytest.fixture(scope="module")
def hooked_snapshots():
    """tests/test_torch_hooks.py's cluster featurized by ksim_tpu once per
    mode, and the port's snapshot of it: (ksim_tpu's, the port's)."""
    nodes, pods = random_cluster(3, 24, 64)
    snaps = {}

    def get(exact: bool):
        if exact not in snaps:
            with x64(exact):
                jf = JaxFeaturizer().featurize(nodes, pods)
            snaps[exact] = jf, snapshot_from_arrays(jf)
        return snaps[exact]

    return get


def _hooked_pair(snapshots, record: str, exact: bool, sampling_k=None):
    jf, tf = snapshots(exact)
    ref = JaxEngine(jf, _hooked(jax_default_plugins(jf), JaxScoredPlugin, JaxPluginExtender, 0), record=record,
                    sampling_k=sampling_k)
    port = Engine(tf, _hooked(default_plugins(tf), ScoredPlugin, PluginExtender, 1), record=record, exact=exact,
                  device="cpu", sampling_k=sampling_k)
    assert port.route == "staged"
    return ref, port


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_every_hook_through_the_sampled_scan(exact, hooked_snapshots):
    with x64(exact):
        ref_engine, port = _hooked_pair(hooked_snapshots, "full", exact, sampling_k=SAMPLING_K)
        ref, ref_state = ref_engine.schedule(sampling_start=3)
    got, state = port.schedule(sampling_start=3, chunk=40)
    assert_results_equal(ref, got)
    assert_states_equal(ref_state, state)
    assert got.visited is not None and got.sampling_next_start is not None


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_every_hook_through_the_fused_batch(exact, hooked_snapshots):
    """evaluate_batch_fused (record="final"), and in f32 mode the scan
    (tests/test_torch_hooks.py runs it in exact mode, and
    evaluate_batch's chunks in both)."""
    with x64(exact):
        ref_engine, port = _hooked_pair(hooked_snapshots, "final", exact)
        ref = ref_engine.evaluate_batch_fused(block=16)
        if not exact:
            ref_scan, ref_state = ref_engine.schedule()
    assert_results_equal(ref, port.evaluate_batch_fused(block=16))
    if not exact:
        got, state = port.schedule(chunk=24)
        assert_results_equal(ref_scan, got)
        assert_states_equal(ref_state, state)


class _JaxCustom:
    """A filter and a score with no kernel code (jnp, one pod)."""

    name = "Custom"

    def filter(self, state, pod, aux):
        n = state.valid.shape[0]
        bad = (jnp.arange(n) % 5 == 3) & (pod.index % 2 == 0)
        return JaxFilterOutput(ok=~bad, reason_bits=bad.astype(jnp.int32))

    def score(self, state, pod, aux, ok=None):
        n = state.valid.shape[0]
        return ((jnp.arange(n) * 7 + pod.index + state.pod_count) % 11).astype(jnp.int32)

    def normalize(self, raw, ok):
        mx = jnp.max(jnp.where(ok, raw, 0))
        return jnp.where(mx > 0, raw * 100 // jnp.maximum(mx, 1), 0).astype(jnp.int32)


class _TorchCustom:
    """The same plugin in torch, over a block of pods."""

    name = "Custom"

    def filter(self, state, pods, aux):
        n = state.valid.shape[0]
        bad = (torch.arange(n)[None, :] % 5 == 3) & (pods.index[:, None] % 2 == 0)
        return FilterOutput(ok=~bad, reason_bits=bad.to(torch.int32))

    def raw_dtype(self, exact):
        return torch.int32

    def score(self, state, pods, aux, ok=None, *, exact=True):
        n = state.valid.shape[0]
        return ((torch.arange(n)[None, :] * 7 + pods.index[:, None] + state.pod_count[None, :]) % 11).to(torch.int32)

    def normalize(self, raw, ok, *, pods=None, aux=None, exact=True):
        mx = torch.where(ok, raw, 0).amax(dim=1, keepdim=True)
        return torch.where(mx > 0, torch.div(raw * 100, mx.clamp_min(1), rounding_mode="floor"), 0).to(torch.int32)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_kernel_less_plugin(exact):
    """A profile with a filter and score no kernel runs takes the staged
    route; the scan (exact mode) and the batch (f32 mode) equal
    ksim_tpu's."""
    nodes, pods = random_cluster(4, 24, 40)
    with x64(exact):
        jf = JaxFeaturizer().featurize(nodes, pods)
        ref_engine = JaxEngine(jf, tuple(jax_default_plugins(jf)) + (JaxScoredPlugin(_JaxCustom(), 2),),
                               record="full")
        ref, ref_state = ref_engine.schedule() if exact else (ref_engine.evaluate_batch(), None)
    tf = snapshot_from_arrays(jf)
    plugins = tuple(default_plugins(tf)) + (ScoredPlugin(_TorchCustom(), 2),)
    assert engine_route(plugins) == "staged"
    port = Engine(tf, plugins, record="full", exact=exact, device="cpu")
    assert [g.sub is None for g in port._staged.filter_groups] == [False, True]
    if exact:
        got, state = port.schedule(chunk=16)
        assert_states_equal(ref_state, state)
    else:
        got = port.evaluate_batch(chunk=16)
    assert_results_equal(ref, got)
    assert (got.reason_bits[:, -1] != 0).any() and (got.final_scores[:, -1] != 0).any()


def _store(cls, nodes, pods):
    store = cls()
    for obj in nodes:
        store.create("nodes", obj)
    for obj in pods:
        store.create("pods", obj)
    return store


def _hooked_factory(defaults, scored_cls, ext_cls, side: int):
    """A plugins factory with the hooked profile: one extender object per
    plugin for every pass, so ksim_tpu's passes of one shape share a
    compiled program (an extender keys it by identity)."""
    exts = {name: ext_cls(**{f: pair[side] for f, pair in fields.items()}) for name, fields in HOOKS.items()}

    def factory(feats):
        return tuple(scored_cls(sp.plugin, sp.weight, sp.filter_enabled, sp.score_enabled,
                                extender=exts.get(sp.plugin.name)) for sp in defaults(feats))

    return factory


def test_hooked_service_pass_and_per_pass_churn():
    """One SchedulerService pass with the hooked profile equals ksim_tpu's
    (placements), and so does a per-pass ScenarioRunner churn of a few
    steps (exact mode; the same pass sizes, so ksim_tpu's passes of one
    shape share a program)."""
    nodes, pods = random_cluster(6, 24, 48, bound_fraction=0.0)
    jax_factory = _hooked_factory(jax_default_plugins, JaxScoredPlugin, JaxPluginExtender, 0)
    port_factory = _hooked_factory(default_plugins, ScoredPlugin, PluginExtender, 1)
    kw = dict(max_pods_per_pass=64, pod_bucket_min=16)
    ops = list(churn_scenario(0, n_nodes=24, n_events=72, ops_per_step=24))
    with x64(True):
        want = JaxService(_store(JaxStore, nodes, pods), plugins_factory=jax_factory, **kw).schedule_pending()
        jstore = JaxStore()
        ref = JaxRunner(store=jstore, service=JaxService(jstore, plugins_factory=jax_factory, **kw)).run(list(ops))
    got = SchedulerService(_store(ClusterStore, nodes, pods), plugins_factory=port_factory, device="cpu",
                           **kw).schedule_pending()
    assert got == want and any(v is not None for v in got.values())
    pstore = ClusterStore()
    psvc = SchedulerService(pstore, plugins_factory=port_factory, device="cpu", **kw)
    res = ScenarioRunner(store=pstore, service=psvc).run(list(ops))
    steps = [(s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]
    assert steps == [(s.scheduled, s.unschedulable, s.pending_after) for s in ref.steps]
    assert res.pods_scheduled > 0
