"""percentageOfNodesToScore sampling in the port against ksim_tpu, on the
CPU.

The cases of tests/test_pnts_sampling.py that do not go through the
scheduler service (the first k feasible nodes from the start, rotation
across pods, wrap-around, infeasible nodes skipped, fewer than k
feasible, normalizing over the sample only, scan-only, recorded maps over
the visited nodes) plus sampled passes over richer clusters go through
``Engine(sampling_k=k).schedule(sampling_start=s)`` of both engines:
selected, bits, raw, final, total, visited and the next start must be
equal, element for element (tolerance 0), in exact and f32 modes, and
each case must show the hand-derived expectation of the reference's
test."""

from __future__ import annotations

import json

import pytest

from ksim_tpu.engine.annotations import RenderCtx as JaxRenderCtx
from ksim_tpu.engine.annotations import render_pod_results as jax_render
from ksim_tpu_torch.engine.annotations import (
    FILTER_RESULT_KEY,
    SCORE_RESULT_KEY,
    RenderCtx,
    render_pod_results,
)
from tests.helpers import make_node, make_pod
from tests.test_torch_engine import assert_results_equal, assert_states_equal, engines_for, x64
from test_torch_clusters import case_inputs


def sampled(nodes, queue, k, start, exact, record="full", chunk=None):
    """Both engines' sampled schedule; asserts them equal; returns the
    port's (engine, result) and the reference's (engine, result)."""
    with x64(exact):
        ref_engine, port = engines_for(nodes, [], {"queue_pods": queue}, record, exact, sampling_k=k)
        ref, ref_state = ref_engine.schedule(sampling_start=start)
    got, state = port.schedule(sampling_start=start, chunk=chunk)
    assert_results_equal(ref, got)
    assert_states_equal(ref_state, state)
    return port, got, ref_engine, ref


def _plain_nodes(n, **kw):
    return [make_node(f"n{i:03d}", **kw) for i in range(n)]


EXACT = pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])


@EXACT
def test_sampling_visits_first_k_feasible_from_start(exact):
    port, res, _, _ = sampled(_plain_nodes(12), [make_pod("p0")], 4, 0, exact)
    assert res.visited[0][:12].tolist() == [True] * 4 + [False] * 8
    assert int(res.selected[0]) in range(4)
    assert res.sampling_next_start == 4


@EXACT
def test_sampling_rotates_across_pods(exact):
    port, res, _, _ = sampled(_plain_nodes(12), [make_pod("p0"), make_pod("p1")], 4, 0, exact)
    assert res.visited[0][:12].tolist() == [True] * 4 + [False] * 8
    assert res.visited[1][:12].tolist() == [False] * 4 + [True] * 4 + [False] * 4
    assert res.sampling_next_start == 8


@EXACT
def test_sampling_wraps_modulo_node_count(exact):
    port, res, _, _ = sampled(_plain_nodes(12), [make_pod("p0")], 4, 10, exact)
    assert [i for i in range(12) if res.visited[0][i]] == [0, 1, 10, 11]
    assert res.sampling_next_start == 2


@EXACT
def test_sampling_skips_infeasible_until_k_found(exact):
    nodes = [make_node(f"n{i:03d}", unschedulable=i in (1, 2)) for i in range(10)]
    port, res, _, _ = sampled(nodes, [make_pod("p0")], 3, 0, exact)
    assert res.visited[0][:10].tolist() == [True] * 5 + [False] * 5
    assert res.sampling_next_start == 5
    assert int(res.selected[0]) in (0, 3, 4)


@EXACT
def test_sampling_fewer_feasible_than_k_visits_everything(exact):
    nodes = [make_node(f"n{i:03d}", unschedulable=i not in (5, 6)) for i in range(8)]
    port, res, _, _ = sampled(nodes, [make_pod("p0")], 3, 0, exact)
    assert res.visited[0][:8].tolist() == [True] * 8
    assert res.sampling_next_start == 0
    assert int(res.selected[0]) in (5, 6)


@EXACT
def test_sampling_normalizes_over_sample_only(exact):
    aff = {"nodeAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
        {"weight": 100, "preference": {"matchExpressions": [
            {"key": "zone", "operator": "In", "values": ["hot"]}]}}]}}
    nodes = [make_node(f"n{i:03d}", labels={"zone": "hot"} if i == 9 else None) for i in range(10)]
    port, res, _, _ = sampled(nodes, [make_pod("p0", affinity=aff)], 4, 0, exact)
    na = res.plugin_names.index("NodeAffinity")
    # Node 9's raw 100 must not enter the normalize maximum of the sample.
    assert (res.final_scores[0][na][:4] == 0).all()
    assert int(res.selected[0]) in range(4)


def test_sampling_scan_only():
    nodes, queue = _plain_nodes(8), [make_pod("p0")]
    for record, call in (("full", "evaluate_batch"), ("final", "evaluate_batch_fused")):
        with x64(True):
            _, port = engines_for(nodes, [], {"queue_pods": queue}, record, True, sampling_k=3)
        with pytest.raises(ValueError, match="scan-only"):
            getattr(port, call)()


@EXACT
def test_recorded_maps_cover_visited_nodes_only(exact):
    nodes = [make_node(f"n{i:03d}", unschedulable=i == 1) for i in range(10)]
    port, res, ref_engine, ref = sampled(nodes, [make_pod("p0")], 3, 0, exact)
    have = render_pod_results(port._feats, port._plugins, res, 0, visited=res.visited[0],
                              ctx=RenderCtx(port._feats, port._plugins))
    want = jax_render(ref_engine._feats, ref_engine._plugins, ref, 0, visited=ref.visited[0],
                      ctx=JaxRenderCtx(ref_engine._feats, ref_engine._plugins))
    assert have == want
    filt = json.loads(have[FILTER_RESULT_KEY])
    # Visit order 0 (ok), 1 (cordoned), 2 (ok), 3 (ok): four visited nodes.
    assert sorted(filt) == ["n000", "n001", "n002", "n003"]
    assert "NodeUnschedulable" in str(filt["n001"])
    assert sorted(json.loads(have[SCORE_RESULT_KEY])) == ["n000", "n002", "n003"]


@EXACT
@pytest.mark.parametrize(
    "case,k,start",
    [("seed0", 7, 5), ("seed1", 33, -4), ("spread_affinity", 5, 100), ("volumes", 3, 2)],
)
def test_sampled_pass_on_clusters_matches_reference(case, k, start, exact):
    """The whole default profile under sampling: PodTopologySpread's
    registered domains and every normalize come from the sampled nodes;
    chunks of 24 carry the start across launches."""
    nodes, pods, kw = case_inputs(case)
    for record in ("full", "selection"):
        with x64(exact):
            ref_engine, port = engines_for(nodes, pods, kw, record, exact, sampling_k=k)
            ref, ref_state = ref_engine.schedule(sampling_start=start)
        got, state = port.schedule(sampling_start=start, chunk=24)
        assert_results_equal(ref, got)
        assert_states_equal(ref_state, state)
        assert got.visited is None if record == "selection" else got.visited.any(axis=1).sum() > 0
