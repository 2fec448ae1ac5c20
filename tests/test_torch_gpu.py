"""Kernels A (schedule_scan), B (batch_eval) and C (schedule_sampled)
against their plain PyTorch versions on a CUDA device, element for
element (tolerance 0), at small size, with the whole default profile.
Kernels A and C run on a thread-block cluster: their tests run at
cluster sizes 2, 8 and 16 (kernels/chain.py CLUSTER_SIZE).

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
from ksim_tpu_torch.kernels.batch_eval import batch_eval, batch_eval_plain
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled, schedule_sampled_plain
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan, schedule_scan_plain
from ksim_tpu_torch.state.featurizer import Featurizer
from test_torch_clusters import case_inputs

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
