"""Kernel D on a thread-block cluster (csrc/replay_segment.cu), on the CPU:
what its launch chooses and needs, and what the cluster redesign lifted.

- ``choose_cluster``: the cluster size the solo and the fleet launch take
  from the card's occupancy answers (the answers are the card's, so here a
  table stands in for them);
- ``segment_smem_bytes`` / ``check_smem``: kernel D's shared memory per
  block of a cluster, and the node bound that gives (a padded node axis
  one block refuses, a cluster holds; one past the cluster's bound
  refused with the bound named);
- row 6 over more than 16 inter-pod topology keys: ``derive_layout`` and
  ``derive_interpod_plain`` against ksim_tpu's ``_derive_interpod``
  (tolerance 0), and a 17-key churn through the port's device path
  against its per-pass path and ksim_tpu's device path.

The kernel itself runs only on the card (tests/test_torch_gpu_replay.py)."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ksim_tpu_torch.engine.replay as replay_mod
from ksim_tpu.engine.replay import _derive_interpod as jax_derive_interpod
from ksim_tpu.engine.replay import _SegmentStatics
from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.kernels import replay_segment as seg
from ksim_tpu_torch.scenario.runner import ScenarioRunner
from tests.test_torch_gpu_replay import interpod_keys_stream


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def x64(enabled: bool):
    before = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def _fits(table: dict):
    return lambda size: table.get(size, 0)


@pytest.mark.parametrize("n_lanes,table,sizes,want", [
    (1, {16: 7, 8: 15}, seg.SOLO_SIZES, 16),  # the solo launch: 16 where one cluster fits
    (1, {16: 0, 8: 15}, seg.SOLO_SIZES, 8),
    (8, {16: 8, 8: 16, 4: 33, 2: 66}, seg.LANE_SIZES, 16),  # 8 lanes x 16 blocks resident at once
    (8, {16: 7, 8: 16, 4: 33, 2: 66}, seg.LANE_SIZES, 8),  # one GPC short at 16
    (40, {16: 7, 8: 16, 4: 33, 2: 66}, seg.LANE_SIZES, 2),
    (100, {16: 7, 8: 16, 4: 33, 2: 66}, seg.LANE_SIZES, 2),  # none holds all: the most at once
    (100, {16: 7, 8: 16, 4: 33, 2: 0}, seg.LANE_SIZES, 4),  # a size whose block does not fit holds none
    (9, {16: 8, 8: 8, 4: 8, 2: 8}, seg.LANE_SIZES, 16),  # a tie: the larger size
    (1, {}, seg.SOLO_SIZES, 16),  # nothing fits: the launch reports the refusal at the first size
])
def test_choose_cluster_mirrors_the_launch(n_lanes, table, sizes, want):
    assert seg.choose_cluster(n_lanes, _fits(table), sizes) == want


def _segment_prm(n: int, *, t2: int = 8, dk: int = 3, dsmem: int = 1) -> seg.SegmentParams:
    prm = seg.SegmentParams()
    prm.chain.N, prm.chain.I, prm.chain.MC, prm.chain.DMAX, prm.chain.sp_smem, prm.chain.T2 = n, 8, 2, 3, 1, t2
    prm.derive.N, prm.derive.T2, prm.derive.DK, prm.derive.dsmem = n, t2, dk, dsmem
    return prm


@pytest.mark.parametrize("size", [2, 8, 16])
def test_segment_smem_per_block_of_a_cluster(size):
    """Kernel D's dynamic shared memory per block: the chain's cluster
    layout for N / size nodes, then row 6's partial and combined scratch
    ([3, T2, DK] sums and [T2] totals each) when it is in shared memory;
    the static part (a lane's params and the search's lists) beside it."""
    prm = _segment_prm(4096)
    chain_part = chain.cluster_smem_bytes(prm.chain, size)
    derive_part = 2 * 4 * (3 * 8 * 3 + 8)
    assert seg.segment_smem_bytes(prm, size) == chain_part + derive_part
    threads = chain.cluster_threads(4096, size)
    assert threads == {2: 1024, 8: 512, 16: 256}[size]
    assert chain_part == chain.cluster_smem_bytes(prm.chain, size, threads)
    prm.derive.dsmem = 0  # the scratch in global memory, a row pair per rank
    assert seg.segment_smem_bytes(prm, size) == chain_part
    assert seg.STATIC_SMEM_BYTES == ((2176 + 15) & ~15) + ((seg.SEARCH_SMEM_BYTES + 15) & ~15)
    assert seg.SEARCH_SMEM_BYTES == 4 * 251


def test_cluster_check_holds_a_node_axis_past_the_old_one_block_bound():
    """20,000 padded nodes (past the old one-block bound of about 17,590)
    fit 8- and 16-block clusters; one node past the 16-block cluster's
    bound is refused with the bound named."""
    prm = _segment_prm(20_000)
    seg.check_smem(prm, cluster=16)
    seg.check_smem(prm, cluster=8)
    # The bound at 16 blocks of 1024 threads: whole tiles of 16 x 1024
    # nodes, 13 bytes per node slot.
    prm.chain.N = 1
    fixed = seg.segment_smem_bytes(prm, 16, 1024) + seg.STATIC_SMEM_BYTES - ((13 * 1024 + 7) & ~7)
    tiles = (chain.MAX_SMEM_BYTES - fixed - 7) // 13 // 1024
    bound = tiles * 16 * 1024
    assert bound > 250_000
    prm.chain.N = bound
    seg.check_smem(prm, cluster=16)
    prm.chain.N = bound + 1
    with pytest.raises(ValueError, match=rf"N={bound + 1}.*16-block cluster.*{bound} padded nodes"):
        seg.check_smem(prm, cluster=16)


@pytest.mark.parametrize("size,threads", [(17, 0), (-1, 0), (8, 48), (8, 2048)])
def test_segment_launch_refuses_a_shape_it_cannot_run(monkeypatch, size, threads):
    """A forced cluster size or block width kernel D cannot take raises
    before anything reaches the card."""
    monkeypatch.setattr(seg, "CLUSTER_SIZE", size)
    monkeypatch.setattr(seg, "CLUSTER_THREADS", threads)
    with pytest.raises(ValueError, match="cluster size"):
        seg._Launch.launch(None, None, [_segment_prm(64)], lanes=False)


def _keyed_universe(seed: int, n: int = 40, n_keys: int = 17, t2: int = 24):
    """A node axis with ``n_keys`` inter-pod topology keys (every third
    hostname-like, the rest 1-6 domains, some nodes missing some keys),
    terms over them (one term naming no key of the vocabulary), and
    random node-local counts."""
    rng = np.random.default_rng(seed)
    node_dom = np.full((n, n_keys), -1, np.int32)
    n_dom = 0
    for k in range(n_keys):
        keyed = rng.random(n) < 0.85
        if k % 3 == 0:
            ids = np.arange(n)
        else:
            ids = rng.integers(0, int(rng.integers(1, 7)), n)
        node_dom[keyed, k] = n_dom + ids[keyed]
        n_dom += n
    term_tk = rng.integers(0, n_keys, t2).astype(np.int32)
    term_tk[-1] = n_keys + 3
    dom_t = np.where(term_tk[None, :] < n_keys, node_dom[:, np.minimum(term_tk, n_keys - 1)], -1).astype(np.int32)
    loc = {key: rng.integers(-2, 5, (n, t2)).astype(np.int32) for key in ("cnt", "eat", "vw")}
    ipa = {"node_dom": node_dom, "term_tk": term_tk, "dom_t": dom_t}
    return loc, ipa, n_dom


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_derive_over_17_keys_equals_reference(seed):
    loc, ipa, n_dom = _keyed_universe(seed)
    st = _SegmentStatics(k=1, q=1, cap=1, n_tk=17, n_dom=n_dom)
    with x64(False):
        ref = jax_derive_interpod({k: jnp.asarray(v) for k, v in loc.items()},
                                  {k: jnp.asarray(v) for k, v in ipa.items()}, st)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    got = seg.derive_interpod_plain({k: torch.from_numpy(v) for k, v in loc.items()},
                                    {k: torch.from_numpy(v) for k, v in ipa.items()}, 17, n_dom)
    assert set(got) == set(ref)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    # The kernel's layout of the 17 keys: no refusal, singleton keys found.
    layout = seg.derive_layout(torch.from_numpy(ipa["node_dom"]))
    assert len(layout.singleton) == 17 and layout.singleton_mask.shape == (17,)
    assert all(layout.singleton[k] for k in range(0, 17, 3))
    assert layout.singleton_mask.tolist() == [int(x) for x in layout.singleton]
    for k in range(17):
        keyed = ipa["node_dom"][:, k] >= 0
        local = layout.ldom[:, k].numpy()
        if layout.singleton[k]:
            assert (local == -1).all()
        else:
            ids = ipa["node_dom"][keyed, k]
            assert (np.equal.outer(local[keyed], local[keyed]) == np.equal.outer(ids, ids)).all()
            assert local[keyed].max() < layout.dk


def _steps(res):
    return [(s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


def test_17_key_churn_runs_on_the_device_path(monkeypatch):
    """A churn whose inter-pod terms span 17 topology keys lowers to the
    device path (no fallback), and its steps equal the per-pass path's and
    ksim_tpu's device path's."""
    widths = []
    plain = replay_mod.replay_segment

    def capture(st, prog, const, ev, state0):
        widths.append(const["aux"]["interpod"]["node_dom"].shape[1])
        return plain(st, prog, const, ev, state0)

    monkeypatch.setattr(replay_mod, "replay_segment", capture)
    kw = dict(device_segment_steps=4, exact=False, device="cpu")
    dev = ScenarioRunner(device_replay=True, **kw)
    dev_res = dev.run(interpod_keys_stream())
    base_res = ScenarioRunner(**kw).run(interpod_keys_stream())
    with x64(False):
        jrun = JaxRunner(device_replay=True, device_segment_steps=4)
        jres = jrun.run(interpod_keys_stream())
    drv = dev.replay_driver
    assert drv.fallback_steps == 0 and drv.unsupported == {} and drv.device_steps == len(dev_res.steps)
    assert max(widths) == 17  # the key vocabulary grows with the pods lowered so far
    assert _steps(dev_res) == _steps(base_res) == _steps(jres)
    assert dev_res.pods_scheduled > 0 and dev_res.unschedulable_attempts > 0
