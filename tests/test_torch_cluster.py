"""The cluster layout of kernels A and C (csrc/cluster_scan.cuh) on the
CPU: how the node axis is dealt over a thread-block cluster, the shared-
memory bound that layout gives, and the visit walk of kernel C modelled
from the same layout against the plain sampled window.

The kernels themselves run only on the card (tests/test_torch_gpu.py);
these tests hold the host helpers that mirror their layout
(kernels/chain.py ``cluster_threads``, ``cluster_slots``,
``block_nodes``, ``cluster_smem_bytes``, ``check_smem``), and kernel B's
layout beside it (kernels/batch_eval.py ``batch_smem_bytes``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.kernels.schedule_sampled import sample_visited

torch.set_num_threads(1)

LAYOUTS = [
    # (padded nodes, cluster size, threads per block)
    (8, 16, 32),  # fewer nodes than one block's threads, and than blocks
    (64, 2, 32),
    (100, 3, 64),  # not a multiple of the cluster size or of a chunk
    (6144, 16, 384),  # the main path at 16 blocks: one tile
    (6144, 8, 768),
    (6144, 16, 128),  # three tiles
    (40000, 16, 1024),  # past one block's shared-memory bound
]


@pytest.mark.parametrize("n,size,threads", LAYOUTS)
def test_block_nodes_cover_the_node_axis_once_in_order(n, size, threads):
    owned = [chain.block_nodes(n, size, threads, r) for r in range(size)]
    for nodes in owned:
        assert nodes == sorted(nodes) and len(set(nodes)) == len(nodes)
        assert len(nodes) <= chain.cluster_slots(n, size, threads)
    assert sorted(x for nodes in owned for x in nodes) == list(range(n))


@pytest.mark.parametrize("n,size,threads", LAYOUTS)
def test_each_round_of_slots_is_one_cluster_tile(n, size, threads):
    """Round i of a node loop (slot i * threads + t in every block) covers
    nodes [i * T, (i + 1) * T), T = size * threads, every block an equal
    share: kernel C's visit walks the axis a tile at a time."""
    tile = size * threads
    slots = chain.cluster_slots(n, size, threads)
    for i in range(slots // threads):
        got = []
        for r in range(size):
            for t in range(threads):
                li = i * threads + t
                got.append(((li >> 5) * size + r) << 5 | (li & 31))
        assert sorted(got) == list(range(i * tile, (i + 1) * tile))


@pytest.mark.parametrize("n,size,want", [(6144, 16, 384), (6144, 8, 768), (8, 16, 32), (5000, 16, 320),
                                         (200000, 8, 1024)])
def test_cluster_threads_give_each_thread_one_slot_up_to_a_full_block(n, size, want):
    threads = chain.cluster_threads(n, size)
    assert threads == want and threads % 32 == 0
    if threads < chain.MAX_THREADS:
        assert chain.cluster_slots(n, size, threads) == threads  # one tile: one slot per thread


def _prm(n, *, mc=2, dmax=3, images=8, t2=8, sp_smem=1):
    prm = chain.ChainParams()
    prm.N, prm.I, prm.MC, prm.DMAX, prm.sp_smem, prm.T2 = n, images, mc, dmax, sp_smem, t2
    return prm


def test_cluster_bound_accepts_a_node_axis_a_smaller_cluster_refuses():
    """65,536 padded nodes fit 8- and 16-block clusters; 200,000 fit 16
    blocks and not 8 (whole tiles of 8 x 1024 nodes: 139,264)."""
    prm = _prm(200_000)
    with pytest.raises(ValueError, match=r"N=200000.*8-block cluster.*139264 padded"):
        chain.check_smem(prm, cluster=8)
    chain.check_smem(prm, cluster=16)
    prm.N = 65536
    for size in (8, 16):
        chain.check_smem(prm, cluster=size)
        assert chain.cluster_smem_bytes(prm, size) < chain.MAX_SMEM_BYTES
    # Blocks of 1024 threads hold 17 tiles of slots: 16 x 17 x 1024 nodes.
    prm.N = 16 * 1024 * 17
    chain.check_smem(prm, cluster=16)
    prm.N = 16 * 1024 * 17 + 1
    with pytest.raises(ValueError, match=r"N=278529.*16-block cluster.*232448.*at most 17408 slots, 278528 padded"):
        chain.check_smem(prm, cluster=16)


def test_cluster_smem_layout_counts_every_part():
    """cluster_smem_bytes: 13 bytes per slot, image weights, the reduction
    and prefix-count scratch, the term totals' copy, the pod's staged
    spread constraints (32 bytes each), and two copies (partial,
    combined) of the spread domain scratch when it is in shared memory."""
    prm = _prm(6144)
    slots = 384
    fixed = (8 * 8 + 8 * 33 + 8 * 2 + 4 * (33 * chain.RED_MAX + chain.SCAN_INTS + 2 * chain.RED_MAX + 128 + 8)
             + chain.SPREAD_CON_BYTES * 2)
    assert chain.cluster_smem_bytes(prm, 16) == 13 * slots + fixed + 2 * 4 * 4 * 2 * 3
    prm.sp_smem = 0  # the domain scratch in global memory
    assert chain.cluster_smem_bytes(prm, 16) == 13 * slots + fixed
    assert chain.cluster_smem_bytes(prm, 8) == 13 * 768 + fixed


def test_kernel_b_shared_memory_does_not_grow_with_the_node_axis():
    """Kernel B keeps its 5 bytes per node (flags, partial) in a global row
    per resident block, so its shared memory per block is the same at the
    main path's 6144 padded nodes, at 16,384 and at 24,576 (past the old
    one-block bound of about 17,590), and four blocks fit an SM."""
    from ksim_tpu_torch.kernels import batch_eval as be

    sp = be.SummaryParams()
    for g, o in enumerate(be.word_offsets((8,) * len(be.GROUPS))):
        sp.off[g] = o
    sizes = set()
    for n in (6144, 16384, 24_576):
        prm = _prm(n)
        assert be.batch_smem_bytes(prm, sp) == (be.batch_fixed_bytes(prm, sp) + 7) & ~7
        sizes.add(be.batch_smem_bytes(prm, sp))
    (smem,) = sizes
    assert smem < 8192
    assert be.MIN_BLOCKS * (smem + be.BLOCK_RESERVED_BYTES) <= be.SM_SMEM_BYTES


@pytest.mark.parametrize("size,threads", [(17, 0), (-1, 0), (8, 48), (8, 2048)])
def test_cluster_launch_refuses_a_shape_it_cannot_run(monkeypatch, size, threads):
    """A cluster size or block shape outside what the kernels take raises
    before anything reaches the card."""
    monkeypatch.setattr(chain, "CLUSTER_SIZE", size)
    monkeypatch.setattr(chain, "CLUSTER_THREADS", threads)
    with pytest.raises(ValueError, match="cluster size"):
        chain.launch_cluster(None, "ksim_schedule_scan", _prm(64))


def _walk(ok: np.ndarray, start: int, n_real: int, k: int, size: int, threads: int) -> int:
    """Kernel C's visit walk (plugin_chain.cuh visit_window with
    ClusterTeam::piece_find), modelled over the layout of block_nodes: one
    step per cluster tile in visit order (the start tile from the start
    on, the tiles after it, wrapping, then the start tile before the
    start; a single step rotated at the start when one tile holds every
    real node), each step's feasible nodes counted per warp chunk in
    index order (warp-major, rank-minor), until the step that holds the
    k-th.  Returns the threshold (the last visited position)."""
    n = ok.shape[0]
    tile, nw = size * threads, threads // 32
    nr = max(n_real, 1)
    sm = start % nr
    tiles = -(-n_real // tile)
    running = 0
    for step in range(tiles + (1 if tiles > 1 else 0)):
        t = (sm // tile + step) % tiles

        def counted(x):
            if not (x < n_real and ok[x]):
                return False
            return tiles == 1 or (x >= sm if step == 0 else step < tiles or x < sm)

        bits = []  # the step's feasible nodes, chunk by chunk in index order
        for w in range(nw):
            for q in range(size):
                base = ((t * nw + w) * size + q) * 32
                bits += [x for x in range(base, base + 32) if x < n and counted(x)]
        if tiles == 1:  # rotated at the start
            bits = [x for x in bits if x >= sm] + [x for x in bits if x < sm]
        need = k - running
        if need <= len(bits):
            return (bits[need - 1] - sm) % nr
        running += len(bits)
    return n_real - 1


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n,n_real,size,threads", [(64, 40, 2, 32), (128, 100, 3, 32), (6144, 5000, 16, 384),
                                                   (6144, 5000, 16, 128), (8, 2, 16, 32),
                                                   (300, 290, 2, 32)])
def test_visit_walk_model_matches_the_plain_window(seed, n, n_real, size, threads):
    """The walk's threshold equals the plain sampled window's
    (schedule_sampled.sample_visited) for random feasible masks, starts
    (near the wrap too) and k (above the feasible count too)."""
    rng = np.random.default_rng(seed)
    ok = rng.random(n) < rng.choice([0.05, 0.5, 0.95])
    ok[n_real:] = rng.random(n - n_real) < 0.5  # padding is never visited, whatever its mask
    for start in (0, n_real - 1, int(rng.integers(-3 * n_real, 3 * n_real))):
        for k in (1, max(1, n_real // 10), n_real, int(rng.integers(1, n_real + 1))):
            visited, _, nxt = sample_visited(torch.from_numpy(ok), torch.tensor(start, dtype=torch.int32),
                                             n_real, k)
            want = int(visited.sum()) - 1  # visited positions are 0..threshold
            got = _walk(ok, start, n_real, k, size, threads)
            assert got == want, (start, k)
            assert int(nxt) == (start + got + 1) % max(n_real, 1)
