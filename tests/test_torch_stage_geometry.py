"""The geometry of kernel E's cluster stages (E1 filter, E2 score, E3
normalize, E4 window and select; csrc/chain_stages.cu), on the CPU: the Python mirror
in kernels/chain.py of the rule the launch follows, over N in {40, 6144,
12288} padded nodes and B in {1, 7, 132, 256} pod rows.

- ``stage_cluster``: the cluster size is one of 1, 2, 4, 8, 16, never
  rises as the rows grow, is 16 for one row where a 16-block cluster fits
  (else 8), and 1 from the card's SM count on (from half of it, in fact);
  the occupancy answers are the card's, so a model of the card stands in;
- ``block_nodes`` at the chosen size and block width: every real node
  belongs to exactly one (rank, slot) of a cluster;
- ``stage_scratch_row`` and ``chain_stages.scratch_rows``: where the spread
  domains do not fit shared memory, each (cluster, rank) of a launch has a
  row pair of its own, and a block reads its cluster's pairs;
- ``stage_smem_bytes``: what one block of each stage needs fits 232448
  bytes at every geometry the rule picks, for this repo's profiles, and
  for the most the domains may take in shared memory; it equals the bytes
  each stage's carve (``carve_stage_cluster``) lays out;
- the wrappers' launches (the launch itself faked): E3 and E4's selection
  on min(B, GRID_MAX) clusters of the forced or chosen size, the
  committing selection and the visit window on one cluster, one pod
  only;
- the window's visit walk (ClusterTeam::piece_find): every block width
  the rule picks holds a thread for each (warp, rank) of its cluster
  tile.

The kernels themselves run only on the card (tests/test_torch_gpu.py)."""

from __future__ import annotations

import pytest
import torch

from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.engine.staged import StagedProgram
from ksim_tpu_torch.kernels import chain, chain_stages
from ksim_tpu_torch.state.featurizer import Featurizer
from tests.test_torch_clusters import case_inputs

NODES = [40, 6144, 12288]
ROWS = [1, 7, 132, 256]
SIZES = {1, 2, 4, 8, 16}
H100_SMS = 132


def h100(cs: int) -> int:
    """A model of the card's occupancy answers: every SM free, one block
    per SM."""
    return H100_SMS // cs


def no_16(cs: int) -> int:
    """A card with no room for a 16-block cluster."""
    return 0 if cs == 16 else H100_SMS // cs


CARDS = {"h100": h100, "no_16": no_16}


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("rows", ROWS)
def test_stage_cluster_size_follows_the_rows(rows, card):
    fits = CARDS[card]
    cs = chain.stage_cluster(rows, H100_SMS, fits)
    assert cs in SIZES
    assert cs <= chain.stage_cluster_cap(rows, H100_SMS)
    assert rows * cs <= H100_SMS or cs == 1
    if rows == 1:
        assert cs == (16 if card == "h100" else 8)
    if rows >= H100_SMS:
        assert cs == 1


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_stage_cluster_size_never_rises_as_the_rows_grow(sms, card):
    fits = CARDS[card]
    sizes = [chain.stage_cluster(rows, sms, fits) for rows in range(1, 2 * sms)]
    assert sizes == sorted(sizes, reverse=True)
    assert all(cs == 1 for cs in sizes[sms // 2:])  # rows above half the SM count
    assert set(sizes) <= SIZES


def test_stage_cluster_takes_the_largest_size_that_holds_every_row():
    """Seven rows: 16 where seven 16-block clusters are resident at once,
    8 where only six are."""
    assert chain.stage_cluster(7, H100_SMS, lambda cs: {16: 7, 8: 16}.get(cs, 33)) == 16
    assert chain.stage_cluster(7, H100_SMS, lambda cs: {16: 6, 8: 16}.get(cs, 33)) == 8
    assert chain.stage_cluster(7, H100_SMS, lambda cs: 0) == 1


@pytest.mark.parametrize("n_nodes", NODES)
def test_stage_threads(n_nodes):
    """One block of 256 threads on a cluster of one (the old geometry); a
    node slot per thread for N / size nodes, at most 512, on a larger one."""
    assert chain.stage_threads(n_nodes, 1) == 256
    for cs in (2, 4, 8, 16):
        nt = chain.stage_threads(n_nodes, cs)
        assert nt % 32 == 0 and 32 <= nt <= 512
        assert nt == min(512, chain.cluster_threads(n_nodes, cs))
    assert chain.stage_threads(6144, 16) == 384  # one pod of the main path: one slot per thread


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("n_nodes", NODES)
def test_every_real_node_has_exactly_one_slot_of_a_cluster(n_nodes, rows, card):
    cs = chain.stage_cluster(rows, H100_SMS, CARDS[card])
    nt = chain.stage_threads(n_nodes, cs)
    owned = [n for rank in range(cs) for n in chain.block_nodes(n_nodes, cs, nt, rank)]
    assert sorted(owned) == list(range(n_nodes))
    slots = chain.cluster_slots(n_nodes, cs, nt)
    assert slots % nt == 0 and slots * cs >= n_nodes


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("forced", [0, 1, 2, 8, 16])
def test_global_domain_scratch_has_a_row_pair_per_cluster_and_rank(rows, forced, card):
    """The wrapper sizes the scratch for the largest cluster the launch may
    take (or the forced one); each (cluster, rank) of the launch's
    min(rows, GRID_MAX) clusters has a pair of its own, and block `rank`
    finds block q's pair q - rank pairs from its own (ClusterTeam::combine)."""
    cs = forced or chain.stage_cluster(rows, H100_SMS, CARDS[card])
    clusters = min(rows, chain_stages.GRID_MAX)
    n_rows = chain_stages.scratch_rows(rows, forced, H100_SMS)
    pairs = [chain.stage_scratch_row(c, rank, cs) for c in range(clusters) for rank in range(cs)]
    assert len(set(pairs)) == len(pairs) == clusters * cs
    assert max(pairs) < n_rows
    for c in range(clusters):
        for rank in range(cs):
            for q in range(cs):
                own = chain.stage_scratch_row(c, rank, cs)
                assert own + (q - rank) == chain.stage_scratch_row(c, q, cs)


def _stage_prm(case: str) -> dict:
    """The ChainParams each cluster stage launches with over a test
    cluster (kernel E's template), on the CPU: the default profile's
    filter group (E1), its score group (E2 and E3: one object), and the
    sub-profile the selection commits with (E4 select)."""
    nodes, pods, kw = case_inputs(case)
    feats = Featurizer().featurize(nodes, pods, **kw)
    eng = Engine(feats, default_plugins(feats), record="full", device="cpu")
    staged = StagedProgram(eng._prog)
    carries = eng._prog.init_carries(eng._aux)
    view = eng._pods.view()
    subs = {"filter": staged.filter_groups[0].sub, "score": staged.score_groups[0].sub,
            "normalize": staged.score_groups[0].sub, "select": staged.commit_sub}
    return {stage: chain_stages._template(sub, eng._node_state, view, eng._aux, carries)
            for stage, sub in subs.items()}


@pytest.mark.parametrize("case", ["spread_affinity", "images_ports", "volumes"])
@pytest.mark.parametrize("n_nodes", NODES)
def test_stage_shared_memory_fits_at_every_geometry_the_rule_picks(n_nodes, case):
    prms = _stage_prm(case)
    for stage in ("filter", "score"):
        prm = prms[stage]
        prm.N = n_nodes
        for rows in ROWS:
            for fits in CARDS.values():
                cs = chain.stage_cluster(rows, H100_SMS, fits)
                need = chain.stage_smem_bytes(prm, cs, stage)
                assert need <= chain.MAX_SMEM_BYTES
                chain.check_stage_smem(prm, cs, stage)


@pytest.mark.parametrize("score", [False, True], ids=["E1", "E2"])
@pytest.mark.parametrize("n_nodes", NODES)
def test_stage_shared_memory_with_the_most_domains_in_shared_memory(n_nodes, score):
    """Wide vocabularies (64 images, 64 inter-pod terms, 8 spread
    constraints) and the domain scratch at its shared-memory limit: a
    partial and a combined array of DOMAIN_SMEM_BYTES each."""
    prm = chain.ChainParams()
    prm.N, prm.I, prm.T2, prm.MC = n_nodes, 64, 64, 8
    prm.DMAX = chain.DOMAIN_SMEM_BYTES // (4 * 4 * prm.MC)
    prm.sp_smem = int(4 * chain.domain_ints(prm) <= chain.DOMAIN_SMEM_BYTES)
    assert prm.sp_smem == 1
    fixed = 8 * 35 + 4 * (35 * chain.RED_MAX + prm.T2) + chain.SPREAD_CON_BYTES * prm.MC
    for cs in sorted(SIZES):
        nt = chain.stage_threads(n_nodes, cs)
        slots = chain.cluster_slots(n_nodes, cs, nt)
        want = fixed + 2 * chain.DOMAIN_SMEM_BYTES + ((8 * prm.I + slots) if score else 0)
        assert chain.stage_smem_bytes(prm, cs, "score" if score else "filter") == want <= chain.MAX_SMEM_BYTES


def test_score_stage_refuses_a_node_axis_past_its_shared_memory():
    """E2 keeps one flag byte per node slot in shared memory: a block of a
    cluster of one holds about 225,000 padded nodes, more raise before the
    launch with the bound named."""
    prm = chain.ChainParams()
    prm.I, prm.T2, prm.MC = 8, 8, 2
    prm.N = 200_000
    chain.check_stage_smem(prm, 1, "score")
    chain.check_stage_smem(prm, 1, "filter")
    prm.N = 240_000
    chain.check_stage_smem(prm, 1, "filter")
    chain.check_stage_smem(prm, 2, "score")
    with pytest.raises(ValueError, match=r"N=240000 .* score stage on a 1-block cluster"):
        chain.check_stage_smem(prm, 1, "score")


def test_stage_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors E1 and E2 run their plain versions: no launch, no
    geometry."""
    launches = chain_stages.launches()
    nodes, pods, kw = case_inputs("seed0")
    feats = Featurizer().featurize(nodes, pods, **kw)
    eng = Engine(feats, default_plugins(feats), record="full", device="cpu")
    staged = StagedProgram(eng._prog)
    carries = eng._prog.init_carries(eng._aux)
    view = eng._pods.view()
    fsub, ssub = staged.filter_groups[0].sub, staged.score_groups[0].sub
    codes, ok = chain_stages.filter_stage(fsub, eng._node_state, view, eng._aux, carries)
    want = chain_stages.filter_stage_plain(fsub, eng._node_state, view, eng._aux, carries)
    torch.testing.assert_close(codes, want[0], rtol=0, atol=0)
    raw = chain_stages.score_stage(ssub, eng._node_state, view, eng._aux, carries, ok)
    torch.testing.assert_close(raw, chain_stages.score_stage_plain(ssub, eng._node_state, view, eng._aux, carries, ok),
                               rtol=0, atol=0)
    assert chain_stages.launches() == launches


# ---- E3 (normalize) and E4's selection ----------------------------------------

@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("n_nodes", NODES)
def test_normalize_and_select_shared_memory_fits_at_every_geometry_the_rule_picks(n_nodes, rows, card):
    """E3 holds the reduction slots and the spread constraints, E4's
    selection the 64-bit reduction and the term totals' copy: neither
    grows with the node axis, and both fit at every size the rule picks
    for this repo's profiles."""
    cs = chain.stage_cluster(rows, H100_SMS, CARDS[card])
    for case in ("spread_affinity", "images_ports", "volumes"):
        prms = _stage_prm(case)
        for stage in ("normalize", "select"):
            prm = prms[stage]
            prm.N = n_nodes
            need = chain.stage_smem_bytes(prm, cs, stage)
            assert need == chain.stage_smem_bytes(prm, 1, stage) <= chain.MAX_SMEM_BYTES
            chain.check_stage_smem(prm, cs, stage)


def _carve_bytes(prm, size: int, stage: str) -> int:
    """The bytes carve_stage_cluster lays out for ``stage``, written out
    from csrc/chain_stages.cu field by field (8-byte words first): the
    image weights (E2), red64 [33] and cred64 [2] (E1, E2, E4 select), red
    [33 * RED_MAX] and cred [2 * RED_MAX] (E1, E2, E3), the term totals
    [T2] (E1, E2, E4 select), the spread constraints [MC] (E1, E2, E3),
    the domains' partial and combined arrays when they fit (E1, E2), the
    visit walk's scan [SCAN_INTS], counts [2 * 32] and ballots [2 * 32]
    (E4 window), one flag byte per node slot (E2, E4 window)."""
    slots = chain.cluster_slots(prm.N, size, chain.stage_threads(prm.N, size))
    dom = 2 * 4 * chain.domain_ints(prm) if prm.sp_smem else 0
    red64, red = 8 * 33 + 8 * 2, 4 * 33 * chain.RED_MAX + 4 * 2 * chain.RED_MAX
    tot, con = 4 * prm.T2, chain.SPREAD_CON_BYTES * prm.MC
    walk = 4 * chain.SCAN_INTS + 4 * 2 * 32 + 4 * 2 * 32
    return {"filter": red64 + red + tot + con + dom,
            "score": 8 * prm.I + red64 + red + tot + con + dom + slots,
            "normalize": red + con,
            "window": walk + slots,
            "select": red64 + tot}[stage]


@pytest.mark.parametrize("stage", ["filter", "score", "normalize", "select", "window"])
@pytest.mark.parametrize("n_nodes", NODES)
def test_stage_smem_mirror_equals_each_carve(n_nodes, stage):
    """kernels/chain.py stage_smem_bytes equals the carve's bytes, for the
    widest vocabularies the tests use and for a profile with no spread,
    inter-pod or image rows, at every cluster size."""
    for I, T2, MC, DMAX in ((64, 64, 8, 32), (0, 0, 0, 0), (3, 5, 2, 7)):
        prm = chain.ChainParams()
        prm.N, prm.I, prm.T2, prm.MC, prm.DMAX = n_nodes, I, T2, MC, DMAX
        prm.sp_smem = int(0 < 4 * chain.domain_ints(prm) <= chain.DOMAIN_SMEM_BYTES)
        for cs in sorted(SIZES):
            assert chain.stage_smem_bytes(prm, cs, stage) == _carve_bytes(prm, cs, stage)


def _launch_recorder(monkeypatch) -> list:
    """Fake the card: the wrappers take their launch path on CPU tensors,
    and each launch is recorded (stage, grid, forced cluster), not run."""
    calls = []

    def launch(stage, prm, sp, grid, cluster=0):
        calls.append((stage, grid, cluster, sp.commit))
        size = cluster or 16
        return {"cluster": size, "threads": 32, "smem_bytes": chain.stage_smem_bytes(prm, size, stage)}

    monkeypatch.setattr(chain_stages, "_device", lambda state: torch.device("cuda"))
    monkeypatch.setattr(chain_stages, "_tensor_device", lambda t: torch.device("cuda"))
    monkeypatch.setattr(chain_stages, "_launch", launch)
    return calls


def _e34_inputs(rows: int):
    nodes, pods, kw = case_inputs("spread_affinity")
    feats = Featurizer().featurize(nodes, pods, **kw)
    eng = Engine(feats, default_plugins(feats), record="full", device="cpu")
    staged = StagedProgram(eng._prog)
    batch = eng._pods
    idx = torch.arange(rows) % batch.valid.shape[0]
    batch = type(batch)(*(x[idx] for x in batch))
    state, aux = eng._node_state, eng._aux
    carries = eng._prog.init_carries(aux)
    ssub = staged.score_groups[0].sub
    ok = chain_stages.filter_stage_plain(staged.filter_groups[0].sub, state, batch.view(), aux, carries)[1]
    raw = chain_stages.score_stage_plain(ssub, state, batch.view(), aux, carries, ok)
    norm = chain_stages.normalize_stage_plain(ssub, state, batch.view(), aux, carries, raw, ok)
    weights = torch.tensor([sp.weight for sp in eng._prog.scores], dtype=torch.int32)
    return staged, state, batch, aux, carries, raw, norm, ok, weights


@pytest.mark.parametrize("forced", [0, 1, 2, 8, 16])
@pytest.mark.parametrize("rows", ROWS)
def test_normalize_and_select_launch_a_cluster_per_row(rows, forced, monkeypatch):
    """E3 and E4's selection launch on min(B, GRID_MAX) clusters of the
    forced size (0: the launch's choice), through the cluster launch, and
    keep what ran on ``.last``."""
    calls = _launch_recorder(monkeypatch)
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", forced)
    staged, state, batch, aux, carries, raw, norm, ok, weights = _e34_inputs(rows)
    ssub = staged.score_groups[0].sub
    chain_stages.normalize_stage(ssub, state, batch.view(), aux, carries, raw, ok)
    N = ok.shape[1]
    out = {"selected": torch.empty(rows, dtype=torch.int32), "total": torch.empty((rows, N), dtype=torch.int32)}
    chain_stages.select_stage(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, out)
    grid = min(rows, chain_stages.GRID_MAX)
    assert calls == [("normalize", grid, forced, 0), ("select", grid, forced, 0)]
    assert chain_stages.normalize_stage.last["cluster"] == chain_stages.select_stage.last["cluster"] == (forced or 16)


@pytest.mark.parametrize("forced", [0, 1, 2, 8, 16])
def test_committing_selection_is_one_cluster(forced, monkeypatch):
    """The committing selection (one pod of the scan) is one cluster, at
    any forced size; more than one pod is refused before any launch."""
    calls = _launch_recorder(monkeypatch)
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", forced)
    staged, state, batch, aux, carries, raw, norm, ok, weights = _e34_inputs(7)
    N = ok.shape[1]
    one = {"selected": torch.empty(1, dtype=torch.int32), "total": None}
    chain_stages.select_stage(staged.commit_sub, state, batch.rows(0, 1), aux, carries, norm[:1], weights, ok[:1], one,
                              commit=True)
    assert calls == [("select", 1, forced, 1)]
    seven = {"selected": torch.empty(7, dtype=torch.int32), "total": torch.empty((7, N), dtype=torch.int32)}
    with pytest.raises(ValueError, match="a committing selection takes one pod, not 7"):
        chain_stages.select_stage(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, seven, commit=True)
    assert len(calls) == 1


def test_normalize_and_select_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors E3 and E4's selection run their plain versions: no
    launch, no geometry."""
    launches = chain_stages.launches()
    staged, state, batch, aux, carries, raw, norm, ok, weights = _e34_inputs(7)
    ssub = staged.score_groups[0].sub
    got = chain_stages.normalize_stage(ssub, state, batch.view(), aux, carries, raw, ok)
    torch.testing.assert_close(got, norm, rtol=0, atol=0)
    N = ok.shape[1]
    outs = [{"selected": torch.empty(7, dtype=torch.int32), "total": torch.empty((7, N), dtype=torch.int32)}
            for _ in range(2)]
    chain_stages.select_stage(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, outs[0])
    chain_stages.select_stage_plain(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, outs[1])
    for key in outs[0]:
        torch.testing.assert_close(outs[0][key], outs[1][key], rtol=0, atol=0)
    assert chain_stages.launches() == launches


# ---- E4's window ------------------------------------------------------------------

def _window_prm(n_nodes: int) -> chain.ChainParams:
    """The window's ChainParams: the node axis alone (the wrapper sets no
    profile table)."""
    prm = chain.ChainParams()
    prm.N = n_nodes
    return prm


@pytest.mark.parametrize("n_nodes", NODES)
def test_window_shared_memory_fits_at_every_geometry_the_rule_picks(n_nodes):
    """The window holds the visit walk's scratch (768 bytes) and one flag
    byte per node slot: it fits one block at the size the rule picks for
    one row on either card and at every forced size, and equals the carve."""
    prm = _window_prm(n_nodes)
    sizes = {chain.stage_cluster(1, H100_SMS, fits) for fits in CARDS.values()} | SIZES
    assert {8, 16} <= sizes
    for cs in sorted(sizes):
        need = chain.stage_smem_bytes(prm, cs, "window")
        assert need == _carve_bytes(prm, cs, "window") <= chain.MAX_SMEM_BYTES
        assert need == 768 + chain.cluster_slots(n_nodes, cs, chain.stage_threads(n_nodes, cs))
        chain.check_stage_smem(prm, cs, "window")


@pytest.mark.parametrize("n_nodes", NODES)
@pytest.mark.parametrize("cs", sorted(SIZES))
def test_visit_walk_has_a_thread_for_each_warp_and_rank(cs, n_nodes):
    """ClusterTeam::piece_find deals the cluster tile's chunks, warp-major
    and rank-minor, one to a thread: nw * size <= threads at every block
    width the rule picks; the block's warp totals fit the scan scratch
    below its two answer slots (ints 40 and 41)."""
    nt = chain.stage_threads(n_nodes, cs)
    nw = nt // 32
    assert nt % 32 == 0 and nw * cs <= nt
    assert nw <= 40 and chain.SCAN_INTS >= 42
    # The tiles the walk crosses: one where a tile holds every real node.
    tile = cs * nt
    assert chain.cluster_slots(n_nodes, cs, nt) // nt == -(-n_nodes // tile)


def _window_inputs(n_nodes: int = 6144):
    ok = torch.zeros((1, n_nodes), dtype=torch.bool)
    ok[0, ::3] = True
    return ok, torch.tensor([7], dtype=torch.int32), torch.tensor([True]), n_nodes - 100, 5


@pytest.mark.parametrize("forced", [0, 1, 2, 8, 16])
def test_window_is_one_cluster(forced, monkeypatch):
    """The window launches one pod on one cluster of the forced size (0:
    the launch's choice), through the cluster launch, and keeps what ran
    on ``.last``; more than one pod row is refused before any launch."""
    calls = _launch_recorder(monkeypatch)
    monkeypatch.setattr(chain_stages, "STAGE_CLUSTER", forced)
    ok, start, valid, n_real, k = _window_inputs()
    chain_stages.window_stage(ok, start, valid, n_real, k)
    assert calls == [("window", 1, forced, 0)]
    last = chain_stages.window_stage.last
    assert last["cluster"] == (forced or 16)
    assert last["smem_bytes"] == chain.stage_smem_bytes(_window_prm(ok.shape[1]), forced or 16, "window")
    with pytest.raises(ValueError, match="the visit window takes one pod, not 2"):
        chain_stages.window_stage(ok.expand(2, -1), start, valid, n_real, k)
    assert len(calls) == 1


def test_window_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the window runs its plain version: no launch."""
    launches = chain_stages.launches()
    ok, start, valid, n_real, k = _window_inputs()
    got = chain_stages.window_stage(ok, start.clone(), valid, n_real, k)
    want = chain_stages.window_stage_plain(ok, start.clone(), valid, n_real, k)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert chain_stages.launches() == launches
