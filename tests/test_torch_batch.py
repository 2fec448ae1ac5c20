"""Kernel B's host-side model on the CPU (csrc/batch_eval.cu runs only on
the card, tests/test_torch_gpu.py): the pre-pass's node summary
(``node_summary_plain``) read pair by pair as the kernel reads it, with
each pod's words, against the chain's own records of the same pairs; the
persistent grid's pod striding; and the shared-memory layout, which has no
node bound of its own."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.kernels import batch_eval as be
from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.state.featurizer import Featurizer
import ksim_tpu_torch.engine.core as port_core
import ksim_tpu_torch.plugins.noderesources as port_res
import ksim_tpu_torch.plugins.volumes as port_vol
from test_torch_clusters import case_inputs, wide_cluster, wide_profile

torch.set_num_threads(1)

MASK64 = (1 << 64) - 1
G = {name: g for g, name in enumerate(be.GROUPS)}


def _engine(case: str):
    if case == "wide":
        nodes, pods, kw = wide_cluster(0)
        feats = Featurizer().featurize(nodes, pods, **kw)
        plugins = wide_profile("all", feats, port_core, port_res, port_vol, default_plugins)
    else:
        nodes, pods, kw = case_inputs(case)
        feats = Featurizer().featurize(nodes, pods, **kw)
        plugins = default_plugins(feats)
    return Engine(feats, plugins, record="full", device="cpu")


def _pod_words(aux, j: int) -> list[int]:
    """Pod j's words as csrc/batch_eval.cu stage_pod builds them (images:
    the images the pod runs; the kernel also drops zero weights)."""
    a, t, v, im, ip = aux["affinity"], aux["taints"], aux["volumes"], aux["imagelocality"], aux["interpod"]
    share = v["disk_ro_shareable"]
    any_, rw = v["pod_disk_any"][j], v["pod_disk_rw"][j]
    rows = [
        aux["nodeports"]["pod_wants"][j], ~t["pod_tolerated"][j], ~t["pod_tolerated_prefer"][j],
        a["required_terms"][j], im["pod_image_count"][j] != 0, v["pod_rwop"][j],
        (any_ & ~share) | (rw & share), any_ & ~rw & share, ip["req_anti"][j], ip["pod_term_match"][j],
        a["preferred_weights"][j] != 0, (ip["pref_w"][j] != 0) | ip["pod_term_match"][j],
    ]
    words = []
    for row in rows:
        packed = be.pack_words(row[None, :].bool())[:, 0]
        words += [int(w) & MASK64 for w in packed]
    return words


def _group(words: list[int], off: list[int], g: int) -> list[int]:
    return words[off[g]:off[g + 1]]


def _bits(ws: list[int]):
    for w, word in enumerate(ws):
        for b in range(64):
            if (word >> b) & 1:
                yield 64 * w + b


@pytest.mark.parametrize("case", ["seed0", "images_ports", "ports_commit", "spread_affinity", "volumes", "wide"])
def test_node_summary_read_per_pair_matches_the_chain(case):
    """Each reason code and raw score the kernel takes from the words (the
    node summary AND the pod's words) equals the chain's own record of
    that pair: TaintToleration's code (the untolerated taint of least node
    position) and raw score, NodeAffinity's two bits and raw score,
    NodePorts, VolumeRestrictions, InterPodAffinity's anti-affinity codes
    (pods without required affinity) and raw score, and NodeVolumeLimits
    for a pod with no volume rows (a pool already over its limit)."""
    eng = _engine(case)
    prog, state, aux = eng._prog, eng._node_state, eng._aux
    carries = prog.init_carries(aux)
    summary = be.node_summary_plain(prog, state, aux, carries)
    res = eng.evaluate_batch()
    off = be.word_offsets(be.group_sizes(aux))
    node_words = [[int(x) & MASK64 for x in summary["words"][:, n]] for n in range(summary["words"].shape[1])]
    fnames, snames = res.filter_plugin_names, res.plugin_names
    order = aux["taints"]["node_taint_order"]
    ipa, ipc = aux["interpod"], carries["InterPodAffinity"]
    pods, N = len(eng._feats.pods.keys), state.valid.shape[0]
    pairs = 0
    for j in range(pods):
        pw = _pod_words(aux, j)
        pref = aux["affinity"]["preferred_weights"][j]
        sel = int(aux["affinity"]["selector_term"][j])
        has_req = bool(aux["affinity"]["has_required"][j])
        no_vol = not bool(aux["volumes"]["pod_vol"][j].any())
        for n in range(N):
            nw = node_words[n]

            def both(g):
                return [a & b for a, b in zip(_group(nw, off, G[g]), _group(pw, off, G[g]))]

            ts = list(_bits(both("taint_forbid")))
            taint = 0
            if ts:
                taint = min(ts, key=lambda t: (int(order[n, t]), t)) + 1
            terms = _group(nw, off, G["terms"])
            aff = (sel < 0 or (terms[sel >> 6] >> (sel & 63)) & 1) and (
                not has_req or any(both("terms")))
            added_ok = bool(summary["flags"][n] & 1)
            pref_bits = [a & b for a, b in zip(terms, _group(pw, off, G["preferred"]))]
            want = {
                ("f", "TaintToleration"): taint,
                ("s", "TaintToleration"): sum(bin(x).count("1") for x in both("taint_prefer")),
                ("f", "NodeAffinity"): (0 if added_ok else 2) | (0 if aff else 1),
                ("s", "NodeAffinity"): int(summary["aff_added"][n]) + sum(int(pref[t]) for t in _bits(pref_bits)),
                ("f", "NodePorts"): int(any(both("ports"))),
                ("f", "VolumeRestrictions"): int(any(both("disk_any")) or any(both("disk_rw")))
                + 2 * int(any(both("rwop"))),
            }
            if not bool(ipa["req_aff"][j].any()):
                want[("f", "InterPodAffinity")] = (2 if any(both("interpod_cnt")) else
                                                   4 if any(both("interpod_ecnt")) else 0)
            raw = 0
            for term in _bits(_group(pw, off, G["interpod_raw"])):
                raw += int(ipc["cnt"][n, term]) * int(ipa["pref_w"][j, term])
                raw += int(ipc["ew"][n, term]) if bool(ipa["pod_term_match"][j, term]) else 0
            want[("s", "InterPodAffinity")] = (raw + 2**31) % 2**32 - 2**31  # int32 wrap
            if no_vol:
                for sp in prog.filters:
                    if chain.is_volume_limits(sp.plugin):
                        rooms = [int(summary["room"][k, n]) for k in sp.plugin.pool_ids]
                        want[("f", sp.plugin.name)] = int(any(r < 0 for r in rooms))
            for (kind, name), value in want.items():
                got = (res.reason_bits[j, fnames.index(name), n] if kind == "f"
                       else res.scores[j, snames.index(name), n])
                assert int(got) == value, (case, j, n, kind, name)
                pairs += 1
    assert pairs > 0


def test_node_summary_words_pack_64_to_a_word():
    """pack_words: bit b of word w is column 64 w + b, bit 63 included,
    padding bits zero."""
    rng = np.random.default_rng(0)
    bits = torch.from_numpy(rng.random((5, 130)) < 0.5)
    bits[:, 63] = True
    words = be.pack_words(bits)
    assert words.shape == (3, 5) and words.dtype == torch.int64
    for n in range(5):
        for c in range(130):
            assert (int(words[c // 64, n]) >> (c % 64)) & 1 == int(bits[n, c])
        assert int(words[2, n]) & MASK64 >> 2 == int(words[2, n]) & MASK64  # 2 bits used in the last word


@pytest.mark.parametrize("n_pods", [1, 5, 7, 8, 9, 23, 64])
def test_persistent_grid_strides_every_pod_once(n_pods):
    """Block b of a grid of g takes pods b, b + g, ...: every pod once, in
    order within a block, for P below, equal to and above the grid, and P
    not a multiple of it; no block is launched without a pod."""
    for per_sm, sms in ((1, 8), (4, 2), (4, 132)):
        grid = be.launch_grid(n_pods, per_sm, sms)
        assert grid == min(n_pods, per_sm * sms)
        seen = []
        for b in range(grid):
            pods = be.block_pods(n_pods, grid, b)
            assert pods and pods == sorted(pods)
            seen += pods
        assert sorted(seen) == list(range(n_pods))


def test_launch_grid_refuses_a_shape_the_card_cannot_hold():
    with pytest.raises(RuntimeError, match="0 blocks per SM"):
        be.launch_grid(10, 0, 132)


def _layout(n: int, *, mc=2, dmax=3, images=8, terms=16):
    prm = chain.ChainParams()
    prm.N, prm.I, prm.MC, prm.DMAX, prm.sp_smem, prm.T = n, images, mc, dmax, 1, terms
    sp = be.SummaryParams()
    for g, o in enumerate(be.word_offsets((8, 8, 8, terms, images, 8, 8, 8, 8, 8, terms, 8))):
        sp.off[g] = o
    return prm, sp


def test_batch_smem_main_shape_holds_four_blocks_per_sm():
    """At the main path's 6144 padded nodes the block's shared memory is
    the pod's staged rows, reductions and spread scratch alone (the 5 bytes
    per node live in a global row per block), and four blocks fit an SM's
    228 KB."""
    prm, sp = _layout(6144)
    fixed = 8 * 12 + 8 * 8 + 8 * 33 + 4 * 33 * chain.RED_MAX + 4 * chain.SCAN_INTS + 32 * 2 + 4 * 4 * 2 * 3 + 4 * 16 + 4
    assert be.batch_fixed_bytes(prm, sp) == fixed
    assert be.batch_smem_bytes(prm, sp) == (fixed + 7) & ~7
    assert be.MIN_BLOCKS * (be.batch_smem_bytes(prm, sp) + be.BLOCK_RESERVED_BYTES) <= be.SM_SMEM_BYTES


@pytest.mark.parametrize("n", [24_576, 278_529, 1_000_000])
def test_batch_smem_has_no_node_bound(n):
    """At 24,576 nodes (above the old one-block bound of about 17,590) and
    past kernel A's cluster bound, the block's shared memory is what it is
    at 6144 nodes: it does not grow with N."""
    prm, sp = _layout(n)
    assert be.batch_smem_bytes(prm, sp) == be.batch_smem_bytes(*_layout(6144))
    assert be.batch_smem_bytes(prm, sp) == (be.batch_fixed_bytes(prm, sp) + 7) & ~7
    assert be.batch_smem_bytes(prm, sp) < 8192
