"""Kernel D wrapper: K churn-replay steps in one launch, S lanes in one
launch, and row 6 alone.

``replay_segment(st, prog, const, ev, state0)`` runs the segment program
of ``ksim_tpu/engine/replay.py _segment_body`` for ``st.k`` steps: event
application, the flush and backoff rules, the queue, InterPodAffinity's
domain view, the plugin chain with the minimal-rank selectHost, the
commit, and with ``st.preempt`` DefaultPreemption's victim search; with
``st.record == "full"`` every attempt's reason codes, raw scores and
finals are recorded.  It returns ``(final_state, outs)``; its inputs are
never modified.  ``replay_segment_fleet`` runs S lanes of it in one
launch (the reference's ``_fleet_segment_fn``): ``state0`` gains a
leading lane axis, ``const`` and ``ev`` are shared.
``derive_interpod(loc, ipa, n_tk, n_dom)`` is the domain-view derivation
(``_derive_interpod``) alone.

The trees are the lowering's (engine/replay.py ``segment_from_arrays``):

- ``const``: ``node`` (allocatable, allowed_pods, unschedulable),
  ``pods`` (requests, nonzero_requests, tolerates_unschedulable,
  has_requests; with preemption priority, imp_rank, start_rank,
  preempt_ok) over the P universe rows, ``aux`` (the engine's device
  aux, engine/core.py ``device_aux``); with preemption
  ``empty_start_rank`` and, under record="full", ``resolv`` [F, W] (a
  reason code resolvable by preemption, per filter);
- ``ev``: leading axis K — ``pod_create`` / ``pod_delete`` /
  ``node_create`` / ``node_delete`` index lists padded with -1, ``rank``
  [K, N], ``flush`` and ``active`` [K]; with preemption ``name_rank``
  [K, N] (live name order) and ``want`` [K] (upstream's candidate count);
- ``state0``: valid [N], requested / nonzero_requested [N, R], pod_count
  [N], alive / bound / attempts / retry_at / nominated [P], spread
  [N, S], ip_cnt / ip_eat / ip_vw [N, T] (node-local term counts),
  pass_count (0-d).

``outs``: sel / idx [K, Q] and scheduled / unschedulable / eligible /
pass_count / pending_after [K], all int32; with preemption nom [K, Q]
(the nominated node, -1), vic [K, Q, v_eff] (victim rows in reprieve
order, -1) and overflow [K] (a search past the bounds); under
record="full" bits / raw / final [K, Q, F|S, N] in the dtypes of
engine/core.py ``_Program.dtypes`` (rows that no attempt used are 0).

Tensors on the CPU take the plain versions; tensors on a CUDA device
launch csrc/replay_segment.cu (kernel D, and its standalone
``derive_interpod`` entry).  Each lane of kernel D runs on one
thread-block cluster: the solo launch takes 16 blocks where the card's
occupancy query finds room, else 8; the fleet launch the largest of 16, 8,
4 and 2 at which every lane's cluster is resident at once
(``choose_cluster``, from the card's answers per size).  ``CLUSTER_SIZE`` and
``CLUSTER_THREADS`` force a size and a block width, for tests and timing;
what the last launch ran (cluster, threads, shared memory, and the stats
counted on the card) is kept in ``replay_segment.last`` and
``replay_segment_fleet.last``, and per thread in ``take_launch_notes()``
(the replay driver's dispatch worker reads its own launch's there).  A
kernel that fails to build or launch raises, a refused cluster launch
included; it never falls back to a smaller launch or to the plain
version.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch

from ksim_tpu_torch.kernels import build, chain
from ksim_tpu_torch.plugins.base import NodeStateView, PodBatch, PodView

_I32_MIN = torch.iinfo(torch.int32).min
_I32_MAX = torch.iinfo(torch.int32).max

# Row 6's domain scratch (a partial and a combined copy per block) up to
# this many bytes lives in shared memory, more in a global buffer.
DERIVE_SMEM_BYTES = 32768
# csrc/replay_segment.cu: the victim search's bounds (the reference's
# PREEMPT_CANDIDATES and PREEMPT_VICTIMS); a search past them discards
# the segment.
MAX_CANDIDATES = 16
MAX_VICTIMS = 8
# csrc/replay_segment.cu SearchSmem: the candidate and victim lists, the
# pick's keys, the victims per candidate, three counters.
SEARCH_SMEM_BYTES = 4 * (MAX_CANDIDATES + MAX_VICTIMS + 6 * MAX_CANDIDATES + MAX_CANDIDATES * MAX_VICTIMS + 3)
# Kernel D's cluster: its size (0: the occupancy query's choice among
# SOLO_SIZES for the solo launch, LANE_SIZES for the fleet launch) and
# threads per block (0: chain.cluster_threads, one node slot each).
CLUSTER_SIZE = 0
CLUSTER_THREADS = 0
SOLO_SIZES = (16, 8)
LANE_SIZES = (16, 8, 4, 2)


@dataclass(frozen=True)
class SegmentStatics:
    """The static configuration of one segment program."""

    k: int  # steps per launch
    q: int  # attempted-queue width
    cap: int  # max_pods_per_pass (a large sentinel when uncapped)
    n_tk: int  # inter-pod topology-key vocabulary width
    n_dom: int  # inter-pod padded domain count (segment id space)
    max_backoff: int = 16  # SchedulerService.MAX_BACKOFF_PASSES
    flush_cap: int = 4  # SchedulerService.FLUSH_CAP_PASSES
    record: str = "selection"  # "selection" | "full" (per-attempt results)
    preempt: bool = False  # DefaultPreemption's victim search

    @staticmethod
    def c_eff(n_nodes: int) -> int:
        """The candidate bound over a padded node axis of ``n_nodes``."""
        return min(MAX_CANDIDATES, n_nodes)

    @staticmethod
    def v_eff(n_pods: int) -> int:
        """The victim bound over a universe of ``n_pods`` rows."""
        return min(MAX_VICTIMS, n_pods)

    @property
    def shift_cap(self) -> int:
        """The backoff delay is min(2 ** min(attempts, shift_cap), max):
        the exponent clamped where the cap saturates."""
        return max(self.max_backoff.bit_length() - 1, 0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def derive_interpod_plain(loc: dict, ipa: dict, n_tk: int, n_dom: int) -> dict:
    """InterPodAffinity's domain view from node-local term counts, key by
    key with one integer segment sum each (replay.py:459-489)."""
    node_dom = ipa["node_dom"]  # i32 [N, TK]
    term_tk = ipa["term_tk"]  # i32 [T]
    dom_t = ipa["dom_t"]  # i32 [N, T]
    out = {}
    for name, key in (("cnt", "cnt"), ("ecnt", "eat"), ("ew", "vw")):
        arr = loc[key]  # i32 [N, T]
        acc = torch.zeros_like(arr)
        for k in range(n_tk):
            ids = node_dom[:, k]
            safe = torch.where(ids >= 0, ids, n_dom).long()
            seg = torch.zeros((n_dom + 1, arr.shape[1]), dtype=arr.dtype, device=arr.device)
            seg.index_add_(0, safe, arr)
            derived = torch.where(ids[:, None] >= 0, seg[safe], 0)
            acc = torch.where((term_tk == k)[None, :], derived, acc)
        out[name] = acc
    out["total"] = torch.where(dom_t >= 0, loc["cnt"], 0).sum(dim=0, dtype=torch.int32)
    return out


def _select_ranked(ok: torch.Tensor, total: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """selectHost with the canonical-slot tie-break: the max total, then
    the minimal rank (argmin: the lowest index of the minimal value over
    the whole node axis); -1 when nothing is feasible."""
    masked = torch.where(ok, total, _I32_MIN)
    cand = ok & (masked == masked.max())
    best = torch.where(cand, rank, _I32_MAX).argmin().to(torch.int32)
    return torch.where(ok.any(), best, -1).to(torch.int32)


_LIVE_KEYS = (
    "alive", "bound", "requested", "nonzero_requested", "pod_count", "spread",
    "ip_cnt", "ip_eat", "ip_vw", "nominated",
)


def _skip_outputs(st: SegmentStatics, prog, P: int, N: int, pass_count, device) -> dict:
    z = torch.zeros((), dtype=torch.int32, device=device)
    out = {
        "sel": torch.full((st.q,), -1, dtype=torch.int32, device=device),
        "idx": torch.full((st.q,), P, dtype=torch.int32, device=device),
        "scheduled": z,
        "unschedulable": z,
        "eligible": z,
        "pass_count": pass_count.clone(),
        "pending_after": z,
    }
    if st.preempt:
        out["nom"] = torch.full((st.q,), -1, dtype=torch.int32, device=device)
        out["vic"] = torch.full((st.q, st.v_eff(P)), -1, dtype=torch.int32, device=device)
        out["overflow"] = torch.zeros((), dtype=torch.bool, device=device)
    if st.record == "full":
        out.update(_record_buffers(prog, (st.q,), N, device))
    return out


def _record_buffers(prog, lead: tuple, N: int, device) -> dict:
    """Zeroed bits / raw / final of record="full", leading shape ``lead``."""
    bits_dtype, final_dtype, raw_dtype = prog.dtypes
    F, S = len(prog.filters), len(prog.scores)
    return {
        "bits": torch.zeros((*lead, F, N), dtype=bits_dtype, device=device),
        "raw": torch.zeros((*lead, S, N), dtype=raw_dtype, device=device),
        "final": torch.zeros((*lead, S, N), dtype=final_dtype, device=device),
    }


class _PodRows:
    """The universe's per-pod rows that event application, binds and the
    victim search add into node state."""

    def __init__(self, const: dict) -> None:
        aux, prow = const["aux"], const["pods"]
        self.prow = prow
        self.sel = aux["spread"]["pod_sel_match"]
        self.qm = aux["interpod"]["pod_term_match"]
        self.eat = aux["interpod"]["pod_eat"]
        self.vw = aux["interpod"]["pod_vw"]

    def bind_live(self, live: dict, j: int, best: int) -> None:
        """One attempt's bind into the live view (replay.py _bind_live;
        a failed attempt changes nothing)."""
        if best < 0:
            return
        i32 = torch.int32
        live["requested"][best] += self.prow["requests"][j]
        live["nonzero_requested"][best] += self.prow["nonzero_requests"][j]
        live["pod_count"][best] += 1
        live["spread"][best] += self.sel[j].to(i32)
        live["ip_cnt"][best] += self.qm[j].to(i32)
        live["ip_eat"][best] += self.eat[j]
        live["ip_vw"][best] += self.vw[j]
        live["bound"][j] = best
        live["nominated"][j] = False

    def deltas(self, rows: torch.Tensor) -> dict:
        """The summed rows of ``rows`` (replay.py _victim_deltas)."""
        i32 = torch.int32
        return {
            "req": self.prow["requests"][rows].sum(0, dtype=i32),
            "nz": self.prow["nonzero_requests"][rows].sum(0, dtype=i32),
            "cnt": int(rows.numel()),
            "sel": self.sel[rows].to(i32).sum(0, dtype=i32),
            "qm": self.qm[rows].to(i32).sum(0, dtype=i32),
            "eat": self.eat[rows].sum(0, dtype=i32),
            "vw": self.vw[rows].sum(0, dtype=i32),
        }


def _sub_at(live: dict, n: int, d: dict) -> dict:
    """``live``'s node-state arrays with ``d`` taken off node ``n`` (copies)."""
    out = {}
    for key, dk in (("requested", "req"), ("nonzero_requested", "nz"), ("spread", "sel"),
                    ("ip_cnt", "qm"), ("ip_eat", "eat"), ("ip_vw", "vw")):
        t = live[key].clone()
        t[n] -= d[dk]
        out[key] = t
    pc = live["pod_count"].clone()
    pc[n] -= d["cnt"]
    out["pod_count"] = pc
    return out


def _preempt_search_plain(st, prog, const, rows: _PodRows, valid, live: dict, j: int,
                          bits_mat, name_rank, want: int):
    """DefaultPreemption's victim search for attempt ``j`` against the
    live view (replay.py _preempt_search); updates ``live`` and returns
    (nominated node, victim rows [v_eff], overflow)."""
    aux, nstat, prow = const["aux"], const["node"], const["pods"]
    ipa = aux["interpod"]
    P = prow["requests"].shape[0]
    N = nstat["allocatable"].shape[0]
    dev = valid.device
    c_eff, v_eff = st.c_eff(N), st.v_eff(P)
    prio = prow["priority"]
    lower = live["alive"] & (live["bound"] >= 0) & (prio < prio[j])
    if st.record == "full":
        fail = bits_mat != 0  # [F, N]
        first = fail.to(torch.int32).argmax(0)
        bval = bits_mat.gather(0, first[None, :])[0].to(torch.int64)
        resolv = const["resolv"]
        bval = bval.clamp(0, resolv.shape[1] - 1)
        resolvable = resolv[first.long(), bval] & fail.any(0)
    else:
        resolvable = torch.ones(N, dtype=torch.bool, device=dev)
    vcnt = torch.zeros(N, dtype=torch.int32, device=dev)
    vcnt.index_add_(0, live["bound"][lower].long(), torch.ones(int(lower.sum()), dtype=torch.int32, device=dev))
    examine = (vcnt > 0) & valid & resolvable
    over = int(examine.sum()) > c_eff
    ex = torch.nonzero(examine)[:, 0]
    cands = ex[torch.argsort(name_rank[ex], stable=True)][:c_eff].tolist()
    pod = PodView(
        requests=prow["requests"][j : j + 1],
        nonzero_requests=prow["nonzero_requests"][j : j + 1],
        tolerates_unschedulable=prow["tolerates_unschedulable"][j : j + 1],
        has_requests=prow["has_requests"][j : j + 1],
        index=torch.tensor([j], dtype=torch.int32, device=dev),
    )

    def eval_fit(n: int, vrows: list[int]) -> bool:
        # The preemptor's filter chain at n with the victims' rows taken
        # off n (spread and inter-pod re-derive from the modified locals).
        mod = _sub_at(live, n, rows.deltas(torch.tensor(vrows, dtype=torch.long, device=dev)))
        view = NodeStateView(
            allocatable=nstat["allocatable"],
            allowed_pods=nstat["allowed_pods"],
            valid=valid,
            unschedulable=nstat["unschedulable"],
            requested=mod["requested"],
            nonzero_requested=mod["nonzero_requested"],
            pod_count=mod["pod_count"],
        )
        carries = prog.init_carries(aux)
        carries["PodTopologySpread"] = mod["spread"]
        carries["InterPodAffinity"] = derive_interpod_plain(
            {"cnt": mod["ip_cnt"], "eat": mod["ip_eat"], "vw": mod["ip_vw"]}, ipa, st.n_tk, st.n_dom
        )
        ok, _bits = prog.eval_filters(view, pod, aux, carries)
        return bool(ok[0, n])

    imp = prow["imp_rank"]
    found = []  # (is_c, max prio, prio sum, count, start rank, name rank, node, victim rows)
    for n in cands:
        on_n = torch.nonzero(lower & (live["bound"] == n))[:, 0]
        on_n = on_n[torch.argsort(imp[on_n], stable=True)]
        over = over or on_n.numel() > v_eff
        vrows = on_n[:v_eff].tolist()
        fit0 = eval_fit(n, vrows)
        removed = list(range(len(vrows)))
        vic = [False] * len(vrows)
        for v in range(len(vrows)):
            test = [u for u in removed if u != v]
            if eval_fit(n, [vrows[u] for u in test]):
                removed = test  # reprieved
            else:
                vic[v] = True
        vp = [int(prio[vrows[v]]) for v in range(len(vrows)) if vic[v]]
        if vp:
            maxp = max(vp)
            est = min(int(prow["start_rank"][vrows[v]]) for v in range(len(vrows))
                      if vic[v] and int(prio[vrows[v]]) == maxp)
        else:
            maxp, est = _I32_MIN, int(const["empty_start_rank"])
        vsum = (sum(vp) + 2**31) % 2**32 - 2**31  # the reference's int32 sum
        found.append((fit0, maxp, vsum, len(vp), est, int(name_rank[n]), n,
                      [vrows[v] if vic[v] else -1 for v in range(len(vrows))]))
    # pickOneNodeForPreemption: the first `want` fitting candidates in
    # discovery order, then the lexicographic narrowing.
    keep = [f for f in found if f[0]][:want]
    vic_rows = [-1] * v_eff
    if not keep:
        return -1, vic_rows, over
    for pos, take_min in ((1, True), (2, True), (3, True), (4, False), (5, True)):
        tgt = (min if take_min else max)(f[pos] for f in keep)
        keep = [f for f in keep if f[pos] == tgt]
    best = keep[0]
    nom = best[6]
    vic_rows[: len(best[7])] = best[7]
    gone = [r for r in best[7] if r >= 0]
    mod = _sub_at(live, nom, rows.deltas(torch.tensor(gone, dtype=torch.long, device=dev)))
    live.update(mod)
    for r in gone:
        live["alive"][r] = False
        live["bound"][r] = -1
    live["nominated"][j] = True
    return nom, vic_rows, over


def replay_segment_plain(st: SegmentStatics, prog, const: dict, ev: dict, state0: dict):
    """The plain PyTorch version: the reference's steps one by one, the
    pods of a step in a Python loop of [N]-wide tensor ops."""
    aux, nstat, prow = const["aux"], const["node"], const["pods"]
    ipa = aux["interpod"]
    P = prow["requests"].shape[0]
    N = nstat["allocatable"].shape[0]
    dev = prow["requests"].device
    rows = _PodRows(const)
    sel_rows, qm_rows, eat_rows, vw_rows = rows.sel, rows.qm, rows.eat, rows.vw
    full = st.record == "full"
    v_eff = st.v_eff(P)
    s = {k: v.clone() for k, v in state0.items()}
    outs = []
    for k in range(st.k):
        evk = {name: t[k] for name, t in ev.items()}
        if not bool(evk["active"]):
            outs.append(_skip_outputs(st, prog, P, N, s["pass_count"], dev))
            continue
        # Pod deletes: the bound node's rows lose the pod's.
        pdel = evk["pod_delete"]
        pdel = pdel[pdel >= 0].long()
        bnode = s["bound"][pdel]
        hit = bnode >= 0
        rows_d, tgt = pdel[hit], bnode[hit].long()
        s["requested"].index_add_(0, tgt, -prow["requests"][rows_d])
        s["nonzero_requested"].index_add_(0, tgt, -prow["nonzero_requests"][rows_d])
        s["pod_count"].index_add_(0, tgt, -torch.ones_like(tgt, dtype=torch.int32))
        s["spread"].index_add_(0, tgt, -sel_rows[rows_d].to(torch.int32))
        s["ip_cnt"].index_add_(0, tgt, -qm_rows[rows_d].to(torch.int32))
        s["ip_eat"].index_add_(0, tgt, -eat_rows[rows_d])
        s["ip_vw"].index_add_(0, tgt, -vw_rows[rows_d])
        s["alive"][pdel] = False
        s["bound"][pdel] = -1
        # Node drains and creates; drained nodes' pods requeue.
        ndel = evk["node_delete"]
        dmask = torch.zeros(N, dtype=torch.bool, device=dev)
        dmask[ndel[ndel >= 0].long()] = True
        keep = ~dmask
        s["valid"] = s["valid"] & keep
        for name in ("requested", "nonzero_requested", "spread", "ip_cnt", "ip_eat", "ip_vw"):
            s[name] = torch.where(keep[:, None], s[name], 0)
        s["pod_count"] = torch.where(keep, s["pod_count"], 0)
        requeued = s["alive"] & (s["bound"] >= 0) & dmask[s["bound"].clamp(0, N - 1).long()]
        s["bound"] = torch.where(requeued, -1, s["bound"])
        ncre = evk["node_create"]
        s["valid"][ncre[ncre >= 0].long()] = True
        pcre = evk["pod_create"]
        s["alive"][pcre[pcre >= 0].long()] = True
        # Flush (capped remaining wait, from the pre-pass count); the pass.
        has_entry = s["attempts"] > 0
        if bool(evk["flush"]):
            flushed = torch.minimum(
                s["retry_at"], s["pass_count"] + torch.clamp(s["attempts"] - 1, max=st.flush_cap)
            )
            s["retry_at"] = torch.where(has_entry, flushed, s["retry_at"])
        any_valid = bool(s["valid"].any())
        pc = s["pass_count"] + int(any_valid)
        s["pass_count"] = pc
        # The queue: pending, not backed off, in universe order.
        in_backoff = has_entry & (s["retry_at"] >= pc)
        elig = s["alive"] & (s["bound"] < 0) & ~in_backoff
        pos = torch.cumsum(elig.to(torch.int32), 0) - 1
        att = elig & (pos < min(st.cap, st.q)) & any_valid
        idx_q = torch.full((st.q,), P, dtype=torch.int32, device=dev)
        idx_q[pos[att].long()] = torch.arange(P, dtype=torch.int32, device=dev)[att]
        n_att = int(att.sum())
        # The victim search's live view starts from the pre-pass state.
        live0 = {key: s[key].clone() for key in _LIVE_KEYS} if st.preempt else None
        # The chain over the attempted pods, committing each.
        state = NodeStateView(
            allocatable=nstat["allocatable"],
            allowed_pods=nstat["allowed_pods"],
            valid=s["valid"],
            unschedulable=nstat["unschedulable"],
            requested=s["requested"],
            nonzero_requested=s["nonzero_requested"],
            pod_count=s["pod_count"],
        )
        carries = prog.init_carries(aux)
        carries["PodTopologySpread"] = s["spread"]
        carries["InterPodAffinity"] = derive_interpod_plain(
            {"cnt": s["ip_cnt"], "eat": s["ip_eat"], "vw": s["ip_vw"]}, ipa, st.n_tk, st.n_dom
        )
        sel = torch.full((st.q,), -1, dtype=torch.int32, device=dev)
        rec = _record_buffers(prog, (st.q,), N, dev) if full else None
        bits_dtype, final_dtype, raw_dtype = prog.dtypes
        for qq in range(n_att):
            j = int(idx_q[qq])
            pod = PodView(
                requests=prow["requests"][j : j + 1],
                nonzero_requests=prow["nonzero_requests"][j : j + 1],
                tolerates_unschedulable=prow["tolerates_unschedulable"][j : j + 1],
                has_requests=prow["has_requests"][j : j + 1],
                index=idx_q[qq : qq + 1],
            )
            ok, bits, raw, final, total = prog.eval_block(state, pod, aux, carries)
            best = _select_ranked(ok[0], total[0], evk["rank"])
            state = state.commit(best, prow["requests"][j], prow["nonzero_requests"][j])
            carries = prog.commit_carries(carries, pod, best, aux)
            sel[qq] = best
            if full:
                for name, xs, dtype in (("bits", bits, bits_dtype), ("raw", raw, raw_dtype),
                                        ("final", final, final_dtype)):
                    if xs:
                        rec[name][qq] = torch.stack([x[0].to(dtype) for x in xs])
        s["requested"] = state.requested
        s["nonzero_requested"] = state.nonzero_requested
        s["pod_count"] = state.pod_count
        s["spread"] = carries["PodTopologySpread"]
        live_mask = idx_q < P
        bound_mask = live_mask & (sel >= 0)
        fail_mask = live_mask & (sel < 0)
        b_rows = idx_q[bound_mask].long()
        nom = torch.full((st.q,), -1, dtype=torch.int32, device=dev)
        vic = torch.full((st.q, v_eff), -1, dtype=torch.int32, device=dev)
        overflow = False
        if st.preempt:
            # The pass again, in queue order, against the live view (this
            # pass's binds so far, the victims removed so far), with the
            # victim search for each failed attempt that may preempt; the
            # live view is the step's end state.
            live = {key: t.clone() for key, t in live0.items()}
            for qq in range(n_att):
                j, best = int(idx_q[qq]), int(sel[qq])
                rows.bind_live(live, j, best)
                lower = live["alive"] & (live["bound"] >= 0) & (prow["priority"] < prow["priority"][j])
                if best >= 0 or not bool(prow["preempt_ok"][j]) or not bool(lower.any()):
                    continue
                n_nom, vrows, over = _preempt_search_plain(
                    st, prog, const, rows, s["valid"], live, j,
                    rec["bits"][qq] if full else None, evk["name_rank"], int(evk["want"]),
                )
                nom[qq] = n_nom
                vic[qq] = torch.tensor(vrows, dtype=torch.int32, device=dev)
                overflow = overflow or over
            for key in _LIVE_KEYS:
                s[key] = live[key]
        else:
            # Step end: binds into the node-local counts and the pod rows.
            b_nodes = sel[bound_mask].long()
            s["ip_cnt"].index_add_(0, b_nodes, qm_rows[b_rows].to(torch.int32))
            s["ip_eat"].index_add_(0, b_nodes, eat_rows[b_rows])
            s["ip_vw"].index_add_(0, b_nodes, vw_rows[b_rows])
            s["bound"][b_rows] = sel[bound_mask]
            s["nominated"][b_rows] = False
        # Backoff: success pops the entry, failure doubles the delay
        # (capped) unless the pod holds a nomination.
        f_rows = idx_q[fail_mask].long()
        a_prev = s["attempts"][f_rows]
        nomd = s["nominated"][f_rows]
        delay = torch.clamp(
            torch.bitwise_left_shift(torch.ones_like(a_prev), torch.clamp(a_prev, max=st.shift_cap)),
            max=st.max_backoff,
        )
        s["attempts"][b_rows] = 0
        s["retry_at"][b_rows] = 0
        s["attempts"][f_rows] = torch.where(nomd, 0, a_prev + 1)
        s["retry_at"][f_rows] = torch.where(nomd, 0, pc + delay).to(torch.int32)
        out = {
            "sel": sel,
            "idx": idx_q,
            "scheduled": bound_mask.sum(dtype=torch.int32),
            "unschedulable": fail_mask.sum(dtype=torch.int32),
            "eligible": (elig.sum(dtype=torch.int32) if any_valid else torch.zeros((), dtype=torch.int32, device=dev)),
            "pass_count": pc.clone(),
            "pending_after": (s["alive"] & (s["bound"] < 0)).sum(dtype=torch.int32),
        }
        if st.preempt:
            out.update(nom=nom, vic=vic, overflow=torch.tensor(overflow, device=dev))
        if full:
            out.update(rec)
        outs.append(out)
    return s, {name: torch.stack([o[name] for o in outs]) for name in outs[0]}


def replay_segment_fleet_plain(st: SegmentStatics, prog, const: dict, ev: dict, state0: dict):
    """Rows 10-11's plain version: ``replay_segment_plain`` once per lane.
    ``state0`` carries a leading lane axis on every leaf; ``const`` and
    ``ev`` are shared.  Returns (final state, outs), each leaf stacked
    along the lane axis."""
    lanes = state0["valid"].shape[0]
    runs = [replay_segment_plain(st, prog, const, ev, {k: v[i] for k, v in state0.items()})
            for i in range(lanes)]
    return (
        {k: torch.stack([r[0][k] for r in runs]) for k in runs[0][0]},
        {k: torch.stack([r[1][k] for r in runs]) for k in runs[0][1]},
    )


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_L = ctypes.c_longlong


class DeriveParams(ctypes.Structure):
    """Mirror of ``struct DeriveParams`` (csrc/derive_interpod.cuh)."""

    _fields_ = (
        [(name, _P) for name in (
            "loc_cnt", "loc_eat", "loc_vw", "node_dom", "dom_t", "term_tk", "ldom", "singleton",
            "cnt", "ecnt", "ew", "total", "scratch",
        )]
        + [(name, _L) for name in ("N", "T2", "TKI", "DK", "dsmem")]
    )


class SegmentParams(ctypes.Structure):
    """Mirror of ``struct SegmentParams`` (csrc/replay_segment.cu)."""

    _fields_ = (
        [("chain", chain.ChainParams), ("derive", DeriveParams)]
        + [(name, _P) for name in (
            "valid", "alive", "bound", "attempts", "retry_at", "nominated", "spread",
            "ip_cnt", "ip_eat", "ip_vw", "pass_count",
            "ports_init", "attached_init", "rwop_init", "disk_any_init", "disk_rw_init",
            "ev_pc", "ev_pd", "ev_nc", "ev_nd", "ev_rank", "ev_flush", "ev_active",
            "out_sel", "out_idx", "out_scheduled", "out_unsched", "out_eligible",
            "out_pass", "out_pending", "derive_runs",
            "priority", "imp_order", "start_rank", "preempt_ok", "resolv",
            "ev_name_rank", "ev_want",
            "snap_req", "snap_nz", "snap_pc", "snap_spread", "name_order", "vcnt",
            "out_nom", "out_vic", "out_over",
        )]
        + [(name, _L) for name in (
            "K", "Q", "cap", "P", "Wpc", "Wpd", "Wnc", "Wnd",
            "max_backoff", "flush_cap", "shift_cap",
            "preempt", "CE", "VE", "empty_start_rank", "resolv_f", "resolv_w",
        )]
    )


def _align16(x: int) -> int:
    return (x + 15) & ~15


# The lanes kernel's static shared memory (csrc/replay_segment.cu
# segment_static_smem): its lane's params and the search's working set.
STATIC_SMEM_BYTES = _align16(ctypes.sizeof(SegmentParams)) + _align16(SEARCH_SMEM_BYTES)


def _load():
    lib = build.load("replay_segment")
    if not getattr(lib, "_ksim_segment_checked", False):
        for entry, want in (("ksim_segment_params_size", ctypes.sizeof(SegmentParams)),
                            ("ksim_derive_params_size", ctypes.sizeof(DeriveParams)),
                            ("ksim_segment_static_smem", STATIC_SMEM_BYTES)):
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_longlong
            if fn() != want:
                raise RuntimeError(f"{entry}: csrc/ says {fn()}, kernels/replay_segment.py {want}")
        lib.ksim_derive_interpod.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ksim_derive_interpod.restype = ctypes.c_int
        lib.ksim_segment_smem.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.ksim_segment_smem.restype = ctypes.c_longlong
        lib.ksim_segment_fits.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.ksim_segment_fits.restype = ctypes.c_int
        lib._ksim_segment_checked = True
    return lib


def choose_cluster(n_lanes: int, fits, sizes: tuple[int, ...]) -> int:
    """The cluster size kernel D's launch takes: the first of ``sizes`` at
    which ``fits(size)`` (the card's occupancy query, csrc/replay_segment.cu
    ``ksim_segment_fits``: clusters of that size resident at once; 0 where
    the card refuses the shape) holds all ``n_lanes``, else the one at
    which it holds the most, the earlier (larger) on a tie."""
    pick, most = sizes[0], -1
    for size in sizes:
        n = fits(size)
        if n >= n_lanes:
            return size
        if n > most:
            pick, most = size, n
    return pick


@dataclass(frozen=True)
class DeriveLayout:
    """Row 6's view of one node axis, fixed while the nodes' domains are:
    which topology keys are singleton keys (every domain one node), and
    each node's compact domain index under the other keys."""

    ldom: torch.Tensor  # i32 [N, TKI]; -1 = key missing, or a singleton key
    singleton: tuple[bool, ...]  # [TKI]
    dk: int  # the widest non-singleton key's domain count (at least 1)
    singleton_mask: torch.Tensor  # u8 [TKI], the kernel's copy of ``singleton``


def derive_layout(node_dom: torch.Tensor) -> DeriveLayout:
    """The layout of ``node_dom`` (i32 [N, TKI], any number of keys), with
    small tensor ops."""
    N, TKI = node_dom.shape
    ldom = torch.full((N, TKI), -1, dtype=torch.int32, device=node_dom.device)
    singleton = []
    dk = 1
    for k in range(TKI):
        ids = node_dom[:, k]
        keyed = ids >= 0
        uniq, inv = torch.unique(ids[keyed], return_inverse=True)
        single = uniq.numel() == int(keyed.sum())
        singleton.append(single)
        if not single:
            ldom[keyed, k] = inv.to(torch.int32)
            dk = max(dk, uniq.numel())
    mask = torch.tensor(singleton, dtype=torch.uint8, device=node_dom.device).reshape(TKI)
    return DeriveLayout(ldom=ldom, singleton=tuple(singleton), dk=dk, singleton_mask=mask)


def derive_scratch_ints(T2: int, dk: int) -> int:
    """One block's partial of row 6 (csrc/derive_interpod.cuh): [3, T2,
    dk] domain sums, then [T2] totals."""
    return 3 * T2 * dk + T2


def _derive_params(loc: dict, ipa: dict, out: dict, keep: list, layout: DeriveLayout) -> DeriveParams:
    """DeriveParams over ``loc`` (cnt / eat / vw) into ``out`` (cnt / ecnt
    / ew / total), with ``layout`` from ``derive_layout(ipa["node_dom"])``."""
    i32 = torch.int32
    node_dom = ipa["node_dom"]
    dev = node_dom.device
    N, TKI = node_dom.shape
    T2 = ipa["dom_t"].shape[1]
    prm = DeriveParams()
    prm.N, prm.T2, prm.TKI, prm.DK = N, T2, TKI, layout.dk
    ints = derive_scratch_ints(T2, layout.dk)
    prm.dsmem = int(2 * 4 * ints <= DERIVE_SMEM_BYTES)

    def put(field, t, shape, dtype=i32):
        setattr(prm, field, chain._ptr(t, dtype, shape, dev))

    put("loc_cnt", loc["cnt"], (N, T2))
    put("loc_eat", loc["eat"], (N, T2))
    put("loc_vw", loc["vw"], (N, T2))
    put("node_dom", node_dom, (N, TKI))
    put("dom_t", ipa["dom_t"], (N, T2))
    put("term_tk", ipa["term_tk"], (T2,))
    put("ldom", layout.ldom, (N, TKI))
    put("singleton", layout.singleton_mask, (TKI,), torch.uint8)
    for field in ("cnt", "ecnt", "ew"):
        put(field, out[field], (N, T2))
    put("total", out["total"], (T2,))
    keep.append(layout)
    if not prm.dsmem:
        # A partial and a combined copy for each rank of a cluster.
        scratch = torch.empty((chain.MAX_CLUSTER, 2 * ints), dtype=i32, device=dev)
        keep.append(scratch)
        put("scratch", scratch, (chain.MAX_CLUSTER, 2 * ints))
    return prm


def _derive_smem(prm: DeriveParams) -> int:
    return 2 * 4 * derive_scratch_ints(prm.T2, prm.DK) if prm.dsmem else 0


def segment_smem_bytes(prm: SegmentParams, cluster: int, threads: int = 0) -> int:
    """Kernel D's dynamic shared memory per block of a ``cluster``-block
    cluster (csrc/replay_segment.cu ``segment_smem_bytes``): the chain's
    cluster layout and row 6's scratch when it is in shared memory."""
    return chain.cluster_smem_bytes(prm.chain, cluster, threads) + _derive_smem(prm.derive)


def check_smem(prm: SegmentParams, *, cluster: int, threads: int = 0) -> None:
    """Raise ValueError when one block of a ``cluster``-block cluster needs
    more shared memory than a block may take (the dynamic part and
    STATIC_SMEM_BYTES), naming the padded node count and the bound: kernel
    D holds about N / cluster nodes per block."""
    chain.check_smem(prm.chain, extra=_derive_smem(prm.derive) + STATIC_SMEM_BYTES, cluster=cluster,
                     threads=threads)


def _view_out(like: torch.Tensor, T2: int) -> dict:
    return {
        "cnt": torch.empty_like(like),
        "ecnt": torch.empty_like(like),
        "ew": torch.empty_like(like),
        "total": torch.empty(T2, dtype=torch.int32, device=like.device),
    }


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch_derive(lib, prm: DeriveParams) -> None:
    """The standalone entry on the current stream; raises on a CUDA error."""
    err = lib.ksim_derive_interpod(ctypes.byref(prm), _stream())
    if err != 0:
        raise RuntimeError(f"ksim_derive_interpod: CUDA error {err}: {lib.ksim_error_string(err).decode()}")


def derive_interpod(loc: dict, ipa: dict, n_tk: int, n_dom: int) -> dict:
    device = loc["cnt"].device
    if device.type == "cpu":
        return derive_interpod_plain(loc, ipa, n_tk, n_dom)
    if device.type != "cuda":
        raise ValueError(f"derive_interpod runs on cpu or cuda, not {device}")
    lib = _load()
    out = _view_out(loc["cnt"], ipa["dom_t"].shape[1])
    keep: list = []
    prm = _derive_params(loc, ipa, out, keep, derive_layout(ipa["node_dom"]))
    _launch_derive(lib, prm)
    derive_interpod.launches += 1
    return out


derive_interpod.launches = 0

# Per device, an i32 [1] that kernel D adds one to at each run of row 6.
_DERIVE_RUNS: dict[torch.device, torch.Tensor] = {}


def derive_runs() -> int:
    """Runs of row 6 inside kernel D since ``reset_derive_runs``, as the
    kernel counted them on the card (reading waits for the launches)."""
    return sum(int(c.item()) for c in _DERIVE_RUNS.values())


def reset_derive_runs() -> None:
    for c in _DERIVE_RUNS.values():
        c.zero_()


def _segment_outputs(st: SegmentStatics, prog, P: int, N: int, lead: tuple, device) -> dict:
    """Output tensors of one launch, leading shape ``lead`` (the lane axis
    of a fleet launch); record="full" rows start zeroed (the kernel writes
    the attempted rows only)."""
    i32 = torch.int32
    K, Q = st.k, st.q
    outs = {
        "sel": torch.empty((*lead, K, Q), dtype=i32, device=device),
        "idx": torch.empty((*lead, K, Q), dtype=i32, device=device),
        **{name: torch.empty((*lead, K), dtype=i32, device=device)
           for name in ("scheduled", "unschedulable", "eligible", "pass_count", "pending_after")},
    }
    if st.preempt:
        outs["nom"] = torch.empty((*lead, K, Q), dtype=i32, device=device)
        outs["vic"] = torch.empty((*lead, K, Q, st.v_eff(P)), dtype=i32, device=device)
        outs["overflow"] = torch.empty((*lead, K), dtype=torch.bool, device=device)
    if st.record == "full":
        outs.update(_record_buffers(prog, (*lead, K, Q), N, device))
    return outs


class _Launch:
    """What every lane of one launch shares: the universe's tensors, the
    step-start carries, the row-6 layout, the preemption tables.  ``keep``
    holds every tensor a lane's params point at until the launch is
    enqueued (the caching allocator keeps them for the stream after)."""

    def __init__(self, st: SegmentStatics, prog, const: dict, ev: dict, lanes: int) -> None:
        if prog.record not in ("selection", "full"):
            raise NotImplementedError(f"kernel D records selection or full, not {prog.record!r}")
        self.st, self.prog, self.const, self.ev, self.lanes = st, prog, const, ev, lanes
        aux, nstat, prow = const["aux"], const["node"], const["pods"]
        self.device = prow["requests"].device
        self.P = prow["requests"].shape[0]
        self.N = nstat["allocatable"].shape[0]
        self.pods = PodBatch(
            requests=prow["requests"],
            nonzero_requests=prow["nonzero_requests"],
            valid=torch.ones(self.P, dtype=torch.bool, device=self.device),
            tolerates_unschedulable=prow["tolerates_unschedulable"],
            has_requests=prow["has_requests"],
            index=torch.arange(self.P, dtype=torch.int32, device=self.device),
        )
        self.init = prog.init_carries(aux)
        self.layout = derive_layout(aux["interpod"]["node_dom"])
        runs = _DERIVE_RUNS.get(self.device)
        if runs is None:
            runs = _DERIVE_RUNS[self.device] = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.runs = runs
        self.keep: list = [self.pods, self.init, self.layout]
        if st.preempt:
            imp = prow["imp_rank"]
            order = torch.full((self.P,), -1, dtype=torch.int32, device=self.device)
            ranked = imp < self.P
            order[imp[ranked].long()] = self.pods.index[ranked]
            self.imp_order = order
            self.keep.append(order)

    def put(self, prm, field, t, dtype, shape) -> None:
        setattr(prm, field, chain._ptr(t, dtype, shape, self.device))

    def lane_params(self, s: dict, outs: dict) -> SegmentParams:
        """One lane's params over its carried state ``s`` (written in
        place; ``pass_count`` shaped [1]) and its outputs ``outs``."""
        st, prog, const, ev = self.st, self.prog, self.const, self.ev
        i32, b = torch.int32, torch.bool
        aux, nstat, prow = const["aux"], const["node"], const["pods"]
        ipa = aux["interpod"]
        P, N, K, Q, dev = self.P, self.N, st.k, st.q, self.device
        R = prow["requests"].shape[1]
        T2 = ipa["dom_t"].shape[1]
        SS = s["spread"].shape[1]
        keep = self.keep
        state = NodeStateView(
            allocatable=nstat["allocatable"],
            allowed_pods=nstat["allowed_pods"],
            valid=s["valid"],
            unschedulable=nstat["unschedulable"],
            requested=s["requested"],
            nonzero_requested=s["nonzero_requested"],
            pod_count=s["pod_count"],
        )
        # The lane's own working carries and inter-pod view.
        carries = {
            name: ({f: t.clone() for f, t in c.items()} if isinstance(c, dict) else c.clone())
            for name, c in self.init.items()
        }
        view = _view_out(s["ip_cnt"], T2)
        if "PodTopologySpread" in carries:
            carries["PodTopologySpread"] = s["spread"]
        if "InterPodAffinity" in carries:
            carries["InterPodAffinity"] = view
        full = st.record == "full"
        chain_out = {"selected": torch.empty(P, dtype=i32, device=dev)}
        if full:
            chain_out.update(
                total=None, **{k: outs[k].reshape(K * Q, *outs[k].shape[2:]) for k in ("bits", "raw", "final")}
            )
        prm = SegmentParams()
        chain_prm = chain.chain_params(prog, state, self.pods, aux, carries, chain_out, cluster=True, rows=K * Q)
        prm.chain = chain_prm  # a copy of the struct: keep its tensors alive here
        keep += [chain_prm, state, carries, chain_out, view]
        prm.derive = _derive_params(
            {"cnt": s["ip_cnt"], "eat": s["ip_eat"], "vw": s["ip_vw"]}, ipa, view, keep, self.layout,
        )

        def put(field, t, dtype, shape):
            self.put(prm, field, t, dtype, shape)

        put("valid", s["valid"], b, (N,))
        for name in ("alive", "nominated"):
            put(name, s[name], b, (P,))
        for name in ("bound", "attempts", "retry_at"):
            put(name, s[name], i32, (P,))
        put("spread", s["spread"], i32, (N, SS))
        for name in ("ip_cnt", "ip_eat", "ip_vw"):
            put(name, s[name], i32, (N, T2))
        put("pass_count", s["pass_count"], i32, (1,))
        init = self.init
        if "NodePorts" in init:
            put("ports_init", init["NodePorts"], i32, tuple(init["NodePorts"].shape))
        nvl = chain.volume_limits_carry(prog)
        if nvl is not None:
            put("attached_init", init[nvl], i32, tuple(init[nvl].shape))
        if "VolumeRestrictions" in init:
            v = init["VolumeRestrictions"]
            put("rwop_init", v["rwop"], i32, tuple(v["rwop"].shape))
            put("disk_any_init", v["disk_any"], i32, tuple(v["disk_any"].shape))
            put("disk_rw_init", v["disk_rw"], i32, tuple(v["disk_rw"].shape))
        widths = {}
        for field, name in (("ev_pc", "pod_create"), ("ev_pd", "pod_delete"),
                            ("ev_nc", "node_create"), ("ev_nd", "node_delete")):
            t = ev[name]
            widths[field] = t.shape[1]
            put(field, t, i32, (K, t.shape[1]))
        put("ev_rank", ev["rank"], i32, (K, N))
        put("ev_flush", ev["flush"], b, (K,))
        put("ev_active", ev["active"], b, (K,))
        put("out_sel", outs["sel"], i32, (K, Q))
        put("out_idx", outs["idx"], i32, (K, Q))
        for field, name in (("out_scheduled", "scheduled"), ("out_unsched", "unschedulable"),
                            ("out_eligible", "eligible"), ("out_pass", "pass_count"),
                            ("out_pending", "pending_after")):
            put(field, outs[name], i32, (K,))
        put("derive_runs", self.runs, i32, (1,))
        prm.K, prm.Q, prm.cap, prm.P = K, Q, st.cap, P
        prm.Wpc, prm.Wpd, prm.Wnc, prm.Wnd = (widths[f] for f in ("ev_pc", "ev_pd", "ev_nc", "ev_nd"))
        prm.max_backoff, prm.flush_cap, prm.shift_cap = st.max_backoff, st.flush_cap, st.shift_cap
        if st.preempt:
            VE = st.v_eff(P)
            prm.preempt, prm.CE, prm.VE = 1, st.c_eff(N), VE
            prm.empty_start_rank = int(const["empty_start_rank"])
            put("priority", prow["priority"], i32, (P,))
            put("imp_order", self.imp_order, i32, (P,))
            put("start_rank", prow["start_rank"], i32, (P,))
            put("preempt_ok", prow["preempt_ok"], b, (P,))
            put("ev_name_rank", ev["name_rank"], i32, (K, N))
            put("ev_want", ev["want"], i32, (K,))
            if full:
                resolv = const["resolv"]
                prm.resolv_f, prm.resolv_w = resolv.shape
                put("resolv", resolv, b, tuple(resolv.shape))
            scratch = {
                "snap_req": torch.empty((N, R), dtype=i32, device=dev),
                "snap_nz": torch.empty((N, R), dtype=i32, device=dev),
                "snap_pc": torch.empty(N, dtype=i32, device=dev),
                "snap_spread": torch.empty((N, SS), dtype=i32, device=dev),
                "name_order": torch.empty(N, dtype=i32, device=dev),
                "vcnt": torch.empty(N, dtype=i32, device=dev),
            }
            keep.append(scratch)
            for field, t in scratch.items():
                put(field, t, i32, tuple(t.shape))
            put("out_nom", outs["nom"], i32, (K, Q))
            put("out_vic", outs["vic"], i32, (K, Q, VE))
            put("out_over", outs["overflow"], b, (K,))
        return prm

    def launch(self, lib, params: list, *, lanes: bool) -> dict:
        """One launch, on the current stream: the solo kernel with the one
        lane's params by value, or (``lanes``) len(params) clusters,
        cluster c running lane c from a device copy of the params; at
        CLUSTER_SIZE blocks (0: ``choose_cluster`` among SOLO_SIZES, or
        LANE_SIZES for the lanes, from the card's occupancy answers) of
        CLUSTER_THREADS threads (0: chain.cluster_threads).  A node axis
        over the shared-memory bound of the largest cluster raises
        ValueError before the launch; a CUDA error, a refused launch
        included, raises RuntimeError.  Returns what ran: {"cluster":
        blocks per lane, "threads": per block, "smem_bytes": dynamic
        shared memory per block, "stats": int64 [2 +
        len(chain.CLUSTER_PHASES)] on the card: the cluster barriers and
        the attempts evaluated, as the grid's block 0 (lane 0's leader)
        counted them, then its clock cycles in each phase}."""
        size, threads = CLUSTER_SIZE, CLUSTER_THREADS
        chain.check_cluster_shape(size, threads)
        check_smem(params[0], cluster=size or max(SOLO_SIZES), threads=threads)
        if not size:
            size = choose_cluster(
                len(params),
                lambda cs: lib.ksim_segment_fits(ctypes.byref(params[0]), int(lanes), len(params), cs, threads),
                LANE_SIZES if lanes else SOLO_SIZES,
            )
        dev_params = None
        if lanes:
            blob = b"".join(ctypes.string_at(ctypes.addressof(p), ctypes.sizeof(p)) for p in params)
            dev_params = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(self.device)
            self.keep.append(dev_params)
        stats = torch.zeros(2 + len(chain.CLUSTER_PHASES), dtype=torch.int64, device=self.device)
        info = (ctypes.c_longlong * 3)()
        err = lib.ksim_replay_segment(
            ctypes.byref(params[0]),
            ctypes.c_void_p(dev_params.data_ptr() if lanes else None),
            len(params),
            _stream(),
            size,
            threads,
            ctypes.c_void_p(stats.data_ptr()),
            info,
        )
        if err != 0:
            raise RuntimeError(f"ksim_replay_segment: CUDA error {err}: {lib.ksim_error_string(err).decode()}")
        return {"cluster": info[0], "threads": info[1], "smem_bytes": info[2], "stats": stats}


def _device_of(const: dict, name: str) -> torch.device:
    device = const["pods"]["requests"].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    return device


def launch_solo(lib, st: SegmentStatics, prog, const: dict, ev: dict, state0: dict):
    """Kernel D's solo launch through ``lib`` on ``state0``'s device:
    (final state, outs, what ran)."""
    run = _Launch(st, prog, const, ev, lanes=1)
    # Fresh copies: the kernel writes the carried state in place.
    s = {k: v.clone() for k, v in state0.items()}
    s["pass_count"] = s["pass_count"].reshape(1)
    outs = _segment_outputs(st, prog, run.P, run.N, (), run.device)
    ran = run.launch(lib, [run.lane_params(s, outs)], lanes=False)
    s["pass_count"] = s["pass_count"].reshape(())
    return s, outs, ran


def launch_lanes(lib, st: SegmentStatics, prog, const: dict, ev: dict, state0: dict):
    """Kernel D's lanes launch through ``lib`` (``state0`` with a leading
    lane axis): (final state, outs, what ran)."""
    lanes = state0["valid"].shape[0]
    run = _Launch(st, prog, const, ev, lanes=lanes)
    s = {k: v.clone() for k, v in state0.items()}
    s["pass_count"] = s["pass_count"].reshape(lanes, 1)
    outs = _segment_outputs(st, prog, run.P, run.N, (lanes,), run.device)
    params = [
        run.lane_params({k: v[i] for k, v in s.items()}, {k: v[i] for k, v in outs.items()})
        for i in range(lanes)
    ]
    ran = run.launch(lib, params, lanes=True)
    s["pass_count"] = s["pass_count"].reshape(lanes)
    return s, outs, ran


def load_library() -> None:
    """Build (or load) kernel D's library now: the replay driver calls it
    on its main thread before the first watchdogged dispatch, so nvcc's
    minutes never count against the watchdog."""
    _load()


# What the last launch made on each thread ran: the replay driver's
# dispatch worker reads its own launch's notes here, which a worker the
# watchdog abandoned can never overwrite (``replay_segment.last`` is the
# process-wide last, for callers on one thread).
_HERE = threading.local()


def take_launch_notes() -> "dict | None":
    """The notes of the last launch THIS thread made (then cleared), or
    None when it made none (the plain version ran)."""
    ran = getattr(_HERE, "ran", None)
    _HERE.ran = None
    return ran


def replay_segment(st: SegmentStatics, prog, const: dict, ev: dict, state0: dict):
    """Kernel D's solo launch (the plain version on CPU tensors).  What
    the launch ran goes to ``replay_segment.last`` and to this thread's
    ``take_launch_notes``."""
    device = _device_of(const, "replay_segment")
    if device.type == "cpu":
        return replay_segment_plain(st, prog, const, ev, state0)
    s, outs, ran = launch_solo(_load(), st, prog, const, ev, state0)
    replay_segment.last = _HERE.ran = ran
    replay_segment.launches += 1
    return s, outs


replay_segment.launches = 0
replay_segment.last = None


def replay_segment_fleet(st: SegmentStatics, prog, const: dict, ev: dict, state0: dict):
    """Rows 10-11: S lanes of kernel D in one launch, one cluster per lane.
    ``state0`` carries a leading lane axis on every leaf (``pass_count``
    is [S]); ``const`` and ``ev`` are shared by every lane.  Returns
    (final state, outs) with the lane axis leading every leaf; what ran
    goes to ``replay_segment_fleet.last`` and this thread's
    ``take_launch_notes``."""
    device = _device_of(const, "replay_segment_fleet")
    if device.type == "cpu":
        return replay_segment_fleet_plain(st, prog, const, ev, state0)
    s, outs, ran = launch_lanes(_load(), st, prog, const, ev, state0)
    replay_segment_fleet.last = _HERE.ran = ran
    replay_segment_fleet.launches += 1
    return s, outs


replay_segment_fleet.launches = 0
replay_segment_fleet.last = None
