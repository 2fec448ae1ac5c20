"""Kernel D wrapper: K churn-replay steps in one launch, and row 6 alone.

``replay_segment(st, prog, const, ev, state0)`` runs the segment program
of ``ksim_tpu/engine/replay.py _segment_body`` (record="selection", no
on-device preemption) for ``st.k`` steps: event application, the flush
and backoff rules, the queue, InterPodAffinity's domain view, the plugin
chain with the minimal-rank selectHost, and the commit.  It returns
``(final_state, outs)``; its inputs are never modified.
``derive_interpod(loc, ipa, n_tk, n_dom)`` is the domain-view derivation
(``_derive_interpod``) alone.

The trees are the lowering's (engine/replay.py ``segment_from_arrays``):

- ``const``: ``node`` (allocatable, allowed_pods, unschedulable),
  ``pods`` (requests, nonzero_requests, tolerates_unschedulable,
  has_requests) over the P universe rows, ``aux`` (the engine's device
  aux, engine/core.py ``device_aux``);
- ``ev``: leading axis K — ``pod_create`` / ``pod_delete`` /
  ``node_create`` / ``node_delete`` index lists padded with -1, ``rank``
  [K, N], ``flush`` and ``active`` [K];
- ``state0``: valid [N], requested / nonzero_requested [N, R], pod_count
  [N], alive / bound / attempts / retry_at / nominated [P], spread
  [N, S], ip_cnt / ip_eat / ip_vw [N, T] (node-local term counts),
  pass_count (0-d).

``outs``: sel / idx [K, Q] and scheduled / unschedulable / eligible /
pass_count / pending_after [K], all int32.

Tensors on the CPU take the plain versions; tensors on a CUDA device
launch csrc/replay_segment.cu (kernel D, and its standalone
``derive_interpod`` entry).  A kernel that fails to build or launch
raises; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ksim_tpu_torch.kernels import build, chain
from ksim_tpu_torch.plugins.base import NodeStateView, PodBatch, PodView

_I32_MIN = torch.iinfo(torch.int32).min
_I32_MAX = torch.iinfo(torch.int32).max

MAX_TKI = 16  # csrc/derive_interpod.cuh: inter-pod topology keys
DERIVE_SMEM_BYTES = 32768  # domain scratch up to this lives in shared memory


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


def _skip_outputs(st: SegmentStatics, P: int, pass_count, device) -> dict:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return {
        "sel": torch.full((st.q,), -1, dtype=torch.int32, device=device),
        "idx": torch.full((st.q,), P, dtype=torch.int32, device=device),
        "scheduled": z,
        "unschedulable": z,
        "eligible": z,
        "pass_count": pass_count.clone(),
        "pending_after": z,
    }


def replay_segment_plain(st: SegmentStatics, prog, const: dict, ev: dict, state0: dict):
    """The plain PyTorch version: the reference's steps one by one, the
    pods of a step in a Python loop of [N]-wide tensor ops."""
    aux, nstat, prow = const["aux"], const["node"], const["pods"]
    ipa = aux["interpod"]
    P = prow["requests"].shape[0]
    N = nstat["allocatable"].shape[0]
    dev = prow["requests"].device
    sel_rows = aux["spread"]["pod_sel_match"]
    qm_rows = ipa["pod_term_match"]
    eat_rows, vw_rows = ipa["pod_eat"], ipa["pod_vw"]
    s = {k: v.clone() for k, v in state0.items()}
    outs = []
    for k in range(st.k):
        evk = {name: t[k] for name, t in ev.items()}
        if not bool(evk["active"]):
            outs.append(_skip_outputs(st, P, s["pass_count"], dev))
            continue
        # Pod deletes: the bound node's rows lose the pod's.
        pdel = evk["pod_delete"]
        pdel = pdel[pdel >= 0].long()
        bnode = s["bound"][pdel]
        hit = bnode >= 0
        rows, tgt = pdel[hit], bnode[hit].long()
        s["requested"].index_add_(0, tgt, -prow["requests"][rows])
        s["nonzero_requested"].index_add_(0, tgt, -prow["nonzero_requests"][rows])
        s["pod_count"].index_add_(0, tgt, -torch.ones_like(tgt, dtype=torch.int32))
        s["spread"].index_add_(0, tgt, -sel_rows[rows].to(torch.int32))
        s["ip_cnt"].index_add_(0, tgt, -qm_rows[rows].to(torch.int32))
        s["ip_eat"].index_add_(0, tgt, -eat_rows[rows])
        s["ip_vw"].index_add_(0, tgt, -vw_rows[rows])
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
        for qq in range(n_att):
            j = int(idx_q[qq])
            pod = PodView(
                requests=prow["requests"][j : j + 1],
                nonzero_requests=prow["nonzero_requests"][j : j + 1],
                tolerates_unschedulable=prow["tolerates_unschedulable"][j : j + 1],
                has_requests=prow["has_requests"][j : j + 1],
                index=idx_q[qq : qq + 1],
            )
            ok, _bits, _raw, _final, total = prog.eval_block(state, pod, aux, carries)
            best = _select_ranked(ok[0], total[0], evk["rank"])
            state = state.commit(best, prow["requests"][j], prow["nonzero_requests"][j])
            carries = prog.commit_carries(carries, pod, best, aux)
            sel[qq] = best
        s["requested"] = state.requested
        s["nonzero_requested"] = state.nonzero_requested
        s["pod_count"] = state.pod_count
        s["spread"] = carries["PodTopologySpread"]
        # Step end: binds into the node-local counts and the pod rows.
        live = idx_q < P
        bound_mask = live & (sel >= 0)
        fail_mask = live & (sel < 0)
        b_rows = idx_q[bound_mask].long()
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
        outs.append({
            "sel": sel,
            "idx": idx_q,
            "scheduled": bound_mask.sum(dtype=torch.int32),
            "unschedulable": fail_mask.sum(dtype=torch.int32),
            "eligible": (elig.sum(dtype=torch.int32) if any_valid else torch.zeros((), dtype=torch.int32, device=dev)),
            "pass_count": pc.clone(),
            "pending_after": (s["alive"] & (s["bound"] < 0)).sum(dtype=torch.int32),
        })
    return s, {name: torch.stack([o[name] for o in outs]) for name in outs[0]}


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_L = ctypes.c_longlong


class DeriveParams(ctypes.Structure):
    """Mirror of ``struct DeriveParams`` (csrc/derive_interpod.cuh)."""

    _fields_ = (
        [(name, _P) for name in (
            "loc_cnt", "loc_eat", "loc_vw", "node_dom", "dom_t", "term_tk", "ldom",
            "cnt", "ecnt", "ew", "total", "scratch",
        )]
        + [(name, _L) for name in ("N", "T2", "TKI", "DK", "dsmem")]
        + [("singleton", _L * MAX_TKI)]
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
        )]
        + [(name, _L) for name in (
            "K", "Q", "cap", "P", "Wpc", "Wpd", "Wnc", "Wnd",
            "max_backoff", "flush_cap", "shift_cap",
        )]
    )


def _load():
    lib = build.load("replay_segment")
    if not getattr(lib, "_ksim_segment_checked", False):
        for entry, struct in (("ksim_segment_params_size", SegmentParams),
                              ("ksim_derive_params_size", DeriveParams)):
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_longlong
            if fn() != ctypes.sizeof(struct):
                raise RuntimeError(f"{struct.__name__} differs between csrc/ and kernels/replay_segment.py")
        lib.ksim_derive_interpod.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ksim_derive_interpod.restype = ctypes.c_int
        lib._ksim_segment_checked = True
    return lib


@dataclass(frozen=True)
class DeriveLayout:
    """Row 6's view of one node axis, fixed while the nodes' domains are:
    which topology keys are singleton keys (every domain one node), and
    each node's compact domain index under the other keys."""

    ldom: torch.Tensor  # i32 [N, TKI]; -1 = key missing, or a singleton key
    singleton: tuple[bool, ...]  # [TKI]
    dk: int  # the widest non-singleton key's domain count (at least 1)


def derive_layout(node_dom: torch.Tensor) -> DeriveLayout:
    """The layout of ``node_dom`` (i32 [N, TKI]), with small tensor ops."""
    N, TKI = node_dom.shape
    if TKI > MAX_TKI:
        raise NotImplementedError(f"InterPodAffinity: {TKI} topology keys, the kernel holds {MAX_TKI}")
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
    return DeriveLayout(ldom=ldom, singleton=tuple(singleton), dk=dk)


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
    prm.dsmem = int(4 * 3 * T2 * layout.dk <= DERIVE_SMEM_BYTES)
    for k in range(MAX_TKI):
        prm.singleton[k] = int(layout.singleton[k]) if k < TKI else 1

    def put(field, t, shape):
        setattr(prm, field, chain._ptr(t, i32, shape, dev))

    put("loc_cnt", loc["cnt"], (N, T2))
    put("loc_eat", loc["eat"], (N, T2))
    put("loc_vw", loc["vw"], (N, T2))
    put("node_dom", node_dom, (N, TKI))
    put("dom_t", ipa["dom_t"], (N, T2))
    put("term_tk", ipa["term_tk"], (T2,))
    put("ldom", layout.ldom, (N, TKI))
    for field in ("cnt", "ecnt", "ew"):
        put(field, out[field], (N, T2))
    put("total", out["total"], (T2,))
    keep.append(layout)
    if not prm.dsmem:
        scratch = torch.empty(3 * T2 * layout.dk, dtype=i32, device=dev)
        keep.append(scratch)
        put("scratch", scratch, (3 * T2 * layout.dk,))
    return prm


def _derive_smem(prm: DeriveParams) -> int:
    return 4 * 3 * prm.T2 * prm.DK if prm.dsmem else 0


def _view_out(like: torch.Tensor, T2: int) -> dict:
    return {
        "cnt": torch.empty_like(like),
        "ecnt": torch.empty_like(like),
        "ew": torch.empty_like(like),
        "total": torch.empty(T2, dtype=torch.int32, device=like.device),
    }


def _launch_derive(lib, prm: DeriveParams) -> None:
    """The standalone entry on the current stream; raises on a CUDA error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.ksim_derive_interpod(ctypes.byref(prm), ctypes.c_void_p(stream))
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


def replay_segment(st: SegmentStatics, prog, const: dict, ev: dict, state0: dict):
    device = const["pods"]["requests"].device
    if device.type == "cpu":
        return replay_segment_plain(st, prog, const, ev, state0)
    if device.type != "cuda":
        raise ValueError(f"replay_segment runs on cpu or cuda, not {device}")
    if prog.record != "selection":
        raise NotImplementedError("kernel D records selections only")
    lib = _load()
    i32, b = torch.int32, torch.bool
    aux, nstat, prow = const["aux"], const["node"], const["pods"]
    ipa = aux["interpod"]
    P, R = prow["requests"].shape
    N = nstat["allocatable"].shape[0]
    T2 = ipa["dom_t"].shape[1]
    K, Q = st.k, st.q
    # Fresh copies: the kernel writes the carried state in place.
    s = {k: v.clone() for k, v in state0.items()}
    s["pass_count"] = s["pass_count"].reshape(1)
    state = NodeStateView(
        allocatable=nstat["allocatable"],
        allowed_pods=nstat["allowed_pods"],
        valid=s["valid"],
        unschedulable=nstat["unschedulable"],
        requested=s["requested"],
        nonzero_requested=s["nonzero_requested"],
        pod_count=s["pod_count"],
    )
    pods = PodBatch(
        requests=prow["requests"],
        nonzero_requests=prow["nonzero_requests"],
        valid=torch.ones(P, dtype=b, device=device),
        tolerates_unschedulable=prow["tolerates_unschedulable"],
        has_requests=prow["has_requests"],
        index=torch.arange(P, dtype=i32, device=device),
    )
    init = prog.init_carries(aux)
    carries = {
        name: ({f: t.clone() for f, t in c.items()} if isinstance(c, dict) else c.clone())
        for name, c in init.items()
    }
    view = _view_out(s["ip_cnt"], T2)
    if "PodTopologySpread" in carries:
        carries["PodTopologySpread"] = s["spread"]
    if "InterPodAffinity" in carries:
        carries["InterPodAffinity"] = view
    outs = {
        "sel": torch.empty((K, Q), dtype=i32, device=device),
        "idx": torch.empty((K, Q), dtype=i32, device=device),
        **{name: torch.empty(K, dtype=i32, device=device)
           for name in ("scheduled", "unschedulable", "eligible", "pass_count", "pending_after")},
    }
    dummy = {"selected": torch.empty(P, dtype=i32, device=device)}
    prm = SegmentParams()
    chain_prm = chain.chain_params(prog, state, pods, aux, carries, dummy)
    prm.chain = chain_prm  # a copy of the struct: keep its tensors alive here
    keep = [chain_prm, state, pods, carries, dummy, init]
    prm.derive = _derive_params(
        {"cnt": s["ip_cnt"], "eat": s["ip_eat"], "vw": s["ip_vw"]}, ipa, view, keep,
        derive_layout(ipa["node_dom"]),
    )
    runs = _DERIVE_RUNS.get(device)
    if runs is None:
        runs = _DERIVE_RUNS[device] = torch.zeros(1, dtype=i32, device=device)

    def put(field, t, dtype, shape):
        setattr(prm, field, chain._ptr(t, dtype, shape, device))

    SS = s["spread"].shape[1]
    put("valid", s["valid"], b, (N,))
    for name in ("alive", "nominated"):
        put(name, s[name], b, (P,))
    for name in ("bound", "attempts", "retry_at"):
        put(name, s[name], i32, (P,))
    put("spread", s["spread"], i32, (N, SS))
    for name in ("ip_cnt", "ip_eat", "ip_vw"):
        put(name, s[name], i32, (N, T2))
    put("pass_count", s["pass_count"], i32, (1,))
    if "NodePorts" in init:
        put("ports_init", init["NodePorts"], i32, tuple(init["NodePorts"].shape))
    if "NodeVolumeLimits" in init:
        put("attached_init", init["NodeVolumeLimits"], i32, tuple(init["NodeVolumeLimits"].shape))
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
    put("derive_runs", runs, i32, (1,))
    prm.K, prm.Q, prm.cap, prm.P = K, Q, st.cap, P
    prm.Wpc, prm.Wpd, prm.Wnc, prm.Wnd = (widths[f] for f in ("ev_pc", "ev_pd", "ev_nc", "ev_nd"))
    prm.max_backoff, prm.flush_cap, prm.shift_cap = st.max_backoff, st.flush_cap, st.shift_cap
    chain.check_smem(prm.chain, extra=_derive_smem(prm.derive))
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.ksim_replay_segment(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ksim_replay_segment: CUDA error {err}: {lib.ksim_error_string(err).decode()}")
    replay_segment.launches += 1
    s["pass_count"] = s["pass_count"].reshape(())
    return s, outs


replay_segment.launches = 0
