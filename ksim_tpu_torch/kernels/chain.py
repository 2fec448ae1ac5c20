"""The kernels' view of a plugin chain: ``ChainParams`` (the ctypes mirror
of ``struct ChainParams`` in csrc/plugin_chain.cuh) and its assembly from
an engine program plus device tensors, with every tensor checked for
device, dtype, shape and contiguity before a launch."""

from __future__ import annotations

import ctypes

import torch

# Plugin ids of csrc/plugin_chain.cuh, by plugin name.
PLUGIN_IDS = {
    "NodeUnschedulable": 0,
    "NodeName": 1,
    "TaintToleration": 2,
    "NodeAffinity": 3,
    "NodePorts": 4,
    "NodeResourcesFit": 5,
    "NodeResourcesBalancedAllocation": 6,
    "ImageLocality": 7,
    "VolumeRestrictions": 8,
    "NodeVolumeLimits": 9,
    "VolumeBinding": 10,
    "VolumeZone": 11,
    "PodTopologySpread": 12,
    "InterPodAffinity": 13,
}
STRATEGY_IDS = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
NPLUGINS = 14
MAX_SPEC = 8
MAX_SHAPE = 16
MAX_POOLS = 16  # NodeVolumeLimits pools
MAX_MC = 8  # PodTopologySpread constraints per pod
MAX_TK = 16  # PodTopologySpread topology keys
# Per-domain scratch that fits this many bytes lives in shared memory,
# more in a global buffer.
DOMAIN_SMEM_BYTES = 16384
# The dynamic shared memory one block may opt into on sm_90 (227 KB).
MAX_SMEM_BYTES = 232448
# plugin_chain.cuh Smem: reduction slots and the prefix-count scratch.
RED_MAX = 24
SCAN_INTS = 64
RECORD_IDS = {"selection": 0, "final": 1, "full": 2}

_P = ctypes.c_void_p
_L = ctypes.c_longlong

_POINTERS = (
    "alloc", "allowed", "nvalid", "unsched", "requested", "nz_requested", "pod_count",
    "preq", "pnz", "pvalid", "ptol", "phas", "pindex",
    "pod_req_node",
    "taint_order", "forbidding", "prefer", "pod_tolerated", "pod_tolerated_prefer",
    "term_ok", "selector_term", "has_required", "required_terms", "preferred_weights",
    "added_terms", "has_added", "added_pref",
    "port_counts", "pod_wants", "pod_adds",
    "node_has_image", "image_size", "image_num_nodes", "total_nodes_f",
    "pod_image_count", "pod_num_containers",
    "pv_node_ok", "pv_zone_ok", "pvc_cand_ok", "pvc_provisionable", "pod_pv", "pod_wffc",
    "pod_fail",
    "attached", "vol_limits", "vol_key", "pod_vol",
    "rwop", "disk_any", "disk_rw", "pod_rwop", "pod_disk_any", "pod_disk_rw", "disk_shareable",
    "sp_ldom", "sp_counts", "sp_sel_match", "con_valid", "con_mode", "con_sel", "con_tk",
    "con_max_skew", "con_min_domains", "con_self", "con_honor_aff", "con_honor_taints",
    "has_score_con", "sp_logw", "sp_scratch",
    "ipa_dom", "ipa_cnt", "ipa_ecnt", "ipa_ew", "ipa_total", "ipa_term_tk",
    "ipa_qm", "ipa_raff", "ipa_ranti", "ipa_self_aff", "ipa_pref_w", "ipa_vw", "ipa_eat",
    "samp_start", "visited_out",
    "selected", "total", "final_out", "bits_out", "raw_out",
)
_SHAPES = (
    "N", "R", "W", "T", "V", "I", "Pc", "F", "S",
    "record", "bits_size", "final_size", "raw_size", "exact",
    "NPV", "NC", "VV", "NK", "RW", "DD",
    "TK", "SS", "MC", "DMAX", "sp_smem",
    "T2", "TKI",
    "n_real", "samp_k",
)


class ChainParams(ctypes.Structure):
    _fields_ = (
        [(name, _P) for name in _POINTERS]
        + [(name, _L) for name in _SHAPES]
        + [("f_row", _L * NPLUGINS), ("s_row", _L * NPLUGINS), ("weight", _L * NPLUGINS)]
        + [("fit_base_count", _L), ("fit_strategy", _L), ("fit_nspec", _L),
           ("fit_spec_idx", _L * MAX_SPEC), ("fit_spec_w", _L * MAX_SPEC),
           ("fit_nshape", _L), ("shape_u", _L * MAX_SHAPE), ("shape_s", _L * MAX_SHAPE)]
        + [("bal_nspec", _L), ("bal_spec", _L * MAX_SPEC)]
        + [("nvl_npools", _L), ("nvl_pools", _L * MAX_POOLS)]
        + [("tk_singleton", _L * MAX_TK), ("tk_size", _L * MAX_TK)]
    )


def check_chain(plugins) -> None:
    """Raise NotImplementedError for a chain the kernels cannot run."""
    seen = set()
    for sp in plugins:
        name = sp.plugin.name
        if name not in PLUGIN_IDS:
            if hasattr(sp.plugin, "pool_ids"):
                raise NotImplementedError(
                    f"{name}: a NodeVolumeLimits instance under another name (a legacy "
                    "per-pool plugin) cannot be expressed: the kernels hold one "
                    "NodeVolumeLimits instance"
                )
            raise NotImplementedError(f"plugin {name} is not ported to ksim_tpu_torch")
        if name in seen:
            raise NotImplementedError(f"plugin {name} appears twice in the profile")
        seen.add(name)
        if getattr(sp, "extender", None) is not None:
            raise NotImplementedError(f"PluginExtender hooks ({name}) are not ported")
        if sp.filter_enabled and not hasattr(sp.plugin, "filter"):
            raise NotImplementedError(f"{name} has no filter")
        if sp.score_enabled and not hasattr(sp.plugin, "score"):
            raise NotImplementedError(f"{name} has no score")
        p = sp.plugin
        if name == "NodeResourcesFit" and (
            len(p._score_spec) > MAX_SPEC or len(p._shape) > MAX_SHAPE
        ):
            raise NotImplementedError("NodeResourcesFit: more score resources or shape points than the kernels hold")
        if name == "NodeResourcesBalancedAllocation" and len(p._spec) > MAX_SPEC:
            raise NotImplementedError("BalancedAllocation: more resources than the kernels hold")
        if name == "NodeVolumeLimits" and len(p.pool_ids) > MAX_POOLS:
            raise NotImplementedError("NodeVolumeLimits: more attach pools than the kernels hold")
        if name == "PodTopologySpread" and len(p.tk_sizes) > MAX_TK:
            raise NotImplementedError("PodTopologySpread: more topology keys than the kernels hold")


def _ptr(t: torch.Tensor | None, dtype: torch.dtype, shape: tuple, device) -> int | None:
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, kernel runs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"tensor of {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"tensor of shape {tuple(t.shape)}, kernel takes {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError("kernel takes contiguous tensors")
    return t.data_ptr()


def chain_params(prog, state, pods, aux, carries, out: dict, *, grid: int = 1,
                 sampling: tuple | None = None) -> ChainParams:
    """Fill ChainParams for ``prog`` (engine/core.py _Program) over the
    pod chunk ``pods``.  ``state`` and the carries are the tensors the
    scan kernels update in place; ``out`` holds the output tensors of the
    record mode (plus ``visited`` under sampling).  ``grid`` is the
    number of blocks the launch runs, for the per-block domain scratch;
    ``sampling`` is (start [1] i32 tensor, n_real, k) for kernel C.  The
    tensors the kernel reads but the caller does not hold (the scratch)
    are kept alive on the returned object."""
    i32, f32, f64, b = torch.int32, torch.float32, torch.float64, torch.bool
    dev = state.valid.device
    N, R = state.allocatable.shape
    Pc = pods.valid.shape[0]
    P_all = aux["nodename"]["pod_req_node"].shape[0]
    prm = ChainParams()
    prm.N, prm.R, prm.Pc = N, R, Pc
    prm.F = len(prog.filters)
    prm.S = len(prog.scores)
    prm.record = RECORD_IDS[prog.record]
    prm.exact = int(prog.exact)
    bits_dtype, final_dtype, raw_dtype = prog.dtypes
    prm.bits_size = torch.empty((), dtype=bits_dtype).element_size()
    prm.final_size = torch.empty((), dtype=final_dtype).element_size()
    prm.raw_size = torch.empty((), dtype=raw_dtype).element_size()

    def put(field, t, dtype, shape):
        setattr(prm, field, _ptr(t, dtype, shape, dev))

    put("alloc", state.allocatable, i32, (N, R))
    put("allowed", state.allowed_pods, i32, (N,))
    put("nvalid", state.valid, b, (N,))
    put("unsched", state.unschedulable, b, (N,))
    put("requested", state.requested, i32, (N, R))
    put("nz_requested", state.nonzero_requested, i32, (N, R))
    put("pod_count", state.pod_count, i32, (N,))
    put("preq", pods.requests, i32, (Pc, R))
    put("pnz", pods.nonzero_requests, i32, (Pc, R))
    put("pvalid", pods.valid, b, (Pc,))
    put("ptol", pods.tolerates_unschedulable, b, (Pc,))
    put("phas", pods.has_requests, b, (Pc,))
    put("pindex", pods.index, i32, (Pc,))

    for k in range(NPLUGINS):
        prm.f_row[k] = -1
        prm.s_row[k] = -1
        prm.weight[k] = 0
    for row, sp in enumerate(prog.filters):
        prm.f_row[PLUGIN_IDS[sp.plugin.name]] = row
    for row, sp in enumerate(prog.scores):
        prm.s_row[PLUGIN_IDS[sp.plugin.name]] = row
        prm.weight[PLUGIN_IDS[sp.plugin.name]] = sp.weight
    names = {sp.plugin.name: sp.plugin for sp in prog.plugins}

    # Every aux family goes in whole: PodTopologySpread reads the
    # NodeAffinity and TaintToleration tables whether or not those
    # plugins are in the profile.
    put("pod_req_node", aux["nodename"]["pod_req_node"], i32, (P_all,))
    a = aux["taints"]
    W = prm.W = a["forbidding"].shape[0]
    put("taint_order", a["node_taint_order"], i32, (N, W))
    put("forbidding", a["forbidding"], b, (W,))
    put("prefer", a["prefer"], b, (W,))
    put("pod_tolerated", a["pod_tolerated"], b, (P_all, W))
    put("pod_tolerated_prefer", a["pod_tolerated_prefer"], b, (P_all, W))
    a = aux["affinity"]
    T = prm.T = a["term_size"].shape[0]
    put("term_ok", a["term_ok"], b, (N, T))
    put("selector_term", a["selector_term"], i32, (P_all,))
    put("has_required", a["has_required"], b, (P_all,))
    put("required_terms", a["required_terms"], b, (P_all, T))
    put("preferred_weights", a["preferred_weights"], i32, (P_all, T))
    put("added_terms", a["added_terms"], b, (T,))
    put("has_added", a["has_added"], b, (1,))
    put("added_pref", a["added_pref"], i32, (T,))
    a = aux["nodeports"]
    V = prm.V = a["pod_wants"].shape[1]
    put("pod_wants", a["pod_wants"], b, (P_all, V))
    put("pod_adds", a["pod_adds"], i32, (P_all, V))
    if "NodePorts" in names:
        put("port_counts", carries["NodePorts"], i32, (N, V))
    a = aux["imagelocality"]
    I = prm.I = a["image_size"].shape[0]
    put("node_has_image", a["node_has_image"], b, (N, I))
    put("image_size", a["image_size"], f64, (I,))
    put("image_num_nodes", a["image_num_nodes"], i32, (I,))
    put("total_nodes_f", a["total_nodes_f"], f64, ())
    put("pod_image_count", a["pod_image_count"], i32, (P_all, I))
    put("pod_num_containers", a["pod_num_containers"], i32, (P_all,))
    if "NodeResourcesFit" in names:
        fit = names["NodeResourcesFit"]
        prm.fit_base_count = fit._base_count
        prm.fit_strategy = STRATEGY_IDS[fit._strategy]
        prm.fit_nspec = len(fit._score_spec)
        for k, (ri, w) in enumerate(fit._score_spec):
            prm.fit_spec_idx[k] = ri
            prm.fit_spec_w[k] = w
        prm.fit_nshape = len(fit._shape)
        for k, (u, s) in enumerate(fit._shape):
            prm.shape_u[k] = u
            prm.shape_s[k] = s
    if "NodeResourcesBalancedAllocation" in names:
        spec = names["NodeResourcesBalancedAllocation"]._spec
        prm.bal_nspec = len(spec)
        for k, ri in enumerate(spec):
            prm.bal_spec[k] = ri

    a = aux["volumes"]
    NPV = prm.NPV = a["pv_node_ok"].shape[0]
    NC = prm.NC = a["pvc_cand_ok"].shape[0]
    VV = prm.VV = a["pod_vol"].shape[1]
    NK = prm.NK = a["limits"].shape[1]
    RW = prm.RW = a["pod_rwop"].shape[1]
    DD = prm.DD = a["pod_disk_any"].shape[1]
    put("pv_node_ok", a["pv_node_ok"], b, (NPV, N))
    put("pv_zone_ok", a["pv_zone_ok"], b, (NPV, N))
    put("pvc_cand_ok", a["pvc_cand_ok"], b, (NC, N))
    put("pvc_provisionable", a["pvc_provisionable"], b, (NC,))
    put("pod_pv", a["pod_pv"], b, (P_all, NPV))
    put("pod_wffc", a["pod_wffc"], b, (P_all, NC))
    put("pod_fail", a["pod_fail"], i32, (P_all,))
    put("vol_limits", a["limits"], i32, (N, NK))
    put("vol_key", a["vol_key"], i32, (VV,))
    put("pod_vol", a["pod_vol"], b, (P_all, VV))
    put("pod_rwop", a["pod_rwop"], b, (P_all, RW))
    put("pod_disk_any", a["pod_disk_any"], b, (P_all, DD))
    put("pod_disk_rw", a["pod_disk_rw"], b, (P_all, DD))
    put("disk_shareable", a["disk_ro_shareable"], b, (DD,))
    if "NodeVolumeLimits" in names:
        pools = names["NodeVolumeLimits"].pool_ids
        prm.nvl_npools = len(pools)
        for k, pool in enumerate(pools):
            prm.nvl_pools[k] = pool
        put("attached", carries["NodeVolumeLimits"], i32, (N, VV))
    if "VolumeRestrictions" in names:
        c = carries["VolumeRestrictions"]
        put("rwop", c["rwop"], i32, (N, RW))
        put("disk_any", c["disk_any"], i32, (N, DD))
        put("disk_rw", c["disk_rw"], i32, (N, DD))

    a = aux["spread"]
    TK = prm.TK = a["node_ldom"].shape[1]
    SS = prm.SS = a["pod_sel_match"].shape[1]
    MC = prm.MC = a["con_valid"].shape[1]
    put("sp_ldom", a["node_ldom"], i32, (N, TK))
    put("sp_sel_match", a["pod_sel_match"], b, (P_all, SS))
    for field, dtype in (
        ("valid", b), ("mode", i32), ("sel", i32), ("tk", i32), ("max_skew", i32),
        ("min_domains", i32), ("self", b), ("honor_aff", b), ("honor_taints", b),
    ):
        put("con_" + field, a["con_" + field], dtype, (P_all, MC))
    put("has_score_con", a["has_score_con"], b, (P_all,))
    keep = []
    if "PodTopologySpread" in names:
        sp = names["PodTopologySpread"]
        if MC > MAX_MC:
            raise NotImplementedError("PodTopologySpread: more constraints per pod than the kernels hold")
        dmax = 0
        for k, (size, single) in enumerate(zip(sp.tk_sizes, sp.tk_singleton)):
            prm.tk_size[k] = size
            prm.tk_singleton[k] = int(single)
            if not single:
                dmax = max(dmax, size)
        for k in range(len(sp.tk_sizes), MAX_TK):
            prm.tk_size[k] = 0
            prm.tk_singleton[k] = 1
        prm.DMAX = dmax
        dom_ints = 4 * MC * dmax  # filter sum, filter presence, score registration, score sum
        prm.sp_smem = int(4 * dom_ints <= DOMAIN_SMEM_BYTES)
        if not prm.sp_smem:
            scratch = torch.empty((grid, dom_ints), dtype=i32, device=dev)
            keep.append(scratch)
            put("sp_scratch", scratch, i32, (grid, dom_ints))
        logw = a["log_w64"] if prog.exact else a["log_w32"]
        put("sp_logw", logw, f64 if prog.exact else f32, (N + 1,))
        put("sp_counts", carries["PodTopologySpread"], i32, (N, SS))

    a = aux["interpod"]
    T2 = prm.T2 = a["dom_t"].shape[1]
    prm.TKI = a["node_dom"].shape[1]
    put("ipa_dom", a["dom_t"], i32, (N, T2))
    put("ipa_term_tk", a["term_tk"], i32, (T2,))
    for field, src, dtype in (
        ("ipa_qm", "pod_term_match", b), ("ipa_raff", "req_aff", b), ("ipa_ranti", "req_anti", b),
        ("ipa_pref_w", "pref_w", i32), ("ipa_vw", "pod_vw", i32), ("ipa_eat", "pod_eat", i32),
    ):
        put(field, a[src], dtype, (P_all, T2))
    put("ipa_self_aff", a["self_aff"], b, (P_all,))
    if "InterPodAffinity" in names:
        c = carries["InterPodAffinity"]
        for field in ("cnt", "ecnt", "ew"):
            put("ipa_" + field, c[field], i32, (N, T2))
        put("ipa_total", c["total"], i32, (T2,))

    if sampling is not None:
        start, n_real, k = sampling
        put("samp_start", start, i32, (1,))
        prm.n_real, prm.samp_k = n_real, k
        if prog.record == "full":
            put("visited_out", out["visited"], b, (Pc, N))

    put("selected", out["selected"], i32, (Pc,))
    if prog.record in ("final", "full"):
        put("total", out["total"], i32, (Pc, N))
        put("final_out", out["final"], final_dtype, (Pc, prm.S, N))
    if prog.record == "full":
        put("bits_out", out["bits"], bits_dtype, (Pc, prm.F, N))
        put("raw_out", out["raw"], raw_dtype, (Pc, prm.S, N))
    prm.keep = keep
    return prm


def empty_outputs(prog, n_pods: int, n_nodes: int, device, *, sampled: bool = False) -> dict:
    """Output tensors of ``prog.record`` for ``n_pods`` pods, in the
    recorded dtypes (engine/core.py _Program.dtypes); under sampling,
    record="full" also keeps the visited mask."""
    bits_dtype, final_dtype, raw_dtype = prog.dtypes
    F, S = len(prog.filters), len(prog.scores)
    out = {"selected": torch.empty(n_pods, dtype=torch.int32, device=device)}
    if prog.record in ("final", "full"):
        out["total"] = torch.empty((n_pods, n_nodes), dtype=torch.int32, device=device)
        out["final"] = torch.empty((n_pods, S, n_nodes), dtype=final_dtype, device=device)
    if prog.record == "full":
        out["bits"] = torch.empty((n_pods, F, n_nodes), dtype=bits_dtype, device=device)
        out["raw"] = torch.empty((n_pods, S, n_nodes), dtype=raw_dtype, device=device)
        if sampled:
            out["visited"] = torch.empty((n_pods, n_nodes), dtype=torch.bool, device=device)
    return out


def fresh_scan_state(state, carries: dict):
    """Fresh copies of the node state's carried fields and of the carries
    (tensors or dicts of tensors), for a scan kernel that commits into
    them in place: its inputs stay unmodified."""
    state = state._replace(
        requested=state.requested.clone(),
        nonzero_requested=state.nonzero_requested.clone(),
        pod_count=state.pod_count.clone(),
    )
    carries = {
        k: {f: t.clone() for f, t in v.items()} if isinstance(v, dict) else v.clone()
        for k, v in carries.items()
    }
    return state, carries


def smem_bytes(prm: ChainParams) -> int:
    """The dynamic shared memory a chain kernel's block takes
    (plugin_chain.cuh ``smem_bytes``): 13 bytes per padded node, the
    pod's image weights, the reduction scratch and, when it fits, the
    PodTopologySpread domain scratch."""
    align8 = (3 * 4 * prm.N + prm.N + 7) & ~7
    dom = 4 * 4 * prm.MC * prm.DMAX if prm.sp_smem else 0
    return align8 + 8 * prm.I + 8 * 33 + 4 * 33 * RED_MAX + 4 * SCAN_INTS + dom


def check_smem(prm: ChainParams, *, extra: int = 0) -> None:
    """Raise ValueError when a block's shared memory (the chain's plus
    ``extra``) is over what one block may take, naming the padded node
    count: the node axis lives in shared memory, so it bounds the
    cluster (about 17,590 padded nodes with no spread domain scratch)."""
    need = smem_bytes(prm) + extra
    if need > MAX_SMEM_BYTES:
        fixed = need - 13 * prm.N
        raise ValueError(
            f"padded node axis N={prm.N} needs {need} bytes of shared memory per "
            f"block, over the {MAX_SMEM_BYTES} bytes one block may take on sm_90: "
            f"at 13 bytes per node the kernels hold at most "
            f"{(MAX_SMEM_BYTES - fixed) // 13} padded nodes for this profile and vocabulary"
        )


def launch(lib, entry: str, prm: ChainParams) -> None:
    """Call ``entry`` on the current stream; raise on a nonzero
    cudaGetLastError().  A node axis over the shared-memory bound raises
    ValueError before the launch."""
    check_smem(prm)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, entry)(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: {lib.ksim_error_string(err).decode()}")
