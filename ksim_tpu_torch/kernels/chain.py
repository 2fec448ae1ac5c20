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
# The score samples (plugins/samples/nodenumber.py), known by their static
# signature, not their name (``sample_id``): DataProviderScore may be
# enabled more than once, under its instances' own names (ChainParams'
# dp_* table).
SAMPLE_IDS = {"NodeNumber": 14, "DataProviderScore": 15}
STRATEGY_IDS = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
NPLUGINS = 16
# Per-domain scratch that fits this many bytes lives in shared memory,
# more in a global buffer.
DOMAIN_SMEM_BYTES = 16384
# The dynamic shared memory one block may opt into on sm_90 (227 KB).
MAX_SMEM_BYTES = 232448
# plugin_chain.cuh Smem: reduction slots, the prefix-count scratch, and
# the bytes of one staged spread constraint (SpreadCon).
RED_MAX = 24
SCAN_INTS = 64
SPREAD_CON_BYTES = 32
RECORD_IDS = {"selection": 0, "final": 1, "full": 2}
# Kernels A and C run on one thread-block cluster (csrc/cluster_scan.cuh):
# its size (0: 16 where the card's occupancy query finds room for one such
# cluster, else 8) and its threads per block (0: one node slot each for
# N / size nodes, cluster_threads).
CLUSTER_SIZE = 0
CLUSTER_THREADS = 0
MAX_CLUSTER = 16
MAX_THREADS = 1024
# Kernel E's stages (csrc/chain_stages.cu: E1 filter, E2 score, E3
# normalize, E4 window and select) run each pod row on a cluster too: one
# block of STAGE_BLOCK_THREADS on a cluster of one, at most
# STAGE_MAX_THREADS per block on a larger one.
STAGE_BLOCK_THREADS = 256
STAGE_MAX_THREADS = 512
# The parts of a stage's shared memory (csrc/chain_stages.cu
# stage_parts): E2's image weights, the 64-bit reduction and its partials,
# the int reduction and its partials, the copy of InterPodAffinity's term
# totals, the pod's spread constraints, the per-domain scratch when it
# fits, the window's visit walk (its prefix scratch, two counts and two
# ballots a warp), a flag byte per node slot (E2, the window).
STAGE_PARTS = {
    "filter": ("red64", "red", "tot", "con", "dom"),
    "score": ("imgw", "red64", "red", "tot", "con", "dom", "flags"),
    "normalize": ("red", "con"),
    "window": ("walk", "flags"),
    "select": ("red64", "tot"),
}
# The phases the cluster kernels time (plugin_chain.cuh Phase), in the
# order of their cycle counts in ``launch_cluster``'s stats: those of a
# pod, then (kernel D) those of a replay step around its pods.
CLUSTER_PHASES = ("setup", "spread filter stats", "filters", "visit window", "spread score stats", "scores",
                  "extrema reduce", "normalize", "select reduce", "commit",
                  "events", "flush and queue", "row 6", "victim search", "step end")

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
    "nn_node", "nn_pod", "dp_score",
    "xs",
)
_SHAPES = (
    "N", "R", "W", "T", "V", "I", "Pc", "F", "S",
    "record", "bits_size", "final_size", "raw_size", "exact",
    "NPV", "NC", "VV", "NK", "RW", "DD",
    "TK", "SS", "MC", "DMAX", "sp_smem",
    "T2", "TKI",
    "n_real", "samp_k",
    "nn_reverse", "dp_n",
    "node_base", "NL",
)


# The profile's tables (device arrays, profile_tables) and their sizes.
_TABLES = (
    "fit_spec_idx", "fit_spec_w", "shape_u", "shape_s", "bal_spec",
    "nvl_row", "nvl_pool_off", "nvl_pools", "tk_singleton", "tk_size", "dp_row", "dp_w",
)
_TABLE_SIZES = ("fit_base_count", "fit_strategy", "fit_nspec", "fit_nshape", "bal_nspec", "nvl_ninst", "sp_ntk")


class ChainParams(ctypes.Structure):
    _fields_ = (
        [(name, _P) for name in _POINTERS]
        + [(name, _L) for name in _SHAPES]
        + [("f_row", _L * NPLUGINS), ("s_row", _L * NPLUGINS), ("weight", _L * NPLUGINS)]
        + [(name, _P) for name in _TABLES]
        + [(name, _L) for name in _TABLE_SIZES]
    )


def check_chain(plugins) -> None:
    """Raise NotImplementedError for a chain the engine cannot run on any
    device: a plugin without the stage it is enabled at, a plugin name
    twice (the carries are keyed by name)."""
    seen = set()
    for sp in plugins:
        name = sp.plugin.name
        if name in seen:
            raise NotImplementedError(f"plugin {name} appears twice in the profile")
        seen.add(name)
        if sp.filter_enabled and not hasattr(sp.plugin, "filter"):
            raise NotImplementedError(f"{name} has no filter")
        if sp.score_enabled and not hasattr(sp.plugin, "score"):
            raise NotImplementedError(f"{name} has no score")


def is_volume_limits(plugin) -> bool:
    """A NodeVolumeLimits instance: NodeVolumeLimits itself or a legacy
    per-pool one (EBSLimits, GCEPDLimits, AzureDiskLimits, CinderLimits)."""
    return hasattr(plugin, "pool_ids")


def volume_limits_carry(prog) -> str | None:
    """The carry the kernels keep the attached volumes in: the first
    NodeVolumeLimits instance's (every instance carries the same one)."""
    return next((sp.plugin.name for sp in prog.plugins if is_volume_limits(sp.plugin)), None)


def sample_id(plugin) -> int | None:
    """The kernel id of a score sample (NodeNumber, DataProviderScore),
    from its static signature, else None."""
    sig = getattr(plugin, "static_sig", None)
    sig = sig() if sig is not None else None
    if sig and sig[0] in SAMPLE_IDS and hasattr(plugin, "score"):
        return SAMPLE_IDS[sig[0]]
    return None


def provider_rows(prog) -> list:
    """The DataProviderScore instances among the profile's scores, as
    (row in raw/final, ScoredPlugin)."""
    return [(row, sp) for row, sp in enumerate(prog.scores) if sample_id(sp.plugin) == SAMPLE_IDS["DataProviderScore"]]


def kernel_id(plugin) -> int:
    """The plugin's id in csrc/plugin_chain.cuh ``enum Plugin``."""
    sid = sample_id(plugin)
    return sid if sid is not None else PLUGIN_IDS[plugin.name]


def has_kernel_code(plugin) -> bool:
    """Whether the kernels run this plugin's filter and score."""
    return sample_id(plugin) is not None or is_volume_limits(plugin) or plugin.name in PLUGIN_IDS


def check_kernel_chain(prog) -> None:
    """Raise NotImplementedError for a filter or score the kernels have no
    code for (the plain path runs any plugin with a filter or score; a
    plugin enabled at neither point, a host-only one, costs the kernels
    nothing)."""
    for sp in prog.filters + prog.scores:
        if not has_kernel_code(sp.plugin):
            raise NotImplementedError(f"plugin {sp.plugin.name} has no kernel code in ksim_tpu_torch")


def chain_rows(prog) -> dict:
    """ChainParams' per-plugin rows of ``prog``, made once per program
    (after ``check_kernel_chain``): each kernel id's row among the filters
    (-1: off; NodeVolumeLimits' instances have theirs in nvl_row) and
    among the scores (-1: off; DataProviderScore's are in dp_row), its
    weight, and NodeNumber's reverse flag (None: NodeNumber off)."""
    rows = prog.kernel_tables.get("rows")
    if rows is not None:
        return rows
    check_kernel_chain(prog)
    f_row, s_row, weight = [-1] * NPLUGINS, [-1] * NPLUGINS, [0] * NPLUGINS
    nn_reverse = None
    for row, sp in enumerate(prog.filters):
        if not is_volume_limits(sp.plugin):
            f_row[kernel_id(sp.plugin)] = row
    for row, sp in enumerate(prog.scores):
        kid = kernel_id(sp.plugin)
        if kid == SAMPLE_IDS["NodeNumber"]:
            nn_reverse = int(sp.plugin.reverse)
        if kid != SAMPLE_IDS["DataProviderScore"]:
            s_row[kid], weight[kid] = row, sp.weight
    rows = {"f_row": f_row, "s_row": s_row, "weight": weight, "nn_reverse": nn_reverse}
    prog.kernel_tables["rows"] = rows
    return rows


def profile_tables(prog, device) -> dict:
    """The profile's tables the kernels read, as int32 tensors on
    ``device`` (made once per program and device): NodeResourcesFit's
    score resources, weights and shape points, BalancedAllocation's
    resources, the NodeVolumeLimits instances (each one's row among the
    filters and its pools) and PodTopologySpread's per-key singleton flags
    and domain counts, and the DataProviderScore instances (each one's row
    among the scores and its weight).  Sized by the profile: no cap."""
    key = str(device)
    if key in prog.kernel_tables:
        return prog.kernel_tables[key]
    names = {sp.plugin.name: sp.plugin for sp in prog.plugins}
    fit = names.get("NodeResourcesFit")
    bal = names.get("NodeResourcesBalancedAllocation")
    spread = names.get("PodTopologySpread")
    inst = [(row, sp.plugin.pool_ids) for row, sp in enumerate(prog.filters) if is_volume_limits(sp.plugin)]
    off = [0]
    for _, pools in inst:
        off.append(off[-1] + len(pools))
    lists = {
        "fit_spec_idx": [ri for ri, _ in fit._score_spec] if fit else [],
        "fit_spec_w": [w for _, w in fit._score_spec] if fit else [],
        "shape_u": [u for u, _ in fit._shape] if fit else [],
        "shape_s": [v for _, v in fit._shape] if fit else [],
        "bal_spec": list(bal._spec) if bal else [],
        "nvl_row": [row for row, _ in inst],
        "nvl_pool_off": off,
        "nvl_pools": [k for _, pools in inst for k in pools],
        "tk_singleton": [int(x) for x in spread.tk_singleton] if spread else [],
        "tk_size": list(spread.tk_sizes) if spread else [],
        "dp_row": [row for row, _ in provider_rows(prog)],
        "dp_w": [sp.weight for _, sp in provider_rows(prog)],
    }
    tables = {name: torch.tensor(v, dtype=torch.int32, device=device) for name, v in lists.items()}
    prog.kernel_tables[key] = tables
    return tables


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


def _axis_ptr(t: torch.Tensor | None, dtype: torch.dtype, shape: tuple, device, whole: int, part: int,
              base: int) -> int | None:
    """Pointer of an array whose leading axis a mesh may split: the whole
    array (``whole`` rows, ``shape``), or a shard of ``part`` rows starting
    at global row ``base``, passed less ``base`` rows so that the kernels
    index it by global row (csrc/plugin_chain.cuh ChainParams)."""
    if t is None or part == whole or t.shape[0] != part:
        return _ptr(t, dtype, shape, device)
    ptr = _ptr(t, dtype, (part,) + tuple(shape[1:]), device)
    return ptr - base * (t.numel() // part) * t.element_size()


def _node_ptr(prm: ChainParams, t, dtype, shape, device) -> int | None:
    """A node-axis array: whole, or this shard's NL rows (node_base on)."""
    return _axis_ptr(t, dtype, shape, device, prm.N, prm.NL, prm.node_base)


def put_state(prm: ChainParams, state) -> None:
    """The node state's pointers (the state a stage kernel reads, or the
    one a scan kernel commits into)."""
    i32, b = torch.int32, torch.bool
    dev = state.valid.device
    N, R = prm.N, prm.R
    for field, t, dtype, shape in (
        ("alloc", state.allocatable, i32, (N, R)), ("allowed", state.allowed_pods, i32, (N,)),
        ("nvalid", state.valid, b, (N,)), ("unsched", state.unschedulable, b, (N,)),
        ("requested", state.requested, i32, (N, R)), ("nz_requested", state.nonzero_requested, i32, (N, R)),
        ("pod_count", state.pod_count, i32, (N,)),
    ):
        setattr(prm, field, _node_ptr(prm, t, dtype, shape, dev))


def put_pods(prm: ChainParams, pods, valid=None) -> None:
    """The pod rows' pointers and their count ``Pc``: a PodBatch (its
    ``valid`` too) or a PodView (``valid`` given apart, or none)."""
    i32, b = torch.int32, torch.bool
    dev = pods.index.device
    Pc = prm.Pc = pods.index.shape[0]
    R = prm.R
    if valid is None:
        valid = getattr(pods, "valid", None)
    prm.pvalid = _ptr(valid, b, (Pc,), dev)
    for field, t, dtype, shape in (
        ("preq", pods.requests, i32, (Pc, R)), ("pnz", pods.nonzero_requests, i32, (Pc, R)),
        ("ptol", pods.tolerates_unschedulable, b, (Pc,)), ("phas", pods.has_requests, b, (Pc,)),
        ("pindex", pods.index, i32, (Pc,)),
    ):
        setattr(prm, field, _ptr(t, dtype, shape, dev))


def put_carries(prm: ChainParams, prog, carries: dict, device) -> None:
    """The carries' pointers of the plugins in ``prog`` (the scan kernels
    commit into them), after ``chain_params`` has set the shapes."""
    names = {sp.plugin.name for sp in prog.plugins}
    N = prm.N

    def put(field, t, shape):
        setattr(prm, field, _node_ptr(prm, t, torch.int32, shape, device))

    if "NodePorts" in names:
        put("port_counts", carries["NodePorts"], (N, prm.V))
    nvl = volume_limits_carry(prog)
    if nvl is not None:
        put("attached", carries[nvl], (N, prm.VV))
    if "VolumeRestrictions" in names:
        c = carries["VolumeRestrictions"]
        put("rwop", c["rwop"], (N, prm.RW))
        put("disk_any", c["disk_any"], (N, prm.DD))
        put("disk_rw", c["disk_rw"], (N, prm.DD))
    if "PodTopologySpread" in names:
        put("sp_counts", carries["PodTopologySpread"], (N, prm.SS))
    if "InterPodAffinity" in names:
        c = carries["InterPodAffinity"]
        for field in ("cnt", "ecnt", "ew"):
            put("ipa_" + field, c[field], (N, prm.T2))
        prm.ipa_total = _ptr(c["total"], torch.int32, (prm.T2,), device)


def chain_params(prog, state, pods, aux, carries, out: "dict | None", *, cluster: bool = False,
                 sampling: tuple | None = None, rows: int | None = None,
                 shard: "tuple[int, int, int, int] | None" = None) -> ChainParams:
    """Fill ChainParams for ``prog`` (engine/core.py _Program) over the
    pod chunk ``pods``.  ``state`` and the carries are the tensors the
    scan kernels update in place; ``out`` holds the output tensors of the
    record mode (plus ``visited`` under sampling), or is None for a
    stage of kernel E (kernels/chain_stages.py), which gives its own.  ``cluster`` allocates
    the spread domain scratch, where it is not in shared memory, for a
    cluster launch (a partial and a combined array for each of up to
    MAX_CLUSTER blocks); else the launch allocates its own per block
    (``domain_ints`` each) and sets ``sp_scratch``;
    ``sampling`` is (start [1] i32 tensor, n_real, k >= 1) for kernel C.
    ``rows`` is the records' row count when it is not the chunk's (kernel
    D records per attempt), and ``out["total"]`` may then be None (no
    total kept).  The tensors the kernel reads but the caller does not
    hold (the scratch) are kept alive on the returned object.

    ``shard`` = (node_base, N, pod_base, P) makes the program one node
    shard's (kernels/sharded.py): N and P are the global node and pod
    counts; the state, the carries and any node-axis aux array may hold
    only the shard's rows from node_base on, any pod-axis aux array only
    the rows from pod_base on, the rest whole; the outputs keep the global
    node axis."""
    i32, f32, f64, b = torch.int32, torch.float32, torch.float64, torch.bool
    dev = state.valid.device
    NL, R = state.allocatable.shape
    Pc = pods.index.shape[0]
    P_loc = aux["nodename"]["pod_req_node"].shape[0]
    node_base, N, pod_base, P_all = (0, NL, 0, P_loc) if shard is None else shard
    prm = ChainParams()
    prm.N, prm.R = N, R
    prm.NL, prm.node_base = NL, node_base
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

    def nput(field, t, dtype, shape):
        setattr(prm, field, _node_ptr(prm, t, dtype, shape, dev))

    def pput(field, t, dtype, shape):
        setattr(prm, field, _axis_ptr(t, dtype, shape, dev, P_all, P_loc, pod_base))

    put_state(prm, state)
    put_pods(prm, pods)

    kr = chain_rows(prog)
    prm.f_row[:] = kr["f_row"]
    prm.s_row[:] = kr["s_row"]
    prm.weight[:] = kr["weight"]
    names = {sp.plugin.name: sp.plugin for sp in prog.plugins}
    tables = profile_tables(prog, dev)
    for name, t in tables.items():
        put(name, t, i32, tuple(t.shape))
    prm.nvl_ninst = tables["nvl_row"].shape[0]
    prm.sp_ntk = tables["tk_size"].shape[0]
    prm.dp_n = tables["dp_row"].shape[0]
    keep = []

    # The score samples: the node and pod digits, the provided scores.
    if kr["nn_reverse"] is not None:
        a = aux["nodenumber"]
        nput("nn_node", a["node_digit"], i32, (N,))
        pput("nn_pod", a["pod_digit"], i32, (P_all,))
        prm.nn_reverse = kr["nn_reverse"]
    if prm.dp_n:
        dp = provider_scores(prog, aux)
        put("dp_score", dp, i32, (prm.dp_n, N))
        keep.append(dp)

    # Every aux family goes in whole: PodTopologySpread reads the
    # NodeAffinity and TaintToleration tables whether or not those
    # plugins are in the profile.
    pput("pod_req_node", aux["nodename"]["pod_req_node"], i32, (P_all,))
    a = aux["taints"]
    W = prm.W = a["forbidding"].shape[0]
    nput("taint_order", a["node_taint_order"], i32, (N, W))
    put("forbidding", a["forbidding"], b, (W,))
    put("prefer", a["prefer"], b, (W,))
    pput("pod_tolerated", a["pod_tolerated"], b, (P_all, W))
    pput("pod_tolerated_prefer", a["pod_tolerated_prefer"], b, (P_all, W))
    a = aux["affinity"]
    T = prm.T = a["term_size"].shape[0]
    nput("term_ok", a["term_ok"], b, (N, T))
    pput("selector_term", a["selector_term"], i32, (P_all,))
    pput("has_required", a["has_required"], b, (P_all,))
    pput("required_terms", a["required_terms"], b, (P_all, T))
    pput("preferred_weights", a["preferred_weights"], i32, (P_all, T))
    put("added_terms", a["added_terms"], b, (T,))
    put("has_added", a["has_added"], b, (1,))
    put("added_pref", a["added_pref"], i32, (T,))
    a = aux["nodeports"]
    V = prm.V = a["pod_wants"].shape[1]
    pput("pod_wants", a["pod_wants"], b, (P_all, V))
    pput("pod_adds", a["pod_adds"], i32, (P_all, V))
    a = aux["imagelocality"]
    I = prm.I = a["image_size"].shape[0]
    nput("node_has_image", a["node_has_image"], b, (N, I))
    put("image_size", a["image_size"], f64, (I,))
    put("image_num_nodes", a["image_num_nodes"], i32, (I,))
    put("total_nodes_f", a["total_nodes_f"], f64, ())
    pput("pod_image_count", a["pod_image_count"], i32, (P_all, I))
    pput("pod_num_containers", a["pod_num_containers"], i32, (P_all,))
    if "NodeResourcesFit" in names:
        fit = names["NodeResourcesFit"]
        prm.fit_base_count = fit._base_count
        prm.fit_strategy = STRATEGY_IDS[fit._strategy]
        prm.fit_nspec = len(fit._score_spec)
        prm.fit_nshape = len(fit._shape)
    if "NodeResourcesBalancedAllocation" in names:
        prm.bal_nspec = len(names["NodeResourcesBalancedAllocation"]._spec)

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
    pput("pod_pv", a["pod_pv"], b, (P_all, NPV))
    pput("pod_wffc", a["pod_wffc"], b, (P_all, NC))
    pput("pod_fail", a["pod_fail"], i32, (P_all,))
    nput("vol_limits", a["limits"], i32, (N, NK))
    put("vol_key", a["vol_key"], i32, (VV,))
    pput("pod_vol", a["pod_vol"], b, (P_all, VV))
    pput("pod_rwop", a["pod_rwop"], b, (P_all, RW))
    pput("pod_disk_any", a["pod_disk_any"], b, (P_all, DD))
    pput("pod_disk_rw", a["pod_disk_rw"], b, (P_all, DD))
    put("disk_shareable", a["disk_ro_shareable"], b, (DD,))

    a = aux["spread"]
    TK = prm.TK = a["node_ldom"].shape[1]
    SS = prm.SS = a["pod_sel_match"].shape[1]
    MC = prm.MC = a["con_valid"].shape[1]
    nput("sp_ldom", a["node_ldom"], i32, (N, TK))
    pput("sp_sel_match", a["pod_sel_match"], b, (P_all, SS))
    for field, dtype in (
        ("valid", b), ("mode", i32), ("sel", i32), ("tk", i32), ("max_skew", i32),
        ("min_domains", i32), ("self", b), ("honor_aff", b), ("honor_taints", b),
    ):
        pput("con_" + field, a["con_" + field], dtype, (P_all, MC))
    pput("has_score_con", a["has_score_con"], b, (P_all,))
    if "PodTopologySpread" in names:
        sp = names["PodTopologySpread"]
        prm.DMAX = max((size for size, single in zip(sp.tk_sizes, sp.tk_singleton) if not single), default=0)
        dom_ints = domain_ints(prm)
        prm.sp_smem = int(4 * dom_ints <= DOMAIN_SMEM_BYTES)
        if not prm.sp_smem and cluster:
            shape = (MAX_CLUSTER, 2 * dom_ints)
            scratch = torch.empty(shape, dtype=i32, device=dev)
            keep.append(scratch)
            put("sp_scratch", scratch, i32, shape)
        logw = a["log_w64"] if prog.exact else a["log_w32"]
        put("sp_logw", logw, f64 if prog.exact else f32, (N + 1,))

    a = aux["interpod"]
    T2 = prm.T2 = a["dom_t"].shape[1]
    prm.TKI = a["node_dom"].shape[1]
    nput("ipa_dom", a["dom_t"], i32, (N, T2))
    put("ipa_term_tk", a["term_tk"], i32, (T2,))
    for field, src, dtype in (
        ("ipa_qm", "pod_term_match", b), ("ipa_raff", "req_aff", b), ("ipa_ranti", "req_anti", b),
        ("ipa_pref_w", "pref_w", i32), ("ipa_vw", "pod_vw", i32), ("ipa_eat", "pod_eat", i32),
    ):
        pput(field, a[src], dtype, (P_all, T2))
    pput("ipa_self_aff", a["self_aff"], b, (P_all,))
    put_carries(prm, prog, carries, dev)

    if sampling is not None:
        start, n_real, k = sampling
        if k < 1:
            raise ValueError(f"sampling k={k}: the visit stops at the k-th feasible node, k >= 1")
        put("samp_start", start, i32, (1,))
        prm.n_real, prm.samp_k = n_real, k
        if prog.record == "full":
            put("visited_out", out["visited"], b, (Pc, N))

    prm.keep = keep + [tables]
    if out is None:
        return prm
    rows = Pc if rows is None else rows
    put("selected", out["selected"], i32, (Pc,))
    if prog.record in ("final", "full"):
        put("total", out["total"], i32, (rows, N))
        put("final_out", out["final"], final_dtype, (rows, prm.S, N))
    if prog.record == "full":
        put("bits_out", out["bits"], bits_dtype, (rows, prm.F, N))
        put("raw_out", out["raw"], raw_dtype, (rows, prm.S, N))
    return prm


def provider_scores(prog, aux: dict) -> torch.Tensor:
    """The DataProviderScore instances' provided scores as one int32
    [instances, N] array, in the profile's score order: stacked once per
    device aux (a snapshot's) and profile, kept on the aux."""
    names = tuple(sp.plugin.name for _, sp in provider_rows(prog))
    stacks = aux.setdefault("provider_stack", {})
    t = stacks.get(names)
    if t is None:
        t = torch.stack([aux[f"provider:{n}"]["provided_score"].to(torch.int32) for n in names]).contiguous()
        stacks[names] = t
    return t


def domain_ints(prm: ChainParams) -> int:
    """Ints of one block's spread domain scratch (csrc/plugin_chain.cuh
    ``domain_ints``): filter sum, filter presence, score registration and
    score sum per constraint and domain."""
    return 4 * prm.MC * prm.DMAX


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


def fresh_scan_state(prog, state, carries: dict):
    """Fresh copies of the node state's carried fields and of the carries
    (tensors or dicts of tensors), for a scan kernel that commits into
    them in place: its inputs stay unmodified.  Every NodeVolumeLimits
    instance gets the one copy the kernel commits into (their carries are
    equal: each commit saturates the same attachments)."""
    state = state._replace(
        requested=state.requested.clone(),
        nonzero_requested=state.nonzero_requested.clone(),
        pod_count=state.pod_count.clone(),
    )
    carries = {
        k: {f: t.clone() for f, t in v.items()} if isinstance(v, dict) else v.clone()
        for k, v in carries.items()
    }
    nvl = volume_limits_carry(prog)
    for sp in prog.plugins:
        if is_volume_limits(sp.plugin) and sp.plugin.name in carries:
            carries[sp.plugin.name] = carries[nvl]
    return state, carries


def cluster_threads(n_nodes: int, size: int) -> int:
    """Threads per block of a cluster launch (csrc/cluster_scan.cuh
    ``cluster_threads``): one node slot each for N / size nodes, rounded
    up to whole warps, between one warp and MAX_THREADS."""
    per = -(-n_nodes // size)
    return min(MAX_THREADS, max(32, -(-per // 32) * 32))


def cluster_slots(n_nodes: int, size: int, threads: int) -> int:
    """Node slots per block (``cluster_slots``): whole cluster tiles of
    size * threads nodes."""
    return -(-n_nodes // (size * threads)) * threads


def block_nodes(n_nodes: int, size: int, threads: int, rank: int) -> list[int]:
    """The nodes block ``rank`` of a cluster owns, in slot order
    (``ClusterTeam::node``): chunks of 32 nodes dealt round robin over the
    ranks, slot li holding node ((li // 32) * size + rank) * 32 + li % 32.
    Thread t owns slots t, t + threads, ..."""
    nodes = ((((li >> 5) * size) + rank) << 5 | (li & 31) for li in range(cluster_slots(n_nodes, size, threads)))
    return [n for n in nodes if n < n_nodes]


def cluster_smem_bytes(prm: ChainParams, size: int, threads: int = 0) -> int:
    """The dynamic shared memory of one block of a ``size``-block cluster
    (``cluster_smem_bytes``): 13 bytes per node slot, the reduction and
    prefix-count scratch, the term totals' copy, the pod's spread
    constraints and, when it fits, a partial and a combined
    PodTopologySpread domain scratch."""
    n = prm.NL or prm.N  # this shard's nodes (all of them unsharded)
    slots = cluster_slots(n, size, threads or cluster_threads(n, size))
    dom = 2 * 4 * 4 * prm.MC * prm.DMAX if prm.sp_smem else 0
    ints = 33 * RED_MAX + SCAN_INTS + 2 * RED_MAX + 2 * 32 + 2 * 32 + prm.T2 + (prm.T2 + 2 if prm.xs else 0)
    return ((13 * slots + 7) & ~7) + 8 * prm.I + 8 * 33 + 8 * 2 + 4 * ints + SPREAD_CON_BYTES * prm.MC + dom


def stage_cluster_cap(n_rows: int, sms: int) -> int:
    """The largest cluster kernel E's cluster stages may take for
    ``n_rows`` pod rows on a card of ``sms`` SMs (csrc/chain_stages.cu
    ``stage_cluster_cap``): the largest of 16, 8, 4, 2 whose n_rows
    clusters take no more blocks than the card has SMs, else 1."""
    cs = MAX_CLUSTER
    while cs > 1 and n_rows * cs > sms:
        cs //= 2
    return cs


def stage_cluster(n_rows: int, sms: int, fits) -> int:
    """The cluster size of such a launch (``stage_cluster``): the largest
    size up to the cap at which the card holds all n_rows clusters at once
    (``fits(size)``, the occupancy query's answer, at least n_rows), else
    1.  At one row: 16 where a 16-block cluster fits, else 8."""
    cs = stage_cluster_cap(n_rows, sms)
    while cs > 1 and fits(cs) < n_rows:
        cs //= 2
    return cs


def stage_threads(n_nodes: int, size: int) -> int:
    """Threads per block of such a launch (``stage_threads``): one block of
    STAGE_BLOCK_THREADS on a cluster of one, else one node slot each for
    N / size nodes, at most STAGE_MAX_THREADS."""
    return STAGE_BLOCK_THREADS if size == 1 else min(STAGE_MAX_THREADS, cluster_threads(n_nodes, size))


def stage_smem_bytes(prm: ChainParams, size: int, stage: str) -> int:
    """The dynamic shared memory of one block of a launch of ``stage``
    ("filter", "score", "normalize", "window" or "select") on
    ``size``-block clusters (``stage_cluster_smem_bytes``): the parts of
    STAGE_PARTS."""
    sizes = {
        "imgw": 8 * prm.I,
        "red64": 8 * (33 + 2),
        "red": 4 * (33 * RED_MAX + 2 * RED_MAX),
        "tot": 4 * prm.T2,
        "con": SPREAD_CON_BYTES * prm.MC,
        "dom": 2 * 4 * 4 * prm.MC * prm.DMAX if prm.sp_smem else 0,
        "walk": 4 * (SCAN_INTS + 2 * 32 + 2 * 32),
        "flags": cluster_slots(prm.N, size, stage_threads(prm.N, size)),
    }
    return sum(sizes[part] for part in STAGE_PARTS[stage])


def stage_scratch_row(cluster: int, rank: int, size: int) -> int:
    """The row pair of the global domain scratch (``2 * domain_ints`` ints:
    partial, combined) that block ``rank`` of cluster ``cluster`` of an E1
    or E2 launch takes where the domains do not fit shared memory
    (``carve_stage_cluster``)."""
    return cluster * size + rank


def check_stage_smem(prm: ChainParams, size: int, stage: str) -> None:
    """Raise ValueError when one block of a launch of ``stage`` at cluster
    ``size`` needs more shared memory than one block may take: the score
    and window stages hold one flag byte per node slot, about N / size of
    them."""
    need = stage_smem_bytes(prm, size, stage)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"padded node axis N={prm.N} needs {need} bytes of shared memory per block of kernel E's "
            f"{stage} stage on a {size}-block cluster, over the {MAX_SMEM_BYTES} "
            f"bytes one block may take on sm_90")


def check_smem(prm: ChainParams, *, cluster: int, extra: int = 0, threads: int = 0) -> None:
    """Raise ValueError when one block of a ``cluster``-block cluster
    (kernels A, C and D) needs more shared memory (the chain's plus
    ``extra``) than one block may take, naming the padded node count and
    the bound: each block holds about N / cluster node slots at 13 bytes
    each, so the bound is about ``cluster`` times one block's."""
    need = cluster_smem_bytes(prm, cluster, threads) + extra
    if need > MAX_SMEM_BYTES:
        n = prm.NL or prm.N
        nt = threads or cluster_threads(n, cluster)
        fixed = need - 13 * cluster_slots(n, cluster, nt)
        slots = (MAX_SMEM_BYTES - fixed - 7) // 13 // nt * nt  # whole tiles
        raise ValueError(
            f"padded node axis N={prm.N} needs {need} bytes of shared memory per block of a "
            f"{cluster}-block cluster, over the {MAX_SMEM_BYTES} bytes one block may take on sm_90: "
            f"at 13 bytes per node slot a block of {nt} threads holds at most {slots} slots, "
            f"{slots * cluster} padded nodes for this cluster, profile and vocabulary"
        )


def check_cluster_shape(size: int, threads: int) -> None:
    """Raise ValueError for a forced cluster size or block width a cluster
    launch cannot take (0 leaves each to the launch)."""
    if not 0 <= size <= MAX_CLUSTER or not (0 <= threads <= MAX_THREADS and threads % 32 == 0):
        raise ValueError(f"cluster size {size} / threads {threads}: 0..{MAX_CLUSTER} blocks, "
                         f"0..{MAX_THREADS} threads in whole warps")


def launch_cluster(lib, entry: str, prm: ChainParams) -> dict:
    """Call a cluster-scan ``entry`` (kernels A and C) on the current
    stream with CLUSTER_SIZE and CLUSTER_THREADS; raise on a nonzero
    error, a refused launch included (no smaller launch takes over).
    Returns what ran: {"cluster": blocks, "threads": per block,
    "smem_bytes": per block, "stats": int64 [2 + len(CLUSTER_PHASES)] on
    the card: the cluster barriers and the pods evaluated, as block 0
    counted them, then block 0's clock cycles in each phase}.  A node axis
    over the shared-memory bound of the smallest cluster the launch may
    take raises ValueError before the launch."""
    size, threads = CLUSTER_SIZE, CLUSTER_THREADS
    check_cluster_shape(size, threads)
    check_smem(prm, cluster=size or 8, threads=threads)
    stats = torch.zeros(2 + len(CLUSTER_PHASES), dtype=torch.int64, device="cuda")
    info = (ctypes.c_longlong * 3)()
    stream = torch.cuda.current_stream().cuda_stream
    # A profiler range named after the entry: a torch.profiler trace
    # (SchedulerService.start_profiling) names the launch by it.
    with torch.profiler.record_function(entry):
        err = getattr(lib, entry)(ctypes.byref(prm), ctypes.c_void_p(stream), size, threads,
                                  ctypes.c_void_p(stats.data_ptr()), info)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: {lib.ksim_error_string(err).decode()}")
    return {"cluster": info[0], "threads": info[1], "smem_bytes": info[2], "stats": stats}
