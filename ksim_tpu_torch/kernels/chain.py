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
}
STRATEGY_IDS = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
NPLUGINS = 8
MAX_SPEC = 8
MAX_SHAPE = 16
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
    "selected", "total", "final_out", "bits_out", "raw_out",
)


class ChainParams(ctypes.Structure):
    _fields_ = (
        [(name, _P) for name in _POINTERS]
        + [(name, _L) for name in (
            "N", "R", "W", "T", "V", "I", "Pc", "F", "S",
            "record", "bits_size", "final_size", "raw_size", "exact",
        )]
        + [("f_row", _L * NPLUGINS), ("s_row", _L * NPLUGINS), ("weight", _L * NPLUGINS)]
        + [("fit_base_count", _L), ("fit_strategy", _L), ("fit_nspec", _L),
           ("fit_spec_idx", _L * MAX_SPEC), ("fit_spec_w", _L * MAX_SPEC),
           ("fit_nshape", _L), ("shape_u", _L * MAX_SHAPE), ("shape_s", _L * MAX_SHAPE)]
        + [("bal_nspec", _L), ("bal_spec", _L * MAX_SPEC)]
    )


def check_chain(plugins) -> None:
    """Raise NotImplementedError for a chain the kernels cannot run."""
    seen = set()
    for sp in plugins:
        name = sp.plugin.name
        if name not in PLUGIN_IDS:
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


def chain_params(prog, state, pods, aux, carries, out: dict) -> ChainParams:
    """Fill ChainParams for ``prog`` (engine/core.py _Program) over the
    pod chunk ``pods``.  ``state`` and ``carries["NodePorts"]`` are the
    tensors the kernel may update in place; ``out`` holds the output
    tensors of the record mode."""
    i32, f64, b = torch.int32, torch.float64, torch.bool
    dev = state.valid.device
    N, R = state.allocatable.shape
    Pc = pods.valid.shape[0]
    P_all = aux["nodename"]["pod_req_node"].shape[0] if "nodename" in aux else 0
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

    if "NodeName" in names:
        put("pod_req_node", aux["nodename"]["pod_req_node"], i32, (P_all,))
    if "TaintToleration" in names:
        a = aux["taints"]
        W = a["forbidding"].shape[0]
        prm.W = W
        put("taint_order", a["node_taint_order"], i32, (N, W))
        put("forbidding", a["forbidding"], b, (W,))
        put("prefer", a["prefer"], b, (W,))
        put("pod_tolerated", a["pod_tolerated"], b, (P_all, W))
        put("pod_tolerated_prefer", a["pod_tolerated_prefer"], b, (P_all, W))
    if "NodeAffinity" in names:
        a = aux["affinity"]
        T = a["term_size"].shape[0]
        prm.T = T
        put("term_ok", a["term_ok"], b, (N, T))
        put("selector_term", a["selector_term"], i32, (P_all,))
        put("has_required", a["has_required"], b, (P_all,))
        put("required_terms", a["required_terms"], b, (P_all, T))
        put("preferred_weights", a["preferred_weights"], i32, (P_all, T))
        put("added_terms", a["added_terms"], b, (T,))
        put("has_added", a["has_added"], b, (1,))
        put("added_pref", a["added_pref"], i32, (T,))
    if "NodePorts" in names:
        a = aux["nodeports"]
        V = a["pod_wants"].shape[1]
        prm.V = V
        put("port_counts", carries["NodePorts"], i32, (N, V))
        put("pod_wants", a["pod_wants"], b, (P_all, V))
        put("pod_adds", a["pod_adds"], i32, (P_all, V))
    if "ImageLocality" in names:
        a = aux["imagelocality"]
        I = a["image_size"].shape[0]
        prm.I = I
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

    put("selected", out["selected"], i32, (Pc,))
    if prog.record in ("final", "full"):
        put("total", out["total"], i32, (Pc, N))
        put("final_out", out["final"], final_dtype, (Pc, prm.S, N))
    if prog.record == "full":
        put("bits_out", out["bits"], bits_dtype, (Pc, prm.F, N))
        put("raw_out", out["raw"], raw_dtype, (Pc, prm.S, N))
    return prm


def empty_outputs(prog, n_pods: int, n_nodes: int, device) -> dict:
    """Output tensors of ``prog.record`` for ``n_pods`` pods, in the
    recorded dtypes (engine/core.py _Program.dtypes)."""
    bits_dtype, final_dtype, raw_dtype = prog.dtypes
    F, S = len(prog.filters), len(prog.scores)
    out = {"selected": torch.empty(n_pods, dtype=torch.int32, device=device)}
    if prog.record in ("final", "full"):
        out["total"] = torch.empty((n_pods, n_nodes), dtype=torch.int32, device=device)
        out["final"] = torch.empty((n_pods, S, n_nodes), dtype=final_dtype, device=device)
    if prog.record == "full":
        out["bits"] = torch.empty((n_pods, F, n_nodes), dtype=bits_dtype, device=device)
        out["raw"] = torch.empty((n_pods, S, n_nodes), dtype=raw_dtype, device=device)
    return out


def launch(lib, entry: str, prm: ChainParams) -> None:
    """Call ``entry`` on the current stream; raise on a nonzero
    cudaGetLastError()."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, entry)(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: {lib.ksim_error_string(err).decode()}")
