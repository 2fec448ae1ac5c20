"""Kernel B wrapper: batch evaluation of a pod chunk against a fixed
node state (no commit).

``batch_eval(prog, state, pods, aux, carries)`` returns the recorded
outputs of ``prog.record`` for every pod of ``pods``.  Tensors on the CPU
take ``batch_eval_plain``; tensors on a CUDA device launch
csrc/batch_eval.cu: its pre-pass (``node_summary``, one thread per node)
folds the fixed node state into per-node words, then the persistent grid
(as many blocks as are resident at once, block b taking pods b, b + grid,
...) evaluates every pod against them.  What the last launch ran (grid,
blocks per SM, registers, shared memory, block 0's cycles by phase) is
kept in ``batch_eval.last``.
"""

from __future__ import annotations

import ctypes

import torch

from ksim_tpu_torch.kernels import build, chain
from ksim_tpu_torch.plugins.base import PodBatch

# Pods per step of the plain version: bounds its [B, N, vocab]
# intermediates, as the reference's lax.map over vmap blocks does.
PLAIN_BLOCK = 256

# The word groups of csrc/batch_eval.cu (Group): the node summary's first
# NODE_GROUPS, the pod's staged words all of them.
GROUPS = ("ports", "taint_forbid", "taint_prefer", "terms", "images", "rwop", "disk_any", "disk_rw",
          "interpod_cnt", "interpod_ecnt", "preferred", "interpod_raw")
NODE_GROUPS = 10
B_THREADS = 256
MIN_BLOCKS = 4
# The persistent grid's blocks (0: every block resident at once, at most
# one per pod); a test forces a size to stride the pods differently.
GRID = 0
# Shared memory of one SM (228 KB) and what the card reserves per block.
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
# The occupancy answer per (device, shared memory per block): blocks per
# SM, SMs, shared memory, registers, local bytes.
_OCCUPANCY: dict[tuple[int, int], tuple[int, ...]] = {}
# The phases of a pod kernel B times, as csrc/plugin_chain.cuh Phase
# indices summed per name (its two spread statistics together).
B_PHASES = {
    "setup": (0,), "spread statistics": (1, 4), "filters": (2,), "scores": (5,),
    "extrema reduce": (6,), "normalize": (7,), "select": (8,), "between pods": (9,),
}

_P = ctypes.c_void_p
_L = ctypes.c_longlong


class SummaryParams(ctypes.Structure):
    """Mirror of ``struct SummaryParams`` (csrc/batch_eval.cu)."""

    _fields_ = (
        [(name, _P) for name in ("words", "room", "aff_added", "nflags", "node_scratch", "stats")]
        + [("off", _L * (len(GROUPS) + 1)), ("size", _L * len(GROUPS))]
        + [("node_stride", _L)]
    )


def group_sizes(aux: dict) -> tuple[int, ...]:
    """Bits of each word group: V, W, W, T, I, RW, DD, DD, T2, T2, T, T2."""
    V = aux["nodeports"]["pod_wants"].shape[1]
    W = aux["taints"]["forbidding"].shape[0]
    T = aux["affinity"]["term_size"].shape[0]
    I = aux["imagelocality"]["image_size"].shape[0]
    RW = aux["volumes"]["pod_rwop"].shape[1]
    DD = aux["volumes"]["pod_disk_any"].shape[1]
    T2 = aux["interpod"]["dom_t"].shape[1]
    return (V, W, W, T, I, RW, DD, DD, T2, T2, T, T2)


def word_offsets(sizes: tuple[int, ...]) -> list[int]:
    """The first word of each group, 64 bits to a word, and the total."""
    off = [0]
    for size in sizes:
        off.append(off[-1] + -(-size // 64))
    return off


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool [N, X] -> the words int64 [ceil(X / 64), N] (bit b of word w is
    column 64 w + b; the kernel writes them as uint64, the same bits)."""
    N, X = bits.shape
    nw = -(-X // 64)
    padded = torch.zeros((N, nw * 64), dtype=torch.int64, device=bits.device)
    padded[:, :X] = bits.to(torch.int64)
    padded = padded.reshape(N, nw, 64)
    shift = torch.arange(32, dtype=torch.int64, device=bits.device)
    low = (padded[..., :32] << shift).sum(-1)
    mid = (padded[..., 32:63] << shift[:31]).sum(-1)  # bits 32..62, below 2**31
    top = torch.where(padded[..., 63] != 0, torch.iinfo(torch.int64).min, 0)
    return (low | (mid << 32) | top).T.contiguous()


def _node_bits(prog, state, aux, carries) -> list[torch.Tensor]:
    """Each node group's bits, bool [N, size]."""
    N = state.valid.shape[0]
    names = {sp.plugin.name for sp in prog.plugins}
    sizes = group_sizes(aux)
    dev = state.valid.device

    def carried(name, field=None, size=0):
        if name not in names:
            return torch.zeros((N, size), dtype=torch.bool, device=dev)
        c = carries[name] if field is None else carries[name][field]
        return c > 0

    order = aux["taints"]["node_taint_order"] > 0
    vr, ipa = ("VolumeRestrictions",), ("InterPodAffinity",)
    return [
        carried("NodePorts", size=sizes[0]),
        order & aux["taints"]["forbidding"][None, :],
        order & aux["taints"]["prefer"][None, :],
        aux["affinity"]["term_ok"],
        aux["imagelocality"]["node_has_image"],
        carried(*vr, "rwop", sizes[5]),
        carried(*vr, "disk_any", sizes[6]),
        carried(*vr, "disk_rw", sizes[7]),
        carried(*ipa, "cnt", sizes[8]),
        carried(*ipa, "ecnt", sizes[9]),
    ]


def node_summary_plain(prog, state, aux, carries) -> dict:
    """The plain PyTorch version of the pre-pass: {"words": int64
    [words, N] (the node groups' bit sets), "room": int32 [NK, N] (each
    pool's limit less the node's attached volumes in it, INT32_MAX without
    a limit; None without a NodeVolumeLimits instance), "aff_added": int32
    [N] (the added node-affinity preferences of the terms the node
    satisfies), "flags": uint8 [N] (1: the added required terms admit the
    node)}."""
    words = torch.cat([pack_words(bits) for bits in _node_bits(prog, state, aux, carries)])
    aff = aux["affinity"]
    term_ok = aff["term_ok"]
    aff_added = (term_ok.to(torch.int32) * aff["added_pref"][None, :]).sum(1, dtype=torch.int32)
    added_ok = ~aff["has_added"][0] | (term_ok & aff["added_terms"][None, :]).any(1)
    room = None
    nvl = chain.volume_limits_carry(prog)
    if nvl is not None:
        vol = aux["volumes"]
        limits = vol["limits"]  # [N, NK]
        attached = carries[nvl] > 0  # [N, VV]
        in_pool = vol["vol_key"][None, :] == torch.arange(limits.shape[1], device=limits.device)[:, None]
        used = (attached[:, None, :] & in_pool[None, :, :]).sum(-1, dtype=torch.int32)  # [N, NK]
        room = torch.where(limits >= 0, limits - used, torch.iinfo(torch.int32).max).T.contiguous()
    return {"words": words, "room": room, "aff_added": aff_added, "flags": added_ok.to(torch.uint8)}


def _summary_outputs(prog, state, aux, device) -> dict:
    N = state.valid.shape[0]
    off = word_offsets(group_sizes(aux))
    NK = aux["volumes"]["limits"].shape[1]
    has_nvl = chain.volume_limits_carry(prog) is not None
    return {
        "words": torch.empty((off[NODE_GROUPS], N), dtype=torch.int64, device=device),
        "room": torch.empty((NK, N), dtype=torch.int32, device=device) if has_nvl else None,
        "aff_added": torch.empty(N, dtype=torch.int32, device=device),
        "flags": torch.empty(N, dtype=torch.uint8, device=device),
    }


def summary_params(aux, summary: dict, N: int) -> SummaryParams:
    """SummaryParams over the summary tensors (no scratch, no stats)."""
    sp = SummaryParams()
    sizes = group_sizes(aux)
    for g, o in enumerate(word_offsets(sizes)):
        sp.off[g] = o
    for g, size in enumerate(sizes):
        sp.size[g] = size
    dev = summary["words"].device
    sp.words = chain._ptr(summary["words"], torch.int64, (sp.off[NODE_GROUPS], N), dev)
    if summary["room"] is not None:
        sp.room = chain._ptr(summary["room"], torch.int32, tuple(summary["room"].shape), dev)
    sp.aff_added = chain._ptr(summary["aff_added"], torch.int32, (N,), dev)
    sp.nflags = chain._ptr(summary["flags"], torch.uint8, (N,), dev)
    return sp


def batch_fixed_bytes(prm: chain.ChainParams, sp: SummaryParams) -> int:
    """A block's shared memory besides the node arrays (csrc/batch_eval.cu
    ``batch_fixed_bytes``): the pod's words, image weights, the reduction
    and prefix scratch, the pod's spread constraints, the domain scratch
    when it fits, the preferred weights and the pod's flags."""
    dom = 4 * 4 * prm.MC * prm.DMAX if prm.sp_smem else 0
    return (8 * sp.off[len(GROUPS)] + 8 * prm.I + 8 * 33 + 4 * 33 * chain.RED_MAX + 4 * chain.SCAN_INTS
            + chain.SPREAD_CON_BYTES * prm.MC + dom + 4 * prm.T + 4)


def batch_smem_bytes(prm: chain.ChainParams, sp: SummaryParams) -> int:
    """Kernel B's dynamic shared memory per block (``batch_smem_bytes``):
    no node array, so no bound on the node axis.  The 5 bytes per node
    (flags, partial) live in a global scratch row per resident block."""
    return (batch_fixed_bytes(prm, sp) + 7) & ~7


def launch_grid(n_pods: int, per_sm: int, sms: int) -> int:
    """The persistent grid: every resident block, no more blocks than pods."""
    if per_sm < 1:
        raise RuntimeError("kernel B: the card holds no block of this shape (occupancy query: 0 blocks per SM)")
    return max(1, min(n_pods, per_sm * sms))


def block_pods(n_pods: int, grid: int, block: int) -> list[int]:
    """The pods block ``block`` of the persistent grid evaluates, in order
    (csrc/batch_eval.cu batch_eval_kernel): block, block + grid, ..."""
    return list(range(block, n_pods, grid))


def batch_eval_plain(prog, state, pods, aux, carries, block: int = PLAIN_BLOCK):
    """The plain PyTorch version: the chain batched over ``block`` pods at
    a time."""
    outs = []
    for s in range(0, pods.valid.shape[0], block):
        blk = pods.rows(s, s + block)
        ok, bits, raw, final, total = prog.eval_block(state, blk.view(), aux, carries)
        best = torch.where(blk.valid, prog.select(ok, total), -1)
        outs.append(prog.pod_outputs(blk.valid, best, bits, raw, final, total))
    if not outs:
        return chain.empty_outputs(prog, 0, state.valid.shape[0], state.valid.device)
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _load():
    lib = build.load("batch_eval")
    if not getattr(lib, "_ksim_batch_checked", False):
        lib.ksim_summary_params_size.restype = ctypes.c_longlong
        if lib.ksim_summary_params_size() != ctypes.sizeof(SummaryParams):
            raise RuntimeError("SummaryParams differs between csrc/batch_eval.cu and kernels/batch_eval.py")
        lib.ksim_node_summary.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.ksim_node_summary.restype = ctypes.c_int
        lib.ksim_batch_eval_occupancy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
        lib.ksim_batch_eval_occupancy.restype = ctypes.c_int
        lib._ksim_batch_checked = True
    return lib


def _check(lib, entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: {lib.ksim_error_string(err).decode()}")


def _launch_summary(lib, prm: chain.ChainParams, sp: SummaryParams) -> None:
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    _check(lib, "ksim_node_summary", lib.ksim_node_summary(ctypes.byref(prm), ctypes.byref(sp), stream))
    node_summary.launches += 1


def node_summary_launcher(prog, state, aux, carries):
    """(launch, outputs): the pre-pass's parameters over fresh CUDA output
    tensors and a callable that launches it on them (each call counts),
    so that the launch can be timed apart from building its parameters."""
    lib = _load()
    device = state.valid.device
    out = _summary_outputs(prog, state, aux, device)
    prm = chain.chain_params(prog, state, _no_pods(state), aux, carries,
                             chain.empty_outputs(prog, 0, state.valid.shape[0], device))
    sp = summary_params(aux, out, state.valid.shape[0])
    return (lambda: _launch_summary(lib, prm, sp)), out


def node_summary(prog, state, aux, carries) -> dict:
    """The pre-pass alone (``node_summary_plain``'s outputs): the plain
    version for CPU tensors, the kernel for CUDA ones."""
    device = state.valid.device
    if device.type == "cpu":
        return node_summary_plain(prog, state, aux, carries)
    if device.type != "cuda":
        raise ValueError(f"node_summary runs on cpu or cuda, not {device}")
    launch, out = node_summary_launcher(prog, state, aux, carries)
    launch()
    return out


def _no_pods(state):
    """An empty pod chunk (the pre-pass reads no pod)."""
    dev, R = state.valid.device, state.allocatable.shape[1]
    return PodBatch(
        requests=torch.zeros((0, R), dtype=torch.int32, device=dev),
        nonzero_requests=torch.zeros((0, R), dtype=torch.int32, device=dev),
        valid=torch.zeros(0, dtype=torch.bool, device=dev),
        tolerates_unschedulable=torch.zeros(0, dtype=torch.bool, device=dev),
        has_requests=torch.zeros(0, dtype=torch.bool, device=dev),
        index=torch.zeros(0, dtype=torch.int32, device=dev),
    )


def _occupancy(lib, prm: chain.ChainParams, sp: SummaryParams, device) -> tuple[int, ...]:
    """The card's occupancy answer at this launch's shared memory (asked
    once per size and device)."""
    key = (torch.device(device).index or 0, batch_smem_bytes(prm, sp))
    if key not in _OCCUPANCY:
        info = (ctypes.c_longlong * 5)()
        _check(lib, "ksim_batch_eval_occupancy",
               lib.ksim_batch_eval_occupancy(ctypes.byref(prm), ctypes.byref(sp), info))
        _OCCUPANCY[key] = tuple(info)
    return _OCCUPANCY[key]


def batch_eval(prog, state, pods, aux, carries, block: int = PLAIN_BLOCK):
    """``block``: the plain version's pods per step; the kernel's grid is
    the card's resident blocks whatever its value."""
    device = state.valid.device
    if device.type == "cpu":
        return batch_eval_plain(prog, state, pods, aux, carries, block)
    if device.type != "cuda":
        raise ValueError(f"batch_eval runs on cpu or cuda, not {device}")
    lib = _load()
    Pc, N = pods.valid.shape[0], state.valid.shape[0]
    out = chain.empty_outputs(prog, Pc, N, device)
    summary = _summary_outputs(prog, state, aux, device)
    sp = summary_params(aux, summary, N)
    prm = chain.chain_params(prog, state, pods, aux, carries, out)
    per_sm, sms, smem, regs, local = _occupancy(lib, prm, sp, device)
    grid = GRID or launch_grid(Pc, per_sm, sms)
    if not prm.sp_smem and chain.domain_ints(prm):  # the per-block domain scratch
        dom = torch.empty((grid, chain.domain_ints(prm)), dtype=torch.int32, device=device)
        prm.sp_scratch = dom.data_ptr()
        prm.keep.append(dom)
    sp.node_stride = (5 * N + 7) & ~7
    scratch = torch.empty((grid, sp.node_stride), dtype=torch.uint8, device=device)
    sp.node_scratch = scratch.data_ptr()
    stats = torch.zeros(2 + len(chain.CLUSTER_PHASES), dtype=torch.int64, device=device)
    sp.stats = stats.data_ptr()
    _launch_summary(lib, prm, sp)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    with torch.profiler.record_function("ksim_batch_eval"):  # the launch's name in a profiler trace
        _check(lib, "ksim_batch_eval", lib.ksim_batch_eval(ctypes.byref(prm), ctypes.byref(sp), stream, grid))
    batch_eval.launches += 1
    batch_eval.last = {
        "grid": grid, "blocks_per_sm": per_sm, "sms": sms, "smem_bytes": smem, "registers": regs,
        "local_bytes": local, "stats": stats,
    }
    return out


batch_eval.launches = 0
batch_eval.last = None
node_summary.launches = 0
