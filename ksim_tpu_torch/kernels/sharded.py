"""Kernels A, B and C over node shards: the wrappers of their sharded
launches (csrc/shard_exchange.cuh; csrc/cluster_scan.cuh
``cluster_scan_sharded_kernel``, csrc/batch_eval.cu
``batch_eval_sharded_kernel``).

Each takes the engine program and the engine's tensors laid out over a
device mesh (engine/sharding.py ``Sharded``: node axis over "tp", pod
axis over "dp").  Shard r of a mesh row holds the global nodes
[r N / tp, (r + 1) N / tp) and runs its own team; every node-axis
reduction of the chain crosses the row's shards through their exchange
buffers, so the results equal the unsharded kernels' byte for byte.

- ``schedule_scan`` (kernels A and C): the sequential scan runs on the
  mesh's first row (its pods whole); the committed state and carries are
  handed to every row.
- ``batch_eval`` (kernel B): mesh row i evaluates its block of the pod
  axis; each of its shards runs a persistent grid of the same G blocks.

The launch groups a row's shards by device: shards on distinct GPUs launch
once each, on each device's current stream, after peer access is enabled;
shards on one card launch together, one cluster (B: one grid slice) per
shard, and only after the card's occupancy answer shows that every shard
fits at once.  A shard that does not publish makes the launch raise a
RuntimeError naming it and the reduction, after about SPIN_SECONDS.

On CPU shards (a mesh without a card) the wrappers take the plain
versions over the gathered shards and lay the results out again: no
reduction is combined per shard there.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import torch

from ksim_tpu_torch.engine.sharding import DP, TP, Mesh, Sharded, gather_tree, put
from ksim_tpu_torch.kernels import batch_eval as batch_mod
from ksim_tpu_torch.kernels import build, chain
from ksim_tpu_torch.kernels.batch_eval import batch_eval_plain
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled_plain
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan_plain
from ksim_tpu_torch.plugins.base import NodeStateView, PodBatch

MAX_SHARDS = 16
XS_RING = 4
# A spin's bound: past it the shard gives up, the launch ends and raises.
SPIN_SECONDS = 1.0
# A shard that never publishes (the no-hang check; -1: none).
SILENT_SHARD = -1
# csrc/cluster_scan.cuh NOT_RESIDENT: the co-resident launch would not fit.
NOT_RESIDENT = 100001
# What each exchange carries (shard_exchange.cuh XsKind).
KINDS = {
    1: "integer reduction (sums, minima, maxima)",
    2: "selection (selectHost's maximum and the chosen node's domains)",
    3: "PodTopologySpread per-domain counts",
    4: "visit walk's feasible counts",
}
# The node-axis outputs whose columns each shard writes.
_NODE_OUTPUTS = ("total", "final", "bits", "raw", "visited")

_P = ctypes.c_void_p
_L = ctypes.c_longlong


class ShardExchange(ctypes.Structure):
    """Mirror of ``struct ShardExchange`` (csrc/shard_exchange.cuh)."""

    _fields_ = [("buf", _P * MAX_SHARDS), ("err", _P)] + [
        (name, _L) for name in ("shard", "nshards", "gen", "spin_cycles", "silent", "slot_words", "blocks")
    ]


class Exchange:
    """The exchange buffers of one group of shards (a mesh row): shard q's
    on its device, ``blocks`` team slots of XS_RING rings of one slot per
    shard, each a flag word and ``slot_words`` payload words; and each
    shard's error words.  ``gen`` numbers the launches."""

    def __init__(self, devices: list, blocks: int, slot_words: int) -> None:
        n = len(devices)
        words = blocks * XS_RING * n * (1 + slot_words)
        self.devices = devices
        self.blocks, self.slot_words = blocks, slot_words
        self.bufs = [torch.zeros(words, dtype=torch.int64, device=d) for d in devices]
        self.errs = [torch.zeros(4, dtype=torch.int64, device=d) for d in devices]
        self.gen = 0

    def structs(self, spin_cycles: int) -> list[ShardExchange]:
        """Each shard's ShardExchange for the next launch (a new gen)."""
        self.gen += 1
        out = []
        for q in range(len(self.devices)):
            x = ShardExchange()
            for r, b in enumerate(self.bufs):
                x.buf[r] = b.data_ptr()
            x.err = self.errs[q].data_ptr()
            x.shard, x.nshards, x.gen = q, len(self.devices), self.gen
            x.spin_cycles, x.silent = spin_cycles, SILENT_SHARD
            x.slot_words, x.blocks = self.slot_words, self.blocks
            out.append(x)
        for e in self.errs:
            e.zero_()
        return out

    def failure(self) -> "tuple[int, int, int, int] | None":
        """The first shard's error words (kind, awaited shard, exchange,
        shard), or None after a clean launch."""
        for e in self.errs:
            w = [int(v) for v in e.cpu()]
            if w[0]:
                return tuple(w)
        return None


_EXCHANGES: "OrderedDict[tuple, Exchange]" = OrderedDict()


def exchange_for(devices: list, blocks: int, slot_words: int, group: int = 0) -> Exchange:
    """The exchange of mesh row ``group`` over ``devices`` (kept across
    launches: each launch takes a new gen).  Two rows never share one,
    though they may list the same devices."""
    key = (group, tuple(str(d) for d in devices), blocks, slot_words)
    x = _EXCHANGES.get(key)
    if x is None:
        x = _EXCHANGES[key] = Exchange(devices, blocks, slot_words)
        while len(_EXCHANGES) > 8:
            _EXCHANGES.popitem(last=False)
    return x


def slot_words(prm: chain.ChainParams) -> int:
    """Payload words (64-bit) of one slot: the largest exchange of the
    program, in 32-bit words: a reduction's RED_MAX values, the selection's
    key and T2 domains, two PodTopologySpread per-domain parts."""
    u32 = max(chain.RED_MAX, 2 + prm.T2, 2 * prm.MC * prm.DMAX, 2)
    return -(-u32 // 2)


def _load(name: str):
    lib = build.load(name)
    if not getattr(lib, "_ksim_sharded_checked", False):
        lib.ksim_shard_exchange_size.restype = ctypes.c_longlong
        if lib.ksim_shard_exchange_size() != ctypes.sizeof(ShardExchange):
            raise RuntimeError("ShardExchange differs between csrc/shard_exchange.cuh and kernels/sharded.py")
        lib.ksim_enable_peer_access.argtypes = [ctypes.c_int]
        lib.ksim_enable_peer_access.restype = ctypes.c_int
        lib.ksim_clock_khz.restype = ctypes.c_int
        if name == "batch_eval":
            lib.ksim_batch_eval_sharded.argtypes = [_P, _P, _P, _P, ctypes.c_int, _P, _L]
        else:
            getattr(lib, f"ksim_{name}_sharded").argtypes = [
                _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.POINTER(_L)]
        getattr(lib, f"ksim_{name}_sharded").restype = ctypes.c_int
        lib._ksim_sharded_checked = True
    return lib


def _check(lib, entry: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: {lib.ksim_error_string(err).decode()}")


def _spin_cycles(lib, device) -> int:
    with torch.cuda.device(device):
        return int(lib.ksim_clock_khz() * 1000 * SPIN_SECONDS)


def _by_device(devices: list) -> "OrderedDict[torch.device, list[int]]":
    groups: "OrderedDict[torch.device, list[int]]" = OrderedDict()
    for q, d in enumerate(devices):
        groups.setdefault(d, []).append(q)
    return groups


def _enable_peers(lib, devices) -> None:
    """Peer access between every pair of distinct GPUs of a group."""
    distinct = list(dict.fromkeys(devices))
    for d in distinct:
        for e in distinct:
            if d != e:
                with torch.cuda.device(d):
                    _check(lib, "ksim_enable_peer_access", lib.ksim_enable_peer_access(e.index))


def _blob(device, records: list) -> tuple[torch.Tensor, list[int]]:
    """The ctypes records laid end to end in one device array; returns it
    and each record's device address."""
    sizes = [ctypes.sizeof(r) for r in records]
    host = bytearray(sum(sizes))
    addrs, off = [], 0
    for r, n in zip(records, sizes):
        host[off : off + n] = ctypes.string_at(ctypes.addressof(r), n)
        addrs.append(off)
        off += n
    dev = torch.empty(len(host), dtype=torch.uint8, device=device)
    base = dev.data_ptr()
    return dev, [base + a for a in addrs]


def _upload(dev: torch.Tensor, records: list) -> None:
    host = b"".join(ctypes.string_at(ctypes.addressof(r), ctypes.sizeof(r)) for r in records)
    dev.copy_(torch.frombuffer(bytearray(host), dtype=torch.uint8))


class _Clock:
    """CUDA events on one device's current stream around the launches,
    their parameter upload included (kernel B's node summaries ran
    before); ``ms()`` is read after the synchronize."""

    def __init__(self, device) -> None:
        self.device = device
        with torch.cuda.device(device):
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()

    def stop(self) -> None:
        with torch.cuda.device(self.device):
            self.events[1].record()

    def ms(self) -> float:
        return self.events[0].elapsed_time(self.events[1])


def _raise_failure(entry: str, x: Exchange) -> None:
    f = x.failure()
    if f is not None:
        kind, awaited, seq, shard = f
        raise RuntimeError(
            f"{entry}: node shard {awaited} never published its {KINDS.get(kind, kind)} partial "
            f"(exchange {seq}; shard {shard} gave up after about {SPIN_SECONDS} s): the launch was cut")


def _shard_tree(tree, i: int, j: int, device, whole_pods: bool):
    """Mesh position (i, j)'s view of a tree of Sharded leaves (dicts of
    tensors, as the kernels read the aux): each leaf's shard, or (with
    ``whole_pods``) a pod-axis leaf gathered whole onto ``device``."""
    if isinstance(tree, dict):
        return {k: _shard_tree(v, i, j, device, whole_pods) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        if whole_pods and DP in tree.layout.spec and tree.mesh.dp > 1:
            return tree.full(device)
        return tree.shard(i, j)
    return tree


def _relayout(t: torch.Tensor | dict, like):
    """New values laid out as ``like`` (a Sharded or a dict of them)."""
    if isinstance(like, dict):
        return {k: _relayout(t[k], v) for k, v in like.items()}
    return put(t, like.layout)


def _row_layout(shards: list, like: Sharded) -> Sharded:
    """A tensor whose mesh-row-0 shards are ``shards`` (one per tp
    position), laid out as ``like``: the other rows get copies on their
    devices (the layout is replicated over dp)."""
    mesh = like.mesh
    out = []
    for i in range(mesh.dp):
        for j in range(mesh.tp):
            t = shards[j] if TP in like.layout.spec else shards[0]
            dev = mesh.device(i, j)
            out.append(t if t.device == dev and i == 0 else t.to(dev, copy=True))
    return Sharded(like.layout, out, like.shape)


def _merge_columns(outs: dict, bases: list[int], nl: int, device) -> dict:
    """One output tree from the per-device trees ``outs`` ({device: out}):
    each shard's node columns [base, base + nl) from its device's tree."""
    devs = list(outs)
    first = outs[devs[0]]
    if len(devs) == 1:
        return first
    merged = {k: v for k, v in first.items()}
    for k in _NODE_OUTPUTS:
        if k not in merged:
            continue
        merged[k] = merged[k].clone()
        for dev, base in bases:
            if dev != devs[0]:
                merged[k][..., base : base + nl] = outs[dev][k][..., base : base + nl].to(device)
    return merged


# ---- kernels A and C --------------------------------------------------------------


def schedule_scan(prog, mesh: Mesh, state: NodeStateView, pods: PodBatch, aux: dict, carries: dict,
                  sampling: "tuple | None" = None):
    """The sequential-commit scan over the node shards of ``mesh``'s first
    row: kernel A, or with ``sampling`` = (start 0-d int32, n_real, k)
    kernel C.  ``state``, ``aux`` and ``carries`` are laid out over the
    mesh, ``pods`` is whole.  Returns ``(state, carries, out)`` (and the
    next start before ``out`` under sampling), the state and carries laid
    out as given and ``out`` whole on the mesh's first device."""
    device = mesh.device(0, 0)
    if device.type == "cpu":
        return _plain_scan(prog, mesh, state, pods, aux, carries, sampling)
    if device.type != "cuda":
        raise ValueError(f"the sharded scan runs on cpu or cuda, not {device}")
    name = "schedule_sampled" if sampling is not None else "schedule_scan"
    lib = _load(name)
    tp = mesh.tp
    N = state.valid.shape[0]
    NL = N // tp
    P_all = aux["nodename"]["pod_req_node"].shape[0]
    devices = [mesh.device(0, j) for j in range(tp)]
    groups = _by_device(devices)
    pods_on = {d: PodBatch(*(x.to(d) for x in pods)) for d in groups}
    outs = {d: chain.empty_outputs(prog, pods.valid.shape[0], N, d, sampled=sampling is not None) for d in groups}
    prms, states, carry_shards, starts = [], [], [], []
    for j, d in enumerate(devices):
        st = NodeStateView(*(x.shard(0, j) for x in state))
        ca = _shard_tree(carries, 0, j, d, True)
        st, ca = chain.fresh_scan_state(prog, st, ca)
        ax = _shard_tree(aux, 0, j, d, True)
        smp = None
        if sampling is not None:
            start, n_real, k = sampling
            starts.append(start.reshape(1).to(d, copy=True))
            smp = (starts[-1], n_real, k)
        prm = chain.chain_params(prog, st, pods_on[d], ax, ca, outs[d], cluster=True, sampling=smp,
                                 shard=(j * NL, N, 0, P_all))
        prm.keep.append(ax)  # the pod-axis tables gathered for this shard live until the launch ends
        prms.append(prm)
        states.append(st)
        carry_shards.append(ca)
    chain.check_cluster_shape(chain.CLUSTER_SIZE, chain.CLUSTER_THREADS)
    chain.check_smem(prms[0], cluster=chain.CLUSTER_SIZE or chain.MAX_CLUSTER, threads=chain.CLUSTER_THREADS)
    x = exchange_for(devices, 1, slot_words(prms[0]))
    structs = x.structs(_spin_cycles(lib, devices[0]))
    if len(groups) > 1:
        _enable_peers(lib, devices)
    stats = torch.zeros(2 + len(chain.CLUSTER_PHASES), dtype=torch.int64, device=devices[0])
    info = (_L * 4)()
    keep = []
    entry = f"ksim_{name}_sharded"
    clock = _Clock(devices[0])
    for d, idxs in groups.items():
        with torch.cuda.device(d):
            nsh = len(idxs)
            blob, addrs = _blob(d, [prms[q] for q in idxs] + [structs[q] for q in idxs])
            for k, q in enumerate(idxs):
                prms[q].xs = addrs[nsh + k]
            _upload(blob, [prms[q] for q in idxs] + [structs[q] for q in idxs])
            keep.append(blob)
            stream = torch.cuda.current_stream(d).cuda_stream
            with torch.profiler.record_function(entry):
                err = getattr(lib, entry)(ctypes.byref(prms[idxs[0]]), _P(addrs[0]), nsh, _P(stream),
                                          chain.CLUSTER_SIZE, chain.CLUSTER_THREADS,
                                          _P(stats.data_ptr() if d == devices[0] else 0), info)
            if err == NOT_RESIDENT:
                raise RuntimeError(
                    f"{entry}: the card holds {info[3]} cluster(s) of {info[0]} blocks at once, "
                    f"fewer than its {nsh} co-resident node shards: a launch would never finish")
            _check(lib, entry, err)
            counter = LAUNCHES[name]
            LAUNCHES[name] = counter + 1
    clock.stop()
    for d in groups:
        torch.cuda.synchronize(d)
    _raise_failure(entry, x)
    LAST[name] = {"tp": tp, "dp": mesh.dp, "cluster": info[0], "threads": info[1], "smem_bytes": info[2],
                  "clusters_resident": info[3], "devices": [str(d) for d in devices], "stats": stats,
                  "kernel_ms": clock.ms()}
    out = _merge_columns(outs, [(d, j * NL) for j, d in enumerate(devices)], NL, devices[0])
    new_state = state._replace(**{
        f: _row_layout([getattr(s, f) for s in states], getattr(state, f))
        for f in ("requested", "nonzero_requested", "pod_count")
    })
    new_carries = _carries_from_row(carries, carry_shards)
    if sampling is not None:
        return new_state, new_carries, starts[0].reshape(()).to(device), out
    return new_state, new_carries, out


def _carries_from_row(carries: dict, rows: list) -> dict:
    """The carries laid out as ``carries`` from each tp shard's committed
    copies (row 0 of the mesh)."""
    out = {}
    for k, v in carries.items():
        if isinstance(v, dict):
            out[k] = {f: _row_layout([r[k][f] for r in rows], v[f]) for f in v}
        else:
            out[k] = _row_layout([r[k] for r in rows], v)
    return out


def _plain_scan(prog, mesh, state, pods, aux, carries, sampling):
    device = mesh.device(0, 0)
    st, ax, ca = gather_tree(state, device), gather_tree(aux, device), gather_tree(carries, device)
    pods = PodBatch(*(x.to(device) for x in pods))
    if sampling is None:
        st2, ca2, out = schedule_scan_plain(prog, st, pods, ax, ca)
    else:
        start, n_real, k = sampling
        st2, ca2, start2, out = schedule_sampled_plain(prog, st, pods, ax, ca, start.to(device), n_real, k)
    new_state = state._replace(**{
        f: _relayout(getattr(st2, f), getattr(state, f)) for f in ("requested", "nonzero_requested", "pod_count")
    })
    new_carries = {k: _relayout(ca2[k], v) for k, v in carries.items()}
    if sampling is None:
        return new_state, new_carries, out
    return new_state, new_carries, start2, out


# ---- kernel B -------------------------------------------------------------------------


def batch_eval(prog, mesh: Mesh, state: NodeStateView, pods: PodBatch, aux: dict, carries: dict,
               block: int = batch_mod.PLAIN_BLOCK) -> dict:
    """Batch evaluation over the mesh: mesh row i evaluates its block of
    the pod axis (``pods`` laid out over "dp"), each of its tp shards its
    nodes.  Returns the outputs whole on the mesh's first device, in pod
    order."""
    device = mesh.device(0, 0)
    if device.type == "cpu":
        st, ax, ca = gather_tree(state, device), gather_tree(aux, device), gather_tree(carries, device)
        outs = [batch_eval_plain(prog, st, PodBatch(*(x.shard(i, 0) for x in pods)), ax, ca, block)
                for i in range(mesh.dp)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    if device.type != "cuda":
        raise ValueError(f"the sharded batch evaluation runs on cpu or cuda, not {device}")
    lib = _load("batch_eval")
    blib = batch_mod._load()
    dp, tp = mesh.dp, mesh.tp
    N = state.valid.shape[0]
    NL = N // tp
    P = pods.valid.shape[0]
    Pr = P // dp
    P_all = aux["nodename"]["pod_req_node"].shape[0]
    whole_pods = P != P_all
    rows = []  # per mesh row: its shards' (device, prm, sp)
    for i in range(dp):
        devices = [mesh.device(i, j) for j in range(tp)]
        outs = {d: chain.empty_outputs(prog, Pr, N, d) for d in _by_device(devices)}
        shards = []
        for j, d in enumerate(devices):
            st = NodeStateView(*(x.shard(i, j) for x in state))
            ca = _shard_tree(carries, i, j, d, False)
            # The pod-axis aux rows of row i's pods: its own block when the
            # batch is the whole pod axis, else (a chunk) the whole table.
            ax = _shard_tree(aux, i, j, d, whole_pods)
            pods_ij = PodBatch(*(x.shard(i, j) for x in pods))
            prm = chain.chain_params(prog, st, pods_ij, ax, ca, outs[d],
                                     shard=(j * NL, N, 0 if whole_pods else i * Pr, P_all))
            prm.keep.append(ax)  # the pod-axis tables gathered for this shard live until the launch ends
            summary = batch_mod._summary_outputs(prog, st, ax, d)
            sp = batch_mod.summary_params(ax, summary, NL)
            # The summary's node arrays by global node (less node_base).
            base = j * NL
            sp.words -= base * 8
            if sp.room:
                sp.room -= base * 4
            sp.aff_added -= base * 4
            sp.nflags -= base
            prm.keep.append(summary)
            shards.append((d, prm, sp))
        rows.append((devices, outs, shards))
    # The grid: the same G blocks on every shard, every shard resident.
    flat = [s for _, _, shards in rows for s in shards]
    count = {}
    for d, _, _ in flat:
        count[d] = count.get(d, 0) + 1
    prm0, sp0 = flat[0][1], flat[0][2]
    prm0.xs = 1  # the node-shard kernel's occupancy (any non-null pointer asks for it)
    info = (_L * 5)()
    with torch.cuda.device(flat[0][0]):
        _check(lib, "ksim_batch_eval_occupancy",
               blib.ksim_batch_eval_occupancy(ctypes.byref(prm0), ctypes.byref(sp0), info))
    prm0.xs = None
    per_sm, sms, smem, regs, local = tuple(info)
    resident = {d: per_sm * sms for d in count}
    G = batch_mod.GRID or max(1, min(Pr, min(resident[d] // count[d] for d in count)))
    for d, n in count.items():
        if G * n > resident[d] or G < 1:
            raise RuntimeError(
                f"ksim_batch_eval_sharded: {n} co-resident node shards of {G} blocks need {G * n} blocks "
                f"at once, the card holds {resident[d]}: a launch would never finish")
    words = slot_words(prm0)
    exchanges = [exchange_for(devices, G, words, group=i) for i, (devices, _, _) in enumerate(rows)]
    spin = _spin_cycles(lib, device)
    if any(len(_by_device(devices)) > 1 for devices, _, _ in rows):
        _enable_peers(lib, [d for d, _, _ in flat])
    stats = torch.zeros(2 + len(chain.CLUSTER_PHASES), dtype=torch.int64, device=device)
    structs = []
    for (devices, _, shards), x in zip(rows, exchanges):
        ss = x.structs(spin)
        for (d, prm, sp), s in zip(shards, ss):
            if not prm.sp_smem and chain.domain_ints(prm):
                dom = torch.empty((G, chain.domain_ints(prm)), dtype=torch.int32, device=d)
                prm.sp_scratch = dom.data_ptr()
                prm.keep.append(dom)
            sp.node_stride = (5 * NL + 7) & ~7
            scratch = torch.empty((G, sp.node_stride), dtype=torch.uint8, device=d)
            sp.node_scratch = scratch.data_ptr()
            prm.keep.append(scratch)
            sp.stats = stats.data_ptr() if (d, prm) == (flat[0][0], flat[0][1]) else None
            structs.append(s)
            with torch.cuda.device(d):
                batch_mod._launch_summary(blib, prm, sp)
    keep = []
    clock = _Clock(device)
    for d in count:
        idxs = [q for q, (dd, _, _) in enumerate(flat) if dd == d]
        with torch.cuda.device(d):
            prms = [flat[q][1] for q in idxs]
            sps = [flat[q][2] for q in idxs]
            xs = [structs[q] for q in idxs]
            blob, addrs = _blob(d, prms + sps + xs)
            for k, prm in enumerate(prms):
                prm.xs = addrs[2 * len(idxs) + k]
            _upload(blob, prms + sps + xs)
            keep.append(blob)
            stream = torch.cuda.current_stream(d).cuda_stream
            with torch.profiler.record_function("ksim_batch_eval_sharded"):
                err = lib.ksim_batch_eval_sharded(ctypes.byref(prms[0]), ctypes.byref(sps[0]), _P(addrs[0]),
                                                  _P(addrs[len(idxs)]), len(idxs), _P(stream), G)
            _check(lib, "ksim_batch_eval_sharded", err)
            LAUNCHES["batch_eval"] += 1
    clock.stop()
    for d in count:
        torch.cuda.synchronize(d)
    for x in exchanges:
        _raise_failure("ksim_batch_eval_sharded", x)
    LAST["batch_eval"] = {"tp": tp, "dp": dp, "grid": G, "blocks_per_sm": per_sm, "sms": sms, "smem_bytes": smem,
                          "registers": regs, "local_bytes": local, "devices": [str(d) for d, _, _ in flat],
                          "stats": stats, "kernel_ms": clock.ms()}
    merged = [_merge_columns(outs, [(d, j * NL) for j, d in enumerate(devices)], NL, device)
              for devices, outs, _ in rows]
    return {k: torch.cat([m[k].to(device) for m in merged]) for k in merged[0]}


# Launches of the sharded entries (one per device a launch runs on), and
# what the last of each ran.
LAUNCHES = {"schedule_scan": 0, "schedule_sampled": 0, "batch_eval": 0}
LAST: dict = {}
