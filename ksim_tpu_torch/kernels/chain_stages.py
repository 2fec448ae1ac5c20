"""Kernel E wrappers: the plugin chain in stages (csrc/chain_stages.cu).

A profile the fused kernels cannot run (a ``PluginExtender`` device hook,
or a filter or score with no kernel code) runs as a sequence of stage
launches (engine/staged.py groups its rows), with the hooks and the
kernel-less plugins between them as torch code on the same tensors.  Each
stage takes a sub-profile (an engine ``_Program`` of the rows one launch
runs, with no hooks):

- ``filter_stage(sub, state, pods, aux, carries)`` (E1): the filter rows
  for the B pods of ``pods`` (a PodView): reason codes int32 [B, F', N]
  and the AND of their ok with the nodes' validity, bool [B, N];
- ``score_stage(sub, state, pods, aux, carries, ok)`` (E2): the score rows
  over the mask ``ok`` [B, N]: raw scores int64 [B, S', N];
- ``normalize_stage(sub, state, pods, aux, carries, raw, ok)`` (E3): per score
  row, the plugin's normalize of ``raw`` (int64 [B, S', N]) over ``ok``,
  before the weight (a row without one passes through): int64
  [B, S', N];
- ``window_stage(ok, start, valid, n_real, k)`` (E4, window mode): one
  pod's percentageOfNodesToScore visit window over ``ok`` [1, N] from the
  rotating ``start`` (int32 [1]): (sampled ok [1, N], visited [1, N], the
  next start [1]);
- ``select_stage(sub, state, pods, aux, carries, norm, weights, ok, out,
  commit=)`` (E4, select mode): weight times normalized, the int32 total,
  selectHost into ``out`` (``selected`` [B], ``total`` and ``final`` or
  None); with ``commit`` (one pod of a scan) the chosen node is committed
  into ``state`` and the sub-profile's ``carries`` in place.

Tensors on the CPU take the ``*_plain`` versions, which the tests hold
against ``ksim_tpu``; tensors on a CUDA device launch the kernel, and each
wrapper counts its launches on ``<wrapper>.launches``.  A launch's
ChainParams is made once per sub-profile and snapshot and patched with the
state, pod and carry pointers of each call.

Every stage spreads each pod row's node axis over a thread-block cluster
(csrc/chain_stages.cu ``stage_cluster``, mirrored by kernels/chain.py
``stage_cluster``): 16 blocks (8 where such a cluster does not fit) for
one pod of the scan, smaller clusters as the rows grow, and one block of
256 threads per row, launched without the cluster attribute, once the
rows exceed half the card's SM count.  E4's window and the committing
selection are one pod on one cluster.  The wrappers keep what ran on
``<wrapper>.last`` ({"cluster", "threads", "smem_bytes"});
``STAGE_CLUSTER`` forces a cluster size (tests; 0 leaves it to the
launch).  A refused launch raises: nothing smaller or plain runs in its
place.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ksim_tpu_torch.kernels import build, chain
from ksim_tpu_torch.kernels.schedule_sampled import sample_visited

# csrc/chain_stages.cu enum Stage.
STAGE_IDS = {"filter": 1, "score": 2, "normalize": 3, "window": 4, "select": 5}
# At most this many clusters per launch, each taking rows b, b + grid,
# ...: it bounds the scratch.
GRID_MAX = 1024
# The cluster stages' forced cluster size (0: the launch's choice).
STAGE_CLUSTER = 0
_INT32_MIN = torch.iinfo(torch.int32).min

_P = ctypes.c_void_p
_L = ctypes.c_longlong


class StageParams(ctypes.Structure):
    """The ctypes mirror of ``struct StageParams`` in csrc/chain_stages.cu."""

    _fields_ = [(name, _P) for name in (
        "ok_in", "ok_out", "out", "inp", "weights", "visited", "start", "selected", "total", "final_out",
    )] + [(name, _L) for name in ("B", "S", "final_size", "commit", "scratch_rows")]


def _load():
    lib = build.load("chain_stages")
    if not getattr(lib, "_stage_checked", False):
        lib.ksim_stage_params_size.restype = ctypes.c_longlong
        if lib.ksim_stage_params_size() != ctypes.sizeof(StageParams):
            raise RuntimeError("StageParams differs between csrc/chain_stages.cu and kernels/chain_stages.py")
        lib._stage_checked = True
    return lib


def _template(sub, state, pods, aux, carries) -> chain.ChainParams:
    """The sub-profile's ChainParams over this snapshot's aux, made once
    (kept on the sub-profile with the aux it points into)."""
    cached = sub.kernel_tables.get("stage_params")
    if cached is not None and cached[0] is aux:
        return cached[1]
    prm = chain.chain_params(sub, state, pods, aux, carries, None)
    sub.kernel_tables["stage_params"] = (aux, prm)
    return prm


def _params(sub, state, pods, aux, carries) -> chain.ChainParams:
    """The template patched with this call's state, pod and carry
    pointers (the caller holds those tensors over the launch)."""
    prm = _template(sub, state, pods, aux, carries)
    chain.put_state(prm, state)
    chain.put_pods(prm, pods)
    chain.put_carries(prm, sub, carries, state.valid.device)
    return prm


_SMS: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def _launch(stage: str, prm: chain.ChainParams, sp: StageParams, grid: int, cluster: int = 0) -> dict:
    lib = _load()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    info = (ctypes.c_longlong * 3)()
    err = lib.ksim_chain_stages(STAGE_IDS[stage], ctypes.byref(prm), ctypes.byref(sp), stream, grid, cluster, info)
    if err != 0:
        raise RuntimeError(f"ksim_chain_stages({stage}): CUDA error {err}: {lib.ksim_error_string(err).decode()}")
    return {"cluster": info[0], "threads": info[1], "smem_bytes": info[2]}


def scratch_rows(B: int, size: int, sms: int) -> int:
    """Row pairs of E1's and E2's global domain scratch for B pod rows:
    one per (cluster, rank) of min(B, GRID_MAX) clusters of the forced
    ``size``, or of the largest the launch may take on a card of ``sms``
    SMs (kernels/chain.py stage_scratch_row)."""
    return _grid(B) * (size or chain.stage_cluster_cap(B, sms))


def _cluster_launch(stage: str, prm: chain.ChainParams, sp: StageParams, B: int, device, grid: int = 0) -> dict:
    """A stage on ``grid`` clusters (0: min(B, GRID_MAX)); returns what
    ran."""
    size = STAGE_CLUSTER
    chain.check_cluster_shape(size, 0)
    # The smallest cluster the rule may fall back to holds the most node
    # slots per block.
    chain.check_stage_smem(prm, size or 1, stage)
    if "dom" in chain.STAGE_PARTS[stage] and not prm.sp_smem and prm.MC * prm.DMAX:
        rows = scratch_rows(B, size, _sm_count(device))
        keep = torch.empty((rows, 2 * chain.domain_ints(prm)), dtype=torch.int32, device=device)
        prm.sp_scratch, sp.scratch_rows = keep.data_ptr(), rows
    return _launch(stage, prm, sp, grid or _grid(B), size)


def _grid(B: int) -> int:
    return max(1, min(B, GRID_MAX))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _contiguous(view):
    """A state or pod view whose tensors are contiguous (a hook may return
    strided ones)."""
    return view._replace(**{f: t.contiguous() for f, t in zip(view._fields, view) if not t.is_contiguous()})


def _device(state) -> torch.device:
    return _tensor_device(state.valid)


def _tensor_device(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel E runs on cpu or cuda, not {t.device}")
    return t.device


# ---- E1 ---------------------------------------------------------------------


def filter_stage_plain(sub, state, pods, aux, carries):
    """The plain PyTorch version: the sub-profile's filters in order."""
    ok, bits = sub.eval_filters(state, pods, aux, carries)
    B, N = ok.shape
    codes = torch.stack([b.to(torch.int32) for b in bits], dim=1) if bits else torch.zeros(
        (B, 0, N), dtype=torch.int32, device=ok.device)
    return codes, ok.contiguous()


def filter_stage(sub, state, pods, aux, carries):
    if _device(state).type == "cpu":
        return filter_stage_plain(sub, state, pods, aux, carries)
    state, pods = _contiguous(state), _contiguous(pods)
    B, N = pods.index.shape[0], state.valid.shape[0]
    prm = _params(sub, state, pods, aux, carries)
    codes = torch.empty((B, prm.F, N), dtype=torch.int32, device=state.valid.device)
    ok = torch.empty((B, N), dtype=torch.bool, device=state.valid.device)
    prm.bits_out, prm.bits_size = codes.data_ptr(), 4
    sp = StageParams(ok_out=ok.data_ptr(), out=codes.data_ptr(), B=B)
    filter_stage.last = _cluster_launch("filter", prm, sp, B, state.valid.device)
    filter_stage.launches += 1
    return codes, ok


# ---- E2 ---------------------------------------------------------------------


def score_stage_plain(sub, state, pods, aux, carries, ok):
    """The plain PyTorch version: the sub-profile's raw scores in order."""
    B, N = ok.shape
    rows = []
    for sp in sub.scores:
        kw = {"carry": carries[sp.plugin.name]} if sp.plugin.name in carries else {}
        rows.append(sp.plugin.score(state, pods, aux, ok, exact=sub.exact, **kw).to(torch.int64))
    return torch.stack(rows, dim=1) if rows else torch.zeros((B, 0, N), dtype=torch.int64, device=ok.device)


def score_stage(sub, state, pods, aux, carries, ok):
    if _device(state).type == "cpu":
        return score_stage_plain(sub, state, pods, aux, carries, ok)
    state, pods = _contiguous(state), _contiguous(pods)
    ok = ok.contiguous()
    B, N = ok.shape
    prm = _params(sub, state, pods, aux, carries)
    raw = torch.empty((B, prm.S, N), dtype=torch.int64, device=ok.device)
    prm.raw_out, prm.raw_size = raw.data_ptr(), 8
    sp = StageParams(ok_in=ok.data_ptr(), out=raw.data_ptr(), B=B)
    score_stage.last = _cluster_launch("score", prm, sp, B, ok.device)
    score_stage.launches += 1
    return raw


# ---- E3 ---------------------------------------------------------------------


def normalize_stage_plain(sub, state, pods, aux, carries, raw, ok):
    """The plain PyTorch version: each row's normalize (in the plugin's
    raw dtype), or the row itself."""
    rows = []
    for i, sp in enumerate(sub.scores):
        r = raw[:, i].to(sp.plugin.raw_dtype(sub.exact))
        if hasattr(sp.plugin, "normalize"):
            r = sp.plugin.normalize(r, ok, pods=pods, aux=aux, exact=sub.exact)
        rows.append(r.to(torch.int64))
    return torch.stack(rows, dim=1) if rows else torch.zeros_like(raw)


def normalize_stage(sub, state, pods, aux, carries, raw, ok):
    if _device(state).type == "cpu":
        return normalize_stage_plain(sub, state, pods, aux, carries, raw, ok)
    state, pods = _contiguous(state), _contiguous(pods)
    raw, ok = raw.to(torch.int64).contiguous(), ok.contiguous()
    B, N = ok.shape
    prm = _params(sub, state, pods, aux, carries)
    if tuple(raw.shape) != (B, prm.S, N):
        raise ValueError(f"raw scores of shape {tuple(raw.shape)}, the stage takes {(B, prm.S, N)}")
    norm = torch.empty_like(raw)
    sp = StageParams(ok_in=ok.data_ptr(), out=norm.data_ptr(), inp=raw.data_ptr(), B=B)
    normalize_stage.last = _cluster_launch("normalize", prm, sp, B, ok.device)
    normalize_stage.launches += 1
    return norm


# ---- E4 ---------------------------------------------------------------------


def window_stage_plain(ok, start, valid, n_real: int, k: int):
    """The plain PyTorch version (the reference's _sample_visited): (the
    sampled ok [1, N], visited [1, N], the next start [1])."""
    visited, sample, nxt = sample_visited(ok[0], start.reshape(()), n_real, k)
    return sample[None], visited[None], torch.where(valid, nxt, start).to(torch.int32).reshape(1)


def window_stage(ok, start, valid, n_real: int, k: int):
    """``start`` is an int32 [1] tensor; on the card the kernel advances
    it in place and returns it."""
    if _tensor_device(ok).type == "cpu":
        return window_stage_plain(ok, start, valid, n_real, k)
    device = ok.device
    if k < 1:
        raise ValueError(f"sampling k={k}: the visit stops at the k-th feasible node, k >= 1")
    N = ok.shape[-1]
    if ok.numel() != N:
        raise ValueError(f"the visit window takes one pod, not {ok.numel() // max(N, 1)}")
    ok = ok.reshape(1, N).contiguous()
    prm = chain.ChainParams()
    prm.N, prm.n_real, prm.samp_k = N, n_real, k
    prm.pvalid = chain._ptr(valid, torch.bool, (1,), device)
    sample = torch.empty((1, N), dtype=torch.bool, device=device)
    visited = torch.empty((1, N), dtype=torch.bool, device=device)
    sp = StageParams(ok_in=ok.data_ptr(), ok_out=sample.data_ptr(), visited=visited.data_ptr(),
                     start=chain._ptr(start, torch.int32, (1,), device), B=1)
    # One pod on one cluster.
    window_stage.last = _cluster_launch("window", prm, sp, 1, device, 1)
    window_stage.launches += 1
    return sample, visited, start


def _select(ok, total):
    masked = torch.where(ok, total, _INT32_MIN)
    best = masked.argmax(dim=1).to(torch.int32)
    return torch.where(ok.any(dim=1), best, -1).to(torch.int32)


def select_stage_plain(sub, state, pods, aux, carries, norm, weights, ok, out: dict, *, commit: bool = False):
    """The plain PyTorch version: fills ``out`` and, with ``commit``,
    commits pod 0 of ``pods`` (a PodBatch) into ``state`` and the
    sub-profile's ``carries`` in place."""
    fin = norm * weights.to(torch.int64)[None, :, None]
    total = fin.sum(dim=1).to(torch.int32)  # int32 wrap-around, as the reference's sum
    best = torch.where(pods.valid, _select(ok, total), -1).to(torch.int32)
    out["selected"].copy_(best)
    if out.get("total") is not None:
        out["total"].copy_(total)
    if out.get("final") is not None:
        out["final"].copy_(fin.to(out["final"].dtype))
    if commit:
        b = best[0]
        new = state.commit(b, pods.requests[0], pods.nonzero_requests[0])
        for field in ("requested", "nonzero_requested", "pod_count"):
            getattr(state, field).copy_(getattr(new, field))
        committed = sub.commit_carries(carries, pods.view(), b, aux)
        for sp in sub.plugins:
            name = sp.plugin.name
            if name in carries:
                _copy_into(carries[name], committed[name])


def _copy_into(dst, src) -> None:
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


def select_stage(sub, state, pods, aux, carries, norm, weights, ok, out: dict, *, commit: bool = False):
    """``pods`` is a PodBatch (its ``valid`` gives -1); ``weights`` an
    int32 [S] tensor; ``out["selected"]`` an int32 [B] tensor,
    ``out["total"]`` and ``out["final"]`` contiguous tensors or None."""
    if _device(state).type == "cpu":
        return select_stage_plain(sub, state, pods, aux, carries, norm, weights, ok, out, commit=commit)
    B, S, N = norm.shape
    if commit and B != 1:
        raise ValueError(f"a committing selection takes one pod, not {B}")
    norm, ok = norm.to(torch.int64).contiguous(), ok.contiguous()
    prm = _params(sub, state, pods, aux, carries)
    final = out.get("final")
    for name, t, shape in (("selected", out["selected"], (B,)), ("total", out.get("total"), (B, N)),
                           ("final", final, (B, S, N)), ("weights", weights, (S,))):
        if t is not None and (tuple(t.shape) != shape or not t.is_contiguous() or t.device != ok.device):
            raise ValueError(f"{name}: a contiguous {shape} tensor on {ok.device} is needed")
    sp = StageParams(ok_in=ok.data_ptr(), inp=norm.data_ptr(), weights=weights.data_ptr(),
                     selected=out["selected"].data_ptr(), total=_ptr(out.get("total")), final_out=_ptr(final),
                     B=B, S=S, final_size=final.element_size() if final is not None else 0, commit=int(commit))
    # The committing selection: one pod on one cluster.
    select_stage.last = _cluster_launch("select", prm, sp, B, ok.device, 1 if commit else 0)
    select_stage.launches += 1


for _wrapper in (filter_stage, score_stage, normalize_stage, window_stage, select_stage):
    _wrapper.launches = 0
filter_stage.last = score_stage.last = normalize_stage.last = window_stage.last = select_stage.last = None


class Stages(NamedTuple):
    """The five stage functions a staged program calls."""

    filter: object
    score: object
    normalize: object
    window: object
    select: object


# The wrappers (kernel E on a CUDA device) and the plain versions on any
# device (tests and chip_smoke.py hold the one against the other).
STAGES = Stages(filter_stage, score_stage, normalize_stage, window_stage, select_stage)
PLAIN_STAGES = Stages(filter_stage_plain, score_stage_plain, normalize_stage_plain, window_stage_plain,
                      select_stage_plain)


def launches() -> dict:
    """Each stage's launch count (E4 counts its two modes apart)."""
    return {name: getattr(fn, "launches") for name, fn in zip(Stages._fields, STAGES)}


def reset_launches() -> None:
    for fn in STAGES:
        fn.launches = 0
