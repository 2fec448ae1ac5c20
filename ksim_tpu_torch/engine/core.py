"""The scheduling cycle on torch tensors.

The port of ``ksim_tpu/engine/core.py``, with its two entry points:

- ``schedule`` — the sequential-commit loop over the pod queue: each pod
  runs every filter and score, is placed on the max-total feasible node
  (ties to the lowest node index; -1 when none is feasible) and is
  committed into the node state, so later pods see earlier placements.
  With ``Engine(sampling_k=k)`` it emulates percentageOfNodesToScore:
  each pod visits nodes from a rotating start, stops after k feasible
  ones, and scores, normalizes and selects over that sample only.
- ``evaluate_batch`` / ``evaluate_batch_fused`` — every pod against the
  FIXED snapshot, with no commit.

On a CUDA device they run in hand-written kernels (kernels/schedule_scan,
kernels/schedule_sampled, kernels/batch_eval); on the CPU they run the
kernels' plain PyTorch versions.  ``record`` bounds what is kept per pod:
"selection" keeps the chosen node, "final" adds the weighted normalized
scores and their total, "full" adds the filter reason codes and the raw
scores (and, under sampling, the visited nodes).

``exact`` stands in for the reference's ``jax_enable_x64``: True computes
BalancedAllocation in int64 and ImageLocality in float64 (bit-exact with
Go), False takes the float32 paths.  Results match ``ksim_tpu`` run with
x64 on or off respectively, down to the recorded dtypes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ksim_tpu_torch.kernels.batch_eval import batch_eval
from ksim_tpu_torch.kernels.chain import check_chain
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan
from ksim_tpu_torch.plugins.base import NodeStateView, PodBatch, PodView
from ksim_tpu_torch.plugins.nodeaffinity import term_matches
from ksim_tpu_torch.plugins.podtopologyspread import log_weights
from ksim_tpu_torch.state.featurizer import FeaturizedSnapshot

# The aux families the plugins read.
AUX_KEYS = (
    "affinity", "taints", "nodename", "nodeports", "imagelocality", "spread", "interpod", "volumes",
)

_INT32_MIN = torch.iinfo(torch.int32).min


@dataclass(frozen=True)
class ScoredPlugin:
    """A plugin enabled in a profile, with its score weight."""

    plugin: Any
    weight: int = 1
    filter_enabled: bool = True
    score_enabled: bool = True
    # Before/After hooks (ksim_tpu's PluginExtender) are not ported: the
    # Engine refuses a plugin that carries one.
    extender: Any = None
    # Host-side hints (not part of the device computation): is the plugin
    # active at the Reserve / PreBind / Permit / PostFilter / Bind /
    # PostBind points.  The annotation renderer reads the first two; the
    # scheduler service reads them all before calling a plugin's host-side
    # hook.
    reserve_enabled: bool = True
    prebind_enabled: bool = True
    permit_enabled: bool = True
    postfilter_enabled: bool = True
    bind_enabled: bool = True
    postbind_enabled: bool = True


@dataclass
class EngineResult:
    """Host-side results for a pod batch.

    Shapes: P pods (padded), N nodes (padded); slices [:num_pods,:num_nodes]
    are valid.  ``selected`` is -1 for unschedulable (or padding) pods.
    """

    plugin_names: list[str]
    filter_plugin_names: list[str]
    reason_bits: np.ndarray | None  # [P, F, N], 0 == passed
    scores: np.ndarray | None  # [P, S, N] raw plugin scores
    final_scores: np.ndarray | None  # [P, S, N] normalized x weight
    total: np.ndarray | None  # i32 [P, N] summed final scores
    feasible: np.ndarray  # bool [P]
    selected: np.ndarray  # i32 [P]
    # percentageOfNodesToScore emulation (Engine(sampling_k=...)): the
    # per-pod visited-node mask (record="full" only) and the rotating
    # start index after this pass (feeds the next pass).
    visited: np.ndarray | None = None  # bool [P, N]
    sampling_next_start: int | None = None


def _pull_tree_to_host(tree: dict) -> dict:
    """Device tensors -> host numpy arrays with ONE device->host copy:
    the leaves are viewed as bytes and concatenated on the device, copied
    once, and re-viewed on the host.  Every returned array views that
    fresh host buffer, never memory the device (or the engine, on the
    CPU) can reuse."""
    keys = list(tree)
    leaves = [tree[k] for k in keys]
    if not leaves:
        return {}
    buf = torch.cat([x.contiguous().reshape(-1).view(torch.uint8) for x in leaves])
    host = buf.cpu().numpy()
    out = {}
    off = 0
    for k, x in zip(keys, leaves):
        dt = torch.empty((), dtype=x.dtype).numpy().dtype
        nbytes = x.numel() * x.element_size()
        out[k] = host[off : off + nbytes].view(dt).reshape(tuple(x.shape))
        off += nbytes
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # A copy: on the CPU the engine's tensors never alias the snapshot.
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def device_aux(aux: dict, n_padded: int, device: torch.device) -> dict:
    """The plugins' aux families as device tensors ({family: {field:
    tensor}}, the array fields of each featurizer dataclass), plus the
    pod-independent derived tables, once per snapshot: the term-match
    product and PodTopologySpread's log-weight tables."""
    out = {}
    for key in AUX_KEYS:
        v = aux[key]
        out[key] = {
            f.name: _to_device(getattr(v, f.name), device)
            for f in dataclasses.fields(v)
            if isinstance(getattr(v, f.name), np.ndarray)
        }
    out["affinity"]["term_ok"] = term_matches(out["affinity"])
    w64, w32 = log_weights(n_padded)
    out["spread"]["log_w64"] = _to_device(w64, device)
    out["spread"]["log_w32"] = _to_device(w32, device)
    return out


class _Program:
    """The static half of an Engine: plugin chain, record mode, numeric
    mode.  The kernel wrappers take it; its methods are the plain PyTorch
    chain that the wrappers' plain versions run."""

    def __init__(self, plugins: tuple[ScoredPlugin, ...], record: str, exact: bool) -> None:
        check_chain(plugins)
        self.plugins = plugins
        self.record = record
        self.exact = exact
        self.filters = [sp for sp in plugins if sp.filter_enabled]
        self.scores = [sp for sp in plugins if sp.score_enabled]
        self.dtypes = self._result_dtypes()

    def eval_block(self, state: NodeStateView, pods: PodView, aux: dict, carries: dict):
        """B pods against all N nodes through every plugin: (feasible
        [B, N], reason codes, raw scores, finals, total [B, N])."""
        ok, bits = self.eval_filters(state, pods, aux, carries)
        raw_scores, final_scores, total = self.eval_scores(state, pods, aux, carries, ok)
        return ok, bits, raw_scores, final_scores, total

    def eval_filters(self, state: NodeStateView, pods: PodView, aux: dict, carries: dict):
        """(feasible [B, N], reason codes per filter plugin)."""
        B, N = pods.index.shape[0], state.valid.shape[0]
        ok = state.valid[None, :].expand(B, N)
        bits = []
        for sp in self.filters:
            kw = {"carry": carries[sp.plugin.name]} if sp.plugin.name in carries else {}
            out = sp.plugin.filter(state, pods, aux, **kw)
            bits.append(out.reason_bits)
            ok = ok & out.ok
        return ok, bits

    def eval_scores(self, state: NodeStateView, pods: PodView, aux: dict, carries: dict, ok):
        """(raw scores, finals, total [B, N]) with ``ok`` as the mask the
        scores and normalizes run over: the feasible set, or under
        sampling the sampled feasible set (upstream normalizes over the
        nodes it scored)."""
        raw_scores, final_scores = [], []
        total = torch.zeros(ok.shape, dtype=torch.int32, device=ok.device)
        for sp in self.scores:
            p = sp.plugin
            kw = {"carry": carries[p.name]} if p.name in carries else {}
            raw = p.score(state, pods, aux, ok, exact=self.exact, **kw)
            if hasattr(p, "normalize"):
                norm = p.normalize(raw, ok, pods=pods, aux=aux, exact=self.exact)
            else:
                norm = raw
            final = norm * sp.weight
            raw_scores.append(raw)
            final_scores.append(final)
            total = total + final.to(torch.int32)
        return raw_scores, final_scores, total

    def select(self, ok: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
        """selectHost per pod: the max-total feasible node, the lowest
        index on a tie (argmax returns the first maximum), -1 when none
        is feasible."""
        masked = torch.where(ok, total, _INT32_MIN)
        best = masked.argmax(dim=1).to(torch.int32)
        return torch.where(ok.any(dim=1), best, -1).to(torch.int32)

    def init_carries(self, aux: dict) -> dict:
        return {
            sp.plugin.name: sp.plugin.carry_init(aux)
            for sp in self.plugins
            if hasattr(sp.plugin, "carry_init")
        }

    def commit_carries(self, carries: dict, pod: PodView, best, aux: dict) -> dict:
        out = dict(carries)
        for sp in self.plugins:
            if sp.plugin.name in carries:
                out[sp.plugin.name] = sp.plugin.carry_commit(carries[sp.plugin.name], aux, pod, best)
        return out

    def _result_dtypes(self) -> tuple[torch.dtype, torch.dtype, torch.dtype]:
        """(reason codes, finals, raw scores) dtypes — the reference's
        ``_result_dtypes`` (smallest safe widths from the plugins'
        declarations), plus the raw scores' dtype: int64 where a plugin's
        raw score is (NodeAffinity in exact mode), else int32."""
        widths = [getattr(sp.plugin, "reason_bit_width", 31) for sp in self.filters]
        maxw = max(widths, default=0)
        bits_dtype = torch.int8 if maxw <= 7 else torch.int16 if maxw <= 15 else torch.int32
        fmax = 0
        for sp in self.scores:
            bound = getattr(sp.plugin, "final_score_bound", None)
            if bound is None:
                fmax = None
                break
            fmax = max(fmax, bound * max(sp.weight, 1))
        final_dtype = torch.int16 if fmax is not None and fmax < 2**15 else torch.int32
        raw_dtype = torch.int32
        for sp in self.scores:
            raw_dtype = torch.promote_types(raw_dtype, sp.plugin.raw_dtype(self.exact))
        return bits_dtype, final_dtype, raw_dtype

    def pod_outputs(self, valid, best, bits, raw, final, total, visited=None) -> dict:
        """The recorded tensors of ``self.record`` for a block of pods."""
        B, N = total.shape
        dev = total.device
        bits_dtype, final_dtype, raw_dtype = self.dtypes
        out = {"selected": torch.where(valid, best, -1).to(torch.int32)}

        def stack(xs, dtype):
            if not xs:
                return torch.zeros((B, 0, N), dtype=dtype, device=dev)
            return torch.stack([x.to(dtype) for x in xs], dim=1)

        if self.record in ("full", "final"):
            out["total"] = total
            out["final"] = stack(final, final_dtype)
        if self.record == "full":
            out["bits"] = stack(bits, bits_dtype)
            out["raw"] = stack(raw, raw_dtype)
            if visited is not None:
                out["visited"] = visited
        return out


class Engine:
    """The plugin chain bound to one featurized snapshot on one device.

    ``device=None`` means CUDA and raises when there is no CUDA device;
    pass ``device="cpu"`` to run the plain PyTorch versions on the CPU.
    """

    # Pod-axis chunk of the recording modes (one kernel launch each): it
    # bounds the live [chunk, plugins, N] result tensors.
    SCHEDULE_CHUNK = 2048
    # Batch-evaluation chunk on the CPU, where small chunks stay
    # cache-resident.
    BATCH_CHUNK_CPU = 256

    # The scan and batch functions: kernel wrappers that take the plain
    # versions for CPU tensors.
    _scan_fn = staticmethod(schedule_scan)
    _sampled_fn = staticmethod(schedule_sampled)
    _batch_fn = staticmethod(batch_eval)

    def __init__(
        self,
        feats: FeaturizedSnapshot,
        plugins: Sequence[ScoredPlugin],
        *,
        record: str = "full",  # full | final | selection
        exact: bool = True,
        device: "str | torch.device | None" = None,
        sampling_k: int | None = None,
    ) -> None:
        """``sampling_k`` enables percentageOfNodesToScore emulation on
        the ``schedule`` path (batch evaluation has no visit order and
        refuses it)."""
        if record not in ("full", "final", "selection"):
            raise ValueError(f"unknown record mode {record!r}")
        # Validated against the REAL node count: a k between the count and
        # the padded axis would "find" padding rows that never pass.
        if sampling_k is not None and not 0 < sampling_k <= int(feats.nodes.count):
            raise ValueError(
                f"sampling_k {sampling_k} out of range: must be in "
                f"[1, {int(feats.nodes.count)}] (real node count; the "
                f"padded axis is {int(feats.nodes.valid.shape[0])})"
            )
        self.sampling_k = sampling_k
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: pass device='cpu' to run the plain PyTorch versions"
                )
            device = "cuda"
        self.device = torch.device(device)
        self._feats = feats
        self._prog = _Program(tuple(plugins), record, bool(exact))
        n, p = feats.nodes, feats.pods
        dev = self.device
        self._node_state = NodeStateView(
            allocatable=_to_device(n.allocatable, dev),
            allowed_pods=_to_device(n.allowed_pods, dev),
            valid=_to_device(n.valid, dev),
            unschedulable=_to_device(n.unschedulable, dev),
            requested=_to_device(n.requested, dev),
            nonzero_requested=_to_device(n.nonzero_requested, dev),
            pod_count=_to_device(n.pod_count, dev),
        )
        self._pods = PodBatch(
            requests=_to_device(p.requests, dev),
            nonzero_requests=_to_device(p.nonzero_requests, dev),
            valid=_to_device(p.valid, dev),
            tolerates_unschedulable=_to_device(p.tolerates_unschedulable, dev),
            has_requests=_to_device(p.has_requests, dev),
            index=_to_device(p.index, dev),
        )
        self._aux = device_aux(feats.aux, int(n.valid.shape[0]), dev)

    @property
    def _plugins(self) -> tuple[ScoredPlugin, ...]:
        return self._prog.plugins

    @property
    def _record(self) -> str:
        return self._prog.record

    def _default_batch_chunk(self) -> int:
        if self.device.type == "cpu":
            return self.BATCH_CHUNK_CPU
        return self.SCHEDULE_CHUNK

    def _default_schedule_chunk(self) -> int:
        if self._record == "selection" and self.device.type == "cuda":
            # One launch for the whole queue: selection outputs are
            # [P]-sized, so the result-buffer bound behind the chunking of
            # the recording modes does not apply.
            return 1 << 30
        return self.SCHEDULE_CHUNK

    def schedule(
        self, *, chunk: int | None = None, pull_state: bool = True, sampling_start: int = 0
    ) -> tuple[EngineResult, NodeStateView | None]:
        """Greedy sequential scheduling of the pod queue with capacity
        commit, in queue order, in ``chunk``-sized pod segments (one
        kernel launch each; the carries thread through, so chunking is
        invisible in the results).  Returns the results and, unless
        ``pull_state=False``, the committed node state as numpy arrays.

        ``sampling_start`` (sampling engines only) is the rotating node
        index carried over from the previous pass (upstream's
        sched.nextStartNodeIndex); the result's ``sampling_next_start``
        feeds the next pass."""
        P = int(self._pods.valid.shape[0])
        chunk = min(P, chunk or self._default_schedule_chunk())
        state, carries = self._node_state, self._prog.init_carries(self._aux)
        sampled = self.sampling_k is not None
        start = torch.tensor(sampling_start, dtype=torch.int32, device=self.device)
        n_real = int(self._feats.nodes.count)
        outs = []
        for s in range(0, P, chunk):
            pods = self._pods.rows(s, s + chunk)
            if sampled:
                state, carries, start, out = self._sampled_fn(
                    self._prog, state, pods, self._aux, carries, start, n_real, self.sampling_k
                )
            else:
                state, carries, out = self._scan_fn(self._prog, state, pods, self._aux, carries)
            outs.append(_pull_tree_to_host(out))
        merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        final_state = (
            NodeStateView(**_pull_tree_to_host(state._asdict())) if pull_state else None
        )
        result = self._to_result(merged)
        if sampled:
            result.sampling_next_start = int(start)
        return result, final_state

    def _refuse_sampling(self) -> None:
        if self.sampling_k is not None:
            raise ValueError(
                "percentageOfNodesToScore emulation is scan-only "
                "(batch evaluation has no sequential visit order)"
            )

    def evaluate_batch_chunks(self, *, chunk: int | None = None):
        """Yield ``(start, device_out)`` per contiguous pod chunk — the
        streaming form of ``evaluate_batch`` (one kernel launch each)."""
        self._refuse_sampling()
        P = int(self._pods.valid.shape[0])
        chunk = min(P, chunk or self._default_batch_chunk())
        carries = self._prog.init_carries(self._aux)
        for s in range(0, P, chunk):
            yield s, self._batch_fn(
                self._prog, self._node_state, self._pods.rows(s, s + chunk), self._aux, carries
            )

    def evaluate_batch(self, *, chunk: int | None = None) -> EngineResult:
        """All pods x nodes against the fixed snapshot (no state commit),
        pod-chunked so the recorded tensors never exceed one chunk's
        worth of device memory; chunks stream to host and concatenate."""
        outs = [_pull_tree_to_host(out) for _s, out in self.evaluate_batch_chunks(chunk=chunk)]
        return self._to_result({k: np.concatenate([o[k] for o in outs]) for k in outs[0]})

    def evaluate_batch_fused(self) -> EngineResult:
        """The whole pod axis in one kernel launch, for the bounded-size
        record modes; record="full" must stream through evaluate_batch."""
        if self._record == "full":
            raise ValueError("record='full' results must stream: use evaluate_batch")
        self._refuse_sampling()
        out = self._batch_fn(
            self._prog, self._node_state, self._pods, self._aux, self._prog.init_carries(self._aux)
        )
        return self._to_result(_pull_tree_to_host(out))

    def _to_result(self, out: dict) -> EngineResult:
        selected = out["selected"]
        return EngineResult(
            plugin_names=[sp.plugin.name for sp in self._prog.scores],
            filter_plugin_names=[sp.plugin.name for sp in self._prog.filters],
            reason_bits=out.get("bits"),
            scores=out.get("raw"),
            final_scores=out.get("final"),
            total=out.get("total"),
            feasible=selected >= 0,
            selected=selected,
            visited=out.get("visited"),
        )
