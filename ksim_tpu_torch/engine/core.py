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

On a CUDA device they run in hand-written kernels; on the CPU they run the
kernels' plain PyTorch versions.  The Engine's ``route``, decided from
the profile alone and the same on every device, says which:

- "fused": kernels A (kernels/schedule_scan), C (kernels/schedule_sampled)
  and B (kernels/batch_eval) run the whole chain in one launch;
- "staged": a profile the fused kernels cannot run (``kernel_refusal``: a
  ``PluginExtender`` device hook, a Python callable on tensors, or a
  filter or score with no kernel code) runs as kernel E's stages
  (kernels/chain_stages) with the hooks and the kernel-less plugins' torch
  code between the launches (engine/staged.py).

``record`` bounds what is kept per pod: "selection" keeps the chosen
node, "final" adds the weighted normalized scores and their total,
"full" adds the filter reason codes and the raw scores (and, under
sampling, the visited nodes).

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

from ksim_tpu_torch.engine.staged import StagedProgram
from ksim_tpu_torch.kernels.batch_eval import batch_eval
from ksim_tpu_torch.kernels.chain import check_chain, has_kernel_code
from ksim_tpu_torch.kernels.chain_stages import STAGES
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan
from ksim_tpu_torch.plugins.base import NodeStateView, PodBatch, PodView
from ksim_tpu_torch.plugins.nodeaffinity import term_matches
from ksim_tpu_torch.plugins.podtopologyspread import log_weights
from ksim_tpu_torch.state.featurizer import FeaturizedSnapshot

# The aux families the in-tree plugins read; a snapshot may hold more
# (the featurizer's extra encoders: the samples' "nodenumber" and
# "provider:<name>"), which follow in key order (``aux_families``).
AUX_KEYS = (
    "affinity", "taints", "nodename", "nodeports", "imagelocality", "spread", "interpod", "volumes",
)

_INT32_MIN = torch.iinfo(torch.int32).min


def aux_families(aux: dict) -> list[str]:
    """The snapshot's aux families in canonical order: AUX_KEYS, then
    every extra encoder's family by key."""
    return list(AUX_KEYS) + sorted(k for k in aux if k not in AUX_KEYS)


@dataclass(frozen=True)
class PluginExtender:
    """Before/After hooks around one plugin's extension points — the
    reference's PluginExtender surface (simulator/scheduler/plugin/
    wrappedplugin.go:47-171), ``ksim_tpu``'s dataclass with the same
    fields.

    Device-side hooks, Python callables over the port's batched tensors
    (a block of B pods: every pod tensor leads with B, every result is
    [B, N]).  An Engine whose profile holds one takes the "staged" route:
    the hooks run between kernel E's stage launches (engine/staged.py).

    - before_filter(state, pods, aux) -> (state, pods): rewrite inputs;
    - after_filter(state, pods, aux, out: FilterOutput) -> FilterOutput;
    - before_score(state, pods, aux) -> (state, pods);
    - after_score(state, pods, aux, scores) -> scores (pre-normalize);
    - before_normalize(state, pods, aux, raw, ok) -> raw;
      after_normalize(state, pods, aux, normalized, ok) -> normalized
      (the NormalizeScore extender pair, wrappedplugin.go:388-418;
      weight applies after).

    Host-side hooks (plain Python over pod JSON, run by the scheduler
    service around the corresponding host extension points, the
    reference's Permit/PreBind/Bind/PostBind/PostFilter extender
    interfaces).  ``before_*`` returning a non-None string is a
    non-success status: the original plugin hook is skipped and the
    message becomes the point's result (for post_bind the original is
    skipped silently, matching wrappedplugin.go:728-738).  ``after_*``
    receives the point's outcome and may replace it:

    - before_post_filter(pod) -> str | None;
      after_post_filter(pod, nominated, msg) -> (nominated, msg);
    - before_reserve(pod, node) -> str | None;
      after_reserve(pod, node, msg) -> str | None;
    - before_unreserve(pod, node) -> str | None (non-None skips the
      original unreserve, like BeforePostBind);
      after_unreserve(pod, node) -> None;
    - before_permit(pod, node) -> str | None;
      after_permit(pod, node, result) -> result (a PermitResult);
    - before_pre_bind(pod, node) -> str | None;
      after_pre_bind(pod, node, msg) -> str | None;
    - before_bind(pod, node) -> str | None;
      after_bind(pod, node, outcome) -> outcome;
    - before_post_bind(pod, node) -> str | None;
      after_post_bind(pod, node) -> None.

    Implement ``static_sig()`` for programs of equal hooks to share a
    compile-once rung; without it the program keys by extender identity.
    """

    before_filter: Any = None
    after_filter: Any = None
    before_score: Any = None
    after_score: Any = None
    before_normalize: Any = None
    after_normalize: Any = None
    before_post_filter: Any = None
    after_post_filter: Any = None
    before_reserve: Any = None
    after_reserve: Any = None
    before_unreserve: Any = None
    after_unreserve: Any = None
    before_permit: Any = None
    after_permit: Any = None
    before_pre_bind: Any = None
    after_pre_bind: Any = None
    before_bind: Any = None
    after_bind: Any = None
    before_post_bind: Any = None
    after_post_bind: Any = None

    def static_sig(self) -> tuple | None:
        return None


# The PluginExtender fields the engine's chain applies (the rest are the
# service's host hooks).
DEVICE_HOOKS = (
    "before_filter", "after_filter", "before_score", "after_score", "before_normalize", "after_normalize",
)


def has_device_hook(sp) -> bool:
    ext = getattr(sp, "extender", None)
    return ext is not None and any(getattr(ext, h, None) is not None for h in DEVICE_HOOKS)


@dataclass(frozen=True)
class ScoredPlugin:
    """A plugin enabled in a profile, with its score weight."""

    plugin: Any
    weight: int = 1
    filter_enabled: bool = True
    score_enabled: bool = True
    # Before/After hooks (a PluginExtender): its device fields run between
    # kernel E's stages (the "staged" route), its host fields in the
    # scheduler service.
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
    for key in aux_families(aux):
        out[key] = {name: _to_device(a, device) for name, a in aux_arrays(aux[key])}
    out["affinity"]["term_ok"] = term_matches(out["affinity"])
    w64, w32 = log_weights(n_padded)
    out["spread"]["log_w64"] = _to_device(w64, device)
    out["spread"]["log_w32"] = _to_device(w32, device)
    return out


def aux_arrays(family: Any) -> list[tuple[str, np.ndarray]]:
    """One aux family's array fields, in field order: a featurizer
    dataclass's, or a mapping's."""
    if dataclasses.is_dataclass(family):
        items = [(f.name, getattr(family, f.name)) for f in dataclasses.fields(family)]
    else:
        items = list(family.items())
    return [(name, a) for name, a in items if isinstance(a, np.ndarray)]


def _plugin_sig(plugin: Any) -> tuple:
    """One plugin's part of ``_Program.sig``: its declared ``static_sig``,
    or its identity for a plugin that declares none (no sharing across
    instances, but always safe)."""
    sig = getattr(plugin, "static_sig", None)
    sig = sig() if sig is not None else None
    return ("@id", id(plugin)) if sig is None else tuple(sig)


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
        # The profile's identity for the compile-once gate
        # (engine/replay.py ``_compile_cache_key``): equal configurations
        # share a rung, as the reference's ``_Program`` hashes.
        self.sig = (
            record,
            bool(exact),
            tuple(
                (
                    _plugin_sig(sp.plugin),
                    sp.weight,
                    sp.filter_enabled,
                    sp.score_enabled,
                    _plugin_sig(sp.extender) if sp.extender is not None else None,
                )
                for sp in plugins
            ),
        )
        # The kernels' copies of the profile's tables, per device
        # (kernels/chain.py profile_tables).
        self.kernel_tables: dict = {}

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
            ext = sp.extender
            f_state, f_pods = state, pods
            if ext is not None and ext.before_filter is not None:
                f_state, f_pods = ext.before_filter(f_state, f_pods, aux)
            out = sp.plugin.filter(f_state, f_pods, aux, **kw)
            if ext is not None and ext.after_filter is not None:
                out = ext.after_filter(f_state, f_pods, aux, out)
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
            ext = sp.extender
            s_state, s_pods = state, pods
            if ext is not None and ext.before_score is not None:
                s_state, s_pods = ext.before_score(s_state, s_pods, aux)
            raw = p.score(s_state, s_pods, aux, ok, exact=self.exact, **kw)
            if ext is not None and ext.after_score is not None:
                raw = ext.after_score(s_state, s_pods, aux, raw)
            # The reference's _final_from_raw: the normalize pair's hooks
            # around the plugin's normalize, then the weight.
            norm = raw
            if ext is not None and ext.before_normalize is not None:
                norm = ext.before_normalize(s_state, s_pods, aux, norm, ok)
            if hasattr(p, "normalize"):
                norm = p.normalize(norm, ok, pods=s_pods, aux=aux, exact=self.exact)
            if ext is not None and ext.after_normalize is not None:
                norm = ext.after_normalize(s_state, s_pods, aux, norm, ok)
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


def kernel_refusal(plugins: Sequence[ScoredPlugin]) -> str | None:
    """Why the fused kernels cannot run this profile (a plugin carrying a
    PluginExtender device hook, or enabling a filter or score the kernels
    have no code for), or None.  Such a profile takes the "staged" route
    (``engine_route``)."""
    for sp in plugins:
        if has_device_hook(sp):
            return f"{sp.plugin.name} carries a PluginExtender device hook"
        if (sp.filter_enabled or sp.score_enabled) and not has_kernel_code(sp.plugin):
            return f"plugin {sp.plugin.name} has no kernel code in ksim_tpu_torch"
    return None


def engine_route(plugins: Sequence[ScoredPlugin]) -> str:
    """The profile's route on every device: "fused" (kernels A-C) or
    "staged" (kernel E's stages with the hooks between them)."""
    return "fused" if kernel_refusal(plugins) is None else "staged"


class Engine:
    """The plugin chain bound to one featurized snapshot on one device.

    ``device=None`` means CUDA and raises when there is no CUDA device;
    pass ``device="cpu"`` to run the plain PyTorch versions on the CPU.
    ``route`` is "fused" or "staged" (``engine_route``).
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
    # Kernel E's stage functions (the staged route).
    _stages = STAGES

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
        self.route = engine_route(plugins)
        self._staged = StagedProgram(self._prog, self._stages) if self.route == "staged" else None
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
            if self._staged is not None:
                sampling = (start, n_real, self.sampling_k) if sampled else None
                state, carries, *rest = self._staged.scan(state, pods, self._aux, carries, sampling)
                start, out = rest if sampled else (start, rest[0])
            elif sampled:
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

    def evaluate_batch_chunks(self, *, chunk: int | None = None, partition: bool = False):
        """Yield one device result per contiguous pod chunk (one kernel
        launch each): the streaming form of ``evaluate_batch``.  The key
        is the chunk's start, or with ``partition=True`` the int64 array
        of its original pod positions, the reference's contract for its
        classed chunks.  The reference classes pods because a skipped
        plugin under vmap still costs its select; the kernel's chain
        skips per pod what a pod cannot fail, so here the classes would
        run the one program in another row order, and the chunks stay
        contiguous."""
        self._refuse_sampling()
        P = int(self._pods.valid.shape[0])
        chunk = min(P, chunk or self._default_batch_chunk())
        carries = self._prog.init_carries(self._aux)
        for s in range(0, P, chunk):
            pods = self._pods.rows(s, s + chunk)
            if self._staged is not None:
                out = self._staged.batch(self._node_state, pods, self._aux, carries)
            else:
                out = self._batch_fn(self._prog, self._node_state, pods, self._aux, carries)
            yield (np.arange(s, min(s + chunk, P), dtype=np.int64) if partition else s), out

    def evaluate_batch(self, *, chunk: int | None = None, partition: bool = False) -> EngineResult:
        """All pods x nodes against the fixed snapshot (no state commit),
        pod-chunked so the recorded tensors never exceed one chunk's
        worth of device memory; chunks stream to host and concatenate in
        pod order (``partition`` as in ``evaluate_batch_chunks``)."""
        outs = [_pull_tree_to_host(out)
                for _key, out in self.evaluate_batch_chunks(chunk=chunk, partition=partition)]
        return self._to_result({k: np.concatenate([o[k] for o in outs]) for k in outs[0]})

    def evaluate_batch_fused(self, *, block: int = 256) -> EngineResult:
        """The whole pod axis in one kernel launch (the staged route: one
        launch of each stage per ``block`` pods), for the bounded-size
        record modes; record="full" must stream through evaluate_batch.
        ``block`` is the reference's pods per vmap block, clamped to the
        pod axis and halved until it divides it: here the plain version's
        pods per step (the kernel's persistent grid strides over the pods
        whatever its value)."""
        if self._record == "full":
            raise ValueError("record='full' results must stream: use evaluate_batch")
        self._refuse_sampling()
        P = int(self._pods.valid.shape[0])
        block = max(1, min(block, P))
        while P % block:
            block //= 2
        carries = self._prog.init_carries(self._aux)
        if self._staged is not None:
            # Kernel E's stages, ``block`` pods a launch.
            outs = [self._staged.batch(self._node_state, self._pods.rows(s, s + block), self._aux, carries)
                    for s in range(0, P, block)]
            out = ({k: torch.cat([o[k] for o in outs]) for k in outs[0]} if outs
                   else self._staged.batch(self._node_state, self._pods, self._aux, carries))
        else:
            out = self._batch_fn(self._prog, self._node_state, self._pods, self._aux, carries, block=block)
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
