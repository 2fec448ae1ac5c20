"""Render engine results to the reference's Pod result annotations.

The recorded results ARE the product (SURVEY.md hard part 7): the reference
wraps every plugin, records per-node per-plugin outcomes into a result
store, and reflects them onto the scheduled Pod's annotations (reference
simulator/scheduler/plugin/resultstore/store.go:133-198 GetStoredResult,
simulator/scheduler/plugin/annotation/annotation.go:3-31 keys,
simulator/scheduler/storereflector/storereflector.go:148-167 history).

This module reconstructs the exact same annotation contract from the
batched EngineResult tensors:

- ``filter-result``: node -> plugin -> "passed" | reason message, with the
  upstream framework's early-exit semantics (a node rejected by filter k
  has no entries for filters > k — upstream RunFilterPlugins stops at the
  first failure).
- ``score-result``: node -> plugin -> raw score (feasible nodes only —
  upstream only scores nodes that passed all filters).
- ``finalscore-result``: node -> plugin -> normalized x weight
  (resultstore/store.go:461-507: AddScoreResult seeds final with
  raw x weight; NormalizeScore overwrites with normalized x weight).
- ``prefilter-result`` / ``prefilter-result-status`` / ``prescore-result``:
  per-plugin "success" for plugins whose upstream counterpart implements
  the extension point (our kernels fold Pre* work into the fused kernels,
  so the recorded status is always success; PreFilterResult node lists are
  always nil upstream for the default plugins -> "{}" here).
- ``reserve-result`` / ``prebind-result``: {"VolumeBinding": "success"}
  for scheduled pods when VolumeBinding is enabled at that point (the
  default profile's only Reserve/PreBind plugin; wrappedplugin.go:616-645
  Reserve, :670-697 PreBind); per-point profile disables drop it.
- ``permit-result`` / ``permit-result-timeout``: "{}" — the default
  profile has no Permit plugins.
- ``bind-result``: {"DefaultBinder": "success"} for scheduled pods.
- ``selected-node``: set only when the pod was scheduled (reference
  store.go AddSelectedNode is called at Reserve).

JSON is serialized with sorted keys and compact separators to byte-match
Go's json.Marshal of map[string]string.
"""

from __future__ import annotations

import json
from typing import Sequence

from ksim_tpu_torch.engine.core import EngineResult, ScoredPlugin
from ksim_tpu_torch.state.featurizer import FeaturizedSnapshot

PREFIX = "kube-scheduler-simulator.sigs.k8s.io/"

PRE_FILTER_STATUS_KEY = PREFIX + "prefilter-result-status"
PRE_FILTER_RESULT_KEY = PREFIX + "prefilter-result"
FILTER_RESULT_KEY = PREFIX + "filter-result"
POST_FILTER_RESULT_KEY = PREFIX + "postfilter-result"
PRE_SCORE_RESULT_KEY = PREFIX + "prescore-result"
SCORE_RESULT_KEY = PREFIX + "score-result"
FINAL_SCORE_RESULT_KEY = PREFIX + "finalscore-result"
RESERVE_RESULT_KEY = PREFIX + "reserve-result"
PERMIT_RESULT_KEY = PREFIX + "permit-result"
PERMIT_TIMEOUT_RESULT_KEY = PREFIX + "permit-result-timeout"
PRE_BIND_RESULT_KEY = PREFIX + "prebind-result"
BIND_RESULT_KEY = PREFIX + "bind-result"
SELECTED_NODE_KEY = PREFIX + "selected-node"
RESULT_HISTORY_KEY = PREFIX + "result-history"

ALL_RESULT_KEYS = (
    PRE_FILTER_STATUS_KEY,
    PRE_FILTER_RESULT_KEY,
    FILTER_RESULT_KEY,
    POST_FILTER_RESULT_KEY,
    PRE_SCORE_RESULT_KEY,
    SCORE_RESULT_KEY,
    FINAL_SCORE_RESULT_KEY,
    RESERVE_RESULT_KEY,
    PERMIT_RESULT_KEY,
    PERMIT_TIMEOUT_RESULT_KEY,
    PRE_BIND_RESULT_KEY,
    BIND_RESULT_KEY,
    SELECTED_NODE_KEY,
)

PASSED_FILTER_MESSAGE = "passed"  # resultstore PassedFilterMessage
SUCCESS_MESSAGE = "success"  # resultstore SuccessMessage
POST_FILTER_NOMINATED_MESSAGE = "preemption victim"

# Upstream extension points implemented by each kernel's Go counterpart
# (v1.30 plugin sources); used to emit the per-plugin "success" statuses
# the wrapped plugins would have recorded.
UPSTREAM_PRE_FILTER = {
    "NodeResourcesFit",
    "NodeAffinity",
    "PodTopologySpread",
    "InterPodAffinity",
    "NodePorts",
    "VolumeBinding",
    "VolumeRestrictions",
    "NodeVolumeLimits",
}
UPSTREAM_PRE_SCORE = {
    "TaintToleration",
    "NodeAffinity",
    "PodTopologySpread",
    "InterPodAffinity",
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
    "VolumeBinding",
}


def _marshal(obj) -> str:
    """Byte-compatible with Go json.Marshal for string maps."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class RenderCtx:
    """Per-pass shared state for rendering many pods' results: sorted
    node-name order, pre-JSON'd node/plugin names, the all-pass filter
    row, and a cross-pod reason-bit decode memo.  Build once per
    scheduling pass (the maps are assembled as JSON text directly — at
    10k pods x 5k nodes the per-entry dict building + json.dumps of the
    nested maps dominated the product path)."""

    def __init__(self, feats, plugins: Sequence[ScoredPlugin]) -> None:
        """``feats`` is a FeaturizedSnapshot, or a plain sequence of
        node names — the device-replay decode (engine/replay.py) renders
        per-step annotations over a step's live-node subset without a
        featurized snapshot in hand."""
        import numpy as np

        self.node_names = (
            list(feats) if isinstance(feats, (list, tuple)) else feats.nodes.names
        )
        self.filter_plugins = [sp for sp in plugins if sp.filter_enabled]
        self.score_plugins = [sp for sp in plugins if sp.score_enabled]
        names = self.node_names
        # json.dumps per atom keeps byte-compatibility with _marshal
        # (escaping, ensure_ascii) while the maps are joined by hand.
        self.node_json = [json.dumps(nm) for nm in names]
        order = sorted(range(len(names)), key=lambda i: names[i])
        self.rank = np.empty(len(names), dtype=np.int64)
        for r, i in enumerate(order):
            self.rank[i] = r
        fnames = [sp.plugin.name for sp in self.filter_plugins]
        self.fname_json = [json.dumps(n) for n in fnames]
        passed = json.dumps(PASSED_FILTER_MESSAGE)
        self.passed_row = "{" + ",".join(
            f"{k}:{passed}" for k in sorted(self.fname_json)
        ) + "}"
        # Inner score rows list plugin names sorted (Go map marshal order).
        sorder = sorted(range(len(self.score_plugins)),
                        key=lambda s: self.score_plugins[s].plugin.name)
        self.score_order = sorder
        self.sname_json = [json.dumps(self.score_plugins[s].plugin.name) for s in sorder]
        # Vectorized-assembly pieces: '"node":' prefixes (full and in
        # key-sorted node order) and the per-plugin score-row separators
        # ('{"p1":"', '","p2":"', ...).
        self.sorted_order_arr = np.asarray(order, dtype=np.int64)
        self.node_json_prefix_arr = np.asarray([nj + ":" for nj in self.node_json])
        self.node_json_sorted_prefix = [self.node_json[i] + ":" for i in order]
        self.score_prefix = [
            ("{" if s == 0 else '",') + self.sname_json[s] + ':"'
            for s in range(len(sorder))
        ]
        # (fi, bits) -> rendered filter row JSON, shared across pods.
        self.fail_row_memo: dict[tuple[int, int], str] = {}

    def fail_row(self, fi: int, bits: int) -> str:
        """Row for a node whose first filter failure is plugin ``fi``
        with ``bits``: upstream RunFilterPlugins stops at the first
        failure, so plugins after ``fi`` are absent from the row."""
        key = (fi, bits)
        row = self.fail_row_memo.get(key)
        if row is None:
            msg = ", ".join(self.filter_plugins[fi].plugin.decode_reasons(bits))
            entries = {self.fname_json[i]: json.dumps(PASSED_FILTER_MESSAGE) for i in range(fi)}
            entries[self.fname_json[fi]] = json.dumps(msg)
            row = "{" + ",".join(f"{k}:{v}" for k, v in sorted(entries.items())) + "}"
            self.fail_row_memo[key] = row
        return row


def render_pod_results(
    feats: FeaturizedSnapshot,
    plugins: Sequence[ScoredPlugin],
    res: EngineResult,
    pi: int,
    *,
    postfilter: dict | None = None,
    permit: tuple[dict, dict] | None = None,
    bound: bool = True,
    reserve_extra: dict | None = None,
    prebind_extra: dict | None = None,
    bind_map: dict | None = None,
    ctx: "RenderCtx | None" = None,
    visited: "np.ndarray | None" = None,
) -> dict[str, str]:
    """The 13 result annotations for queue pod ``pi`` (all keys present,
    empty maps as "{}", mirroring GetStoredResult's unconditional adds).
    ``postfilter`` is the {node: {plugin: msg}} map recorded by the
    PostFilter wrapper when preemption ran (wrappedplugin.go:550-577);
    ``permit`` is ({plugin: status}, {plugin: timeout_str}) recorded by
    the Permit wrapper (wrappedplugin.go:582-611, store.go:549-560);
    ``bound=False`` marks a cycle that selected a node but never reached
    Bind (a Permit rejection): selected-node and reserve-result stay
    recorded — upstream wrote them at Reserve — while prebind/bind maps
    stay empty because those wrappers never ran.
    ``reserve_extra``/``prebind_extra`` merge out-of-tree Reserve and
    PreBind hook results into their maps; ``bind_map`` overrides the
    bind-result map when a custom binder handled (or failed) the bind
    (wrappedplugin.go:699-726 AddBindResult records under the actual
    binder's name).
    ``visited`` (percentageOfNodesToScore emulation, res.visited[pi]):
    only visited nodes appear in the recorded maps — upstream's
    NodeToStatusMap and score lists cover the nodes its sampled filter
    iteration actually touched.
    Pass a shared ``ctx`` when rendering many pods of one pass."""
    if res.reason_bits is None:
        raise ValueError("render_pod_results needs record='full' results")
    import numpy as np

    if ctx is None:
        ctx = RenderCtx(feats, plugins)
    node_names = ctx.node_names
    filter_plugins = ctx.filter_plugins
    score_plugins = ctx.score_plugins
    N = len(node_names)

    bits_pi = np.asarray(res.reason_bits[pi])[:, :N]  # [F, N]
    failed = bits_pi != 0
    any_fail = failed.any(axis=0)
    # First failing plugin per node (argmax finds the first True); with
    # no filter plugins every node is feasible and argmax is undefined.
    if bits_pi.shape[0]:
        first_fail = np.argmax(failed, axis=0)
    else:
        first_fail = np.zeros(N, dtype=np.int64)
    vis = None if visited is None else np.asarray(visited)[:N].astype(bool)
    if vis is None:
        feasible_nodes = np.nonzero(~any_fail)[0]
    else:
        feasible_nodes = np.nonzero(~any_fail & vis)[0]

    # filter-result: every (visited) node gets a row; rows are shared
    # strings.  Nodes share a handful of distinct rows (the all-pass row
    # or one per (first failing plugin, bits) pattern): classify every
    # node to a pattern code in bulk, render each distinct row once,
    # then join.
    so = ctx.sorted_order_arr
    ff_s = first_fail[so].astype(np.int64)
    bits_at_ff = bits_pi[ff_s, so].astype(np.int64)
    codes = np.where(any_fail[so], (ff_s << 32) | (bits_at_ff & 0xFFFFFFFF), -1)
    uniq, inv = np.unique(codes, return_inverse=True)
    row_strs = []
    for code in uniq:
        if code < 0:
            row_strs.append(ctx.passed_row)
        else:
            row_strs.append(ctx.fail_row(int(code >> 32), int(code & 0xFFFFFFFF)))
    prefixes = ctx.node_json_sorted_prefix
    if vis is None:
        parts = [prefixes[k] + row_strs[i] for k, i in enumerate(inv)]
    else:
        vis_s = vis[so]
        parts = [
            prefixes[k] + row_strs[i]
            for k, i in enumerate(inv)
            if vis_s[k]
        ]
    filter_json = "{" + ",".join(parts) + "}"

    # Upstream schedulePod returns right after filtering when exactly one
    # node is feasible (schedule_one.go findNodesThatFitPod early return):
    # PreScore/Score/NormalizeScore never run, so the reference records
    # empty score maps.  Zero feasible nodes goes to PostFilter, likewise
    # without scoring.
    ran_scoring = len(feasible_nodes) > 1
    score_json = "{}"
    final_json = "{}"
    if res.scores is not None and score_plugins and ran_scoring:
        # Feasible nodes in key-sorted order; values stringified in bulk.
        feas = feasible_nodes[np.argsort(ctx.rank[feasible_nodes], kind="stable")]
        raw = np.char.mod("%d", np.asarray(res.scores[pi])[:, feas][ctx.score_order])
        fin = np.char.mod("%d", np.asarray(res.final_scores[pi])[:, feas][ctx.score_order])

        def rows_json(vals: np.ndarray) -> np.ndarray:
            # '"p1":"V1","p2":"V2",...' assembled as S vectorized string
            # concatenations over the feasible axis (python-level per-cell
            # loops dominated the product path at 10k x 5k).
            row = np.char.add(ctx.score_prefix[0], vals[0])
            for s in range(1, vals.shape[0]):
                row = np.char.add(row, ctx.score_prefix[s])
                row = np.char.add(row, vals[s])
            return np.char.add(row, '"}')

        node_pre = ctx.node_json_prefix_arr[feas]
        score_json = "{" + ",".join(np.char.add(node_pre, rows_json(raw)).tolist()) + "}"
        final_json = "{" + ",".join(np.char.add(node_pre, rows_json(fin)).tolist()) + "}"

    prefilter_status = {
        sp.plugin.name: SUCCESS_MESSAGE
        for sp in filter_plugins
        if sp.plugin.name in UPSTREAM_PRE_FILTER
    }
    prescore = (
        {
            sp.plugin.name: SUCCESS_MESSAGE
            for sp in score_plugins
            if sp.plugin.name in UPSTREAM_PRE_SCORE
        }
        if ran_scoring
        else {}
    )

    selected = int(res.selected[pi])
    # VolumeBinding is the default profile's only Reserve/PreBind plugin;
    # on a successful cycle upstream's wrappers record "success" for it
    # (wrappedplugin.go:616-645 Reserve, :670-697 PreBind).  Profiles can
    # disable it at a single point (ScoredPlugin.reserve/prebind_enabled).
    def _point_map(flag: str, ran: bool = True) -> dict:
        if selected < 0 or not ran:
            return {}
        return {
            sp.plugin.name: SUCCESS_MESSAGE
            for sp in plugins
            if sp.plugin.name == "VolumeBinding" and getattr(sp, flag, True)
        }

    reserve_map = _point_map("reserve_enabled")
    if reserve_extra and selected >= 0:
        reserve_map = {**reserve_map, **reserve_extra}
    prebind_map = _point_map("prebind_enabled", ran=bound)
    if prebind_extra and selected >= 0:
        prebind_map = {**prebind_map, **prebind_extra}
    if bind_map is None:
        bind_map = {"DefaultBinder": SUCCESS_MESSAGE} if selected >= 0 and bound else {}
    elif selected < 0:
        bind_map = {}
    out = {
        PRE_FILTER_RESULT_KEY: _marshal({}),
        PRE_FILTER_STATUS_KEY: _marshal(prefilter_status),
        FILTER_RESULT_KEY: filter_json,
        POST_FILTER_RESULT_KEY: _marshal(postfilter or {}),
        PRE_SCORE_RESULT_KEY: _marshal(prescore),
        SCORE_RESULT_KEY: score_json,
        FINAL_SCORE_RESULT_KEY: final_json,
        RESERVE_RESULT_KEY: _marshal(reserve_map),
        PERMIT_RESULT_KEY: _marshal(permit[0] if permit else {}),
        PERMIT_TIMEOUT_RESULT_KEY: _marshal(permit[1] if permit else {}),
        PRE_BIND_RESULT_KEY: _marshal(prebind_map),
        BIND_RESULT_KEY: _marshal(bind_map),
    }
    if selected >= 0:
        out[SELECTED_NODE_KEY] = node_names[selected]
    return out


def update_result_history(annotations: dict[str, str], result: dict[str, str]) -> None:
    """Append ``result`` to the result-history annotation in place
    (reference storereflector.go:148-167 updateResultHistory)."""
    history = json.loads(annotations.get(RESULT_HISTORY_KEY, "[]"))
    history.append(result)
    annotations[RESULT_HISTORY_KEY] = _marshal(history)


def apply_results_to_pod(
    pod_annotations: dict[str, str], result: dict[str, str]
) -> dict[str, str]:
    """What storeAllResultToPodFunc does to one Pod's annotations: merge
    the result keys, then append the same set to the history."""
    pod_annotations.update(result)
    update_result_history(pod_annotations, result)
    return pod_annotations
