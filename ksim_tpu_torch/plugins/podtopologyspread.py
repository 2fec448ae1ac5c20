"""PodTopologySpread filter + score.

Upstream kube-scheduler v1.30 ``plugins/podtopologyspread/{filtering,scoring}.go``
with NodeInclusionPolicy and MatchLabelKeys on (their v1.30 defaults),
MinDomains honored for DoNotSchedule constraints:

- Filter: for each DoNotSchedule constraint, nodes eligible for domain
  statistics are those passing the constraint's inclusion policies
  (nodeAffinityPolicy Honor -> pod's nodeSelector+required affinity;
  nodeTaintsPolicy Honor -> no untolerated NoSchedule/NoExecute taint)
  and carrying ALL the pod's DoNotSchedule topology keys.
  skew = matchNum + selfMatch - minMatchNum must not exceed maxSkew; a
  candidate missing the topology key fails with the "(missing required
  label)" message.  minMatchNum is 0 when the observed domain count is
  below minDomains.  The first failing constraint (upstream order) wins.
- Score: for each ScheduleAnyway constraint, counts accumulate over
  policy-passing nodes whose domain is registered (present among the
  feasible nodes with all score keys); per-node score is
  ``count * log(domains + 2) + (maxSkew - 1)`` summed over constraints in
  constraint order and rounded half to even; NormalizeScore is the
  integer ``100 * (max + min - s) // max`` with ignored nodes (missing a
  score key) pinned to 0, and everything 100 when max == 0.  Pods with no
  ScheduleAnyway constraints take upstream's PreScore-Skip path: 0.

The carry is the per-node matching-pod count per selector context
([N, S]).  Domain statistics are integer scatter-adds of per-node counts
into per-domain sums, one key of the topology-key vocabulary at a time
(``ksim_tpu`` dispatches singleton / one-hot matmul / segment_sum, three
ways of computing this same function on a TPU).

The log weight comes from a host table, never from a device ``log``:
float64 ``log(k + 2)`` from the C library's ``log`` in exact mode (equal
to XLA's float64 log on every k the tests check), and the reference's
own ``float32(numpy.log(k + 2))`` table in f32 mode.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ksim_tpu_torch.plugins.base import (
    MAX_NODE_SCORE,
    FilterOutput,
    NodeStateView,
    PodView,
    floordiv_nonneg,
)
from ksim_tpu_torch.plugins.nodeaffinity import required_affinity_match
from ksim_tpu_torch.plugins.tainttoleration import forbidding_taints_tolerated
from ksim_tpu_torch.state.encoding import SpreadTensors

NAME = "PodTopologySpread"
ERR_REASON_CONSTRAINTS_NOT_MATCH = "node(s) didn't match pod topology spread constraints"
ERR_REASON_NODE_LABEL_NOT_MATCH = ERR_REASON_CONSTRAINTS_NOT_MATCH + " (missing required label)"
_BIG = torch.iinfo(torch.int32).max
_SMALL = torch.iinfo(torch.int32).min

SKEW_BIT = 1
MISSING_LABEL_BIT = 2

_CON_FIELDS = (
    "valid", "mode", "sel", "tk", "max_skew", "min_domains", "self", "honor_aff", "honor_taints",
)


@functools.lru_cache(maxsize=8)
def log_weights(n_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """(float64, float32) tables of log(k + 2) for k = 0 .. n_nodes: the
    score's topology weight per registered-domain count."""
    w64 = np.array([math.log(k + 2.0) for k in range(n_nodes + 1)], dtype=np.float64)
    w32 = np.log(np.arange(n_nodes + 1, dtype=np.float64) + 2.0).astype(np.float32)
    return w64, w32


class PodTopologySpread:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 2
    final_score_bound = 100  # post-normalize max (MaxNodeScore)
    name = NAME

    def __init__(self, spread: SpreadTensors) -> None:
        self.tk_sizes = tuple(int(s) for s in spread.tk_sizes)
        self.tk_singleton = tuple(bool(s) for s in spread.tk_singleton)

    def static_sig(self) -> tuple:
        return (NAME, self.tk_sizes, self.tk_singleton)

    def failure_unresolvable(self, bits: int) -> bool:
        # Upstream: missing topology label is UnschedulableAndUnresolvable;
        # a skew violation is plain Unschedulable (victims can fix it).
        return bits == MISSING_LABEL_BIT

    def raw_dtype(self, exact: bool) -> torch.dtype:
        return torch.int32

    # -- carried state ------------------------------------------------------

    def carry_init(self, aux) -> torch.Tensor:
        return aux["spread"]["init_counts"]  # i32 [N, S]

    def carry_commit(self, carry, aux, pods: PodView, best) -> torch.Tensor:
        match = aux["spread"]["pod_sel_match"][pods.index[0]]  # [S]
        n = torch.arange(carry.shape[0], device=carry.device)
        onehot = (n == best) & (best >= 0)
        return carry + (onehot[:, None] & match[None, :]).to(carry.dtype)

    # -- helpers (every [B, N, MC] tensor: pod, node, constraint) -----------

    def _constraints(self, aux, pods: PodView) -> dict:
        a = aux["spread"]
        return {f: a["con_" + f][pods.index] for f in _CON_FIELDS}  # [B, MC]

    @staticmethod
    def _gather_cols(table: torch.Tensor, cols: torch.Tensor, fill: int) -> torch.Tensor:
        """[B, N, MC]: table[n, cols[b, c]], ``fill`` where cols is out of
        table's column range."""
        width = table.shape[1]  # >= 1: the featurizer pads every vocab
        inside = (cols >= 0) & (cols < width)
        got = table[:, cols.clamp(0, width - 1)].permute(1, 0, 2)  # [B, N, MC]
        return torch.where(inside[:, None, :], got, fill)

    def _ldom(self, aux, con) -> torch.Tensor:
        """[B, N, MC] each constraint's local domain id per node (-1 = key
        missing)."""
        return self._gather_cols(aux["spread"]["node_ldom"], con["tk"], -1)

    @staticmethod
    def _policy_elig(state, con, aff, tnt) -> torch.Tensor:
        """[B, N, MC] inclusion-policy eligibility per constraint."""
        e = state.valid[None, :, None]
        e = e & torch.where(con["honor_aff"][:, None, :], aff[:, :, None], True)
        return e & torch.where(con["honor_taints"][:, None, :], tnt[:, :, None], True)

    def _domain_stats(self, aux, con, pres_mask, cnt_for):
        """Domain statistics for every constraint at once.

        pres_mask: bool [B, N, MC] — nodes whose domain counts as present
        (filter: stat-eligible; score: registered = feasible and keyed).
        cnt_for(reg_at): i32 [B, N, MC] per-node contributions, given
        reg_at (bool [B, N, MC]: the node's domain is present).

        Returns (seg_at [B, N, MC] domain sum at each node, 0 where the node
        misses the key; dom_num [B, MC] present-domain count; min_match
        [B, MC] least present-domain sum, _BIG when none is present)."""
        ldom = aux["spread"]["node_ldom"]  # [N, TK]
        B, N, MC = pres_mask.shape
        dev = pres_mask.device
        seg_at = torch.zeros((B, N, MC), dtype=torch.int32, device=dev)
        dom_num = torch.zeros((B, MC), dtype=torch.int32, device=dev)
        minm = torch.full((B, MC), _BIG, dtype=torch.int32, device=dev)
        for k, size in enumerate(self.tk_sizes):
            g = con["tk"] == k  # [B, MC]
            ids = ldom[:, k]
            keyed = torch.nonzero(ids >= 0).squeeze(1)  # node rows carrying key k
            lid = ids[keyed].long()

            def per_domain(x):  # [B, N, MC] -> [B, MC, size] integer scatter-add
                out = torch.zeros((B, MC, size), dtype=torch.int32, device=dev)
                return out.index_add_(2, lid, x[:, keyed, :].permute(0, 2, 1).to(torch.int32))

            def at_nodes(d):  # [B, MC, size] -> [B, N, MC], 0 off the key
                out = torch.zeros((B, N, MC), dtype=d.dtype, device=dev)
                out[:, keyed, :] = d[:, :, lid].permute(0, 2, 1)
                return out

            pres = per_domain(pres_mask) > 0  # [B, MC, size]
            seg_d = per_domain(cnt_for(at_nodes(pres)))
            seg_at = torch.where(g[:, None, :], at_nodes(seg_d), seg_at)
            dom_num = torch.where(g, pres.sum(dim=2, dtype=torch.int32), dom_num)
            minm = torch.where(g, torch.where(pres, seg_d, _BIG).amin(dim=2), minm)
        return seg_at, dom_num, minm

    # -- filter -------------------------------------------------------------

    def filter(self, state: NodeStateView, pods: PodView, aux, carry) -> FilterOutput:
        con = self._constraints(aux, pods)
        active = con["valid"] & (con["mode"] == 0)  # [B, MC]
        aff = required_affinity_match(aux, pods)
        tnt = forbidding_taints_tolerated(aux, pods)
        haskey = self._ldom(aux, con) >= 0  # [B, N, MC]
        allkeys = (haskey | ~active[:, None, :]).all(dim=2)  # [B, N]
        stat = self._policy_elig(state, con, aff, tnt) & allkeys[:, :, None] & haskey
        x = torch.where(stat, self._gather_cols(carry, con["sel"], 0), 0)
        seg_at, dom_num, min_match = self._domain_stats(aux, con, stat, lambda _reg_at: x)
        min_match = torch.where(dom_num > 0, min_match, 0)
        min_match = torch.where(
            (con["min_domains"] > 0) & (dom_num < con["min_domains"]), 0, min_match
        )
        match_num = torch.where(haskey, seg_at, 0)
        skew = match_num + con["self"].to(torch.int32)[:, None, :] - min_match[:, None, :]
        viol = skew > con["max_skew"][:, None, :]
        code_mc = torch.where(~haskey, MISSING_LABEL_BIT, torch.where(viol, SKEW_BIT, 0))
        # First failing active constraint wins (upstream constraint order).
        code = torch.zeros(stat.shape[:2], dtype=torch.int32, device=stat.device)
        for ci in range(code_mc.shape[2]):
            code = torch.where(active[:, ci, None] & (code == 0), code_mc[:, :, ci], code)
        return FilterOutput(ok=code == 0, reason_bits=code.to(torch.int32))

    def decode_reasons(self, bits: int) -> list[str]:
        if bits == MISSING_LABEL_BIT:
            return [ERR_REASON_NODE_LABEL_NOT_MATCH]
        if bits == SKEW_BIT:
            return [ERR_REASON_CONSTRAINTS_NOT_MATCH]
        return []

    # -- score --------------------------------------------------------------

    def _score_parts(self, aux, con, pods: PodView):
        """(active [B, MC], haskey [B, N, MC], ignored [B, N]) for the
        ScheduleAnyway constraints."""
        active = con["valid"] & (con["mode"] == 1)
        haskey = self._ldom(aux, con) >= 0
        allkeys = (haskey | ~active[:, None, :]).all(dim=2)
        has_con = aux["spread"]["has_score_con"][pods.index]
        return active, haskey, has_con[:, None] & ~allkeys

    def score(self, state: NodeStateView, pods: PodView, aux, ok=None, *, exact=True, carry=None):
        con = self._constraints(aux, pods)
        active, haskey, ignored = self._score_parts(aux, con, pods)
        filtered = ok & ~ignored  # [B, N]
        # Registered domains: present among feasible, non-ignored nodes
        # (upstream calPreScoreState filteredNodes); contributors are
        # policy-passing nodes whose domain is registered.
        fd = filtered[:, :, None] & haskey
        aff = required_affinity_match(aux, pods)
        tnt = forbidding_taints_tolerated(aux, pods)
        elig0 = self._policy_elig(state, con, aff, tnt) & haskey
        cnt = self._gather_cols(carry, con["sel"], 0)
        seg_at, dom_num, _ = self._domain_stats(
            aux, con, fd, lambda reg_at: torch.where(elig0 & reg_at, cnt, 0)
        )
        table = aux["spread"]["log_w64" if exact else "log_w32"]
        ft = table.dtype
        weight = table[dom_num.clamp(0, table.shape[0] - 1).long()]  # [B, MC]
        contrib = seg_at.to(ft) * weight[:, None, :] + (con["max_skew"].to(ft)[:, None, :] - 1.0)
        vals = torch.where(active[:, None, :] & filtered[:, :, None], contrib, 0.0)
        # Constraint order, one add at a time.
        total = torch.zeros(filtered.shape, dtype=ft, device=vals.device)
        for ci in range(vals.shape[2]):
            total = vals[:, :, ci] if ci == 0 else total + vals[:, :, ci]
        raw = torch.round(total).to(torch.int32)
        has_con = aux["spread"]["has_score_con"][pods.index]
        return torch.where(has_con[:, None], raw, 0)

    def normalize(self, scores, ok, *, pods=None, aux=None, exact=True):
        con = self._constraints(aux, pods)
        _active, _haskey, ignored = self._score_parts(aux, con, pods)
        scoreable = ok & ~ignored
        anyv = scoreable.any(dim=1, keepdim=True)
        mx = torch.where(anyv, torch.where(scoreable, scores, _SMALL).amax(dim=1, keepdim=True), 0)
        mn = torch.where(anyv, torch.where(scoreable, scores, _BIG).amin(dim=1, keepdim=True), 0)
        # Every raw score is >= 0 and <= mx, so the numerator is too.
        num = torch.where(mx == 0, 0, MAX_NODE_SCORE * (mx + mn - scores))
        norm = torch.where(mx == 0, MAX_NODE_SCORE, floordiv_nonneg(num, mx.clamp_min(1)))
        has_con = aux["spread"]["has_score_con"][pods.index]
        return torch.where(has_con[:, None] & ~ignored, norm, 0).to(torch.int32)
