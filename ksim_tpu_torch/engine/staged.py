"""The staged program: a profile the fused kernels cannot run, as kernel E's
stages with the hooks and the kernel-less plugins between them.

``ksim_tpu`` traces a ``PluginExtender``'s device hooks and the plugins
without kernel code into the programs it compiles (engine/core.py
``_eval_filters``, ``_eval_scores``, ``_final_from_raw``).  Here such a
program is a short sequence of stage launches (kernels/chain_stages.py:
E1 filters, E2 raw scores, E3 normalizes, E4 window and select/commit),
and between them the hooks and the kernel-less plugins run as torch code
on the same device tensors.  The profile's rows are grouped into
launches, in profile order:

- the rows with kernel code and no ``before_*`` hook share one launch per
  stage, over the unchanged (state, pods);
- a row with ``before_filter`` gets a launch of its own over the (state,
  pods) its hook returns; so does a row with ``before_score``, for E2 and
  E3;
- a row with no kernel code runs its plugin's own ``filter``, ``score``
  and ``normalize``;
- ``after_filter``, ``after_score``, ``before_normalize`` and
  ``after_normalize`` apply to their own row's slice, between the stages.

The reason codes, raw scores and finals are reassembled in profile order;
the feasible mask is the nodes' validity AND every row's ok.  The scan
runs, per pod, E1 -> (E4 window) -> E2 -> E3 -> E4 select with its commit,
with the node state and the carries on the device and no host sync per
pod.  The stage functions are the wrappers (kernel E on a CUDA device, the
plain versions on the CPU) or, for a comparison, the plain versions on any
device (``StagedProgram(prog, PLAIN_STAGES)``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch

from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.kernels.chain_stages import STAGES, Stages
from ksim_tpu_torch.plugins.base import FilterOutput


@dataclass
class StageGroup:
    """Profile rows run by one launch of a stage (or by their plugin's own
    torch code, ``sub`` None)."""

    rows: list = field(default_factory=list)  # rows among the profile's filters (or scores)
    sps: list = field(default_factory=list)  # their ScoredPlugins
    sub: Any = None  # the sub-profile the launch runs: these rows, no hooks
    own: bool = False  # the row's before_* hook gives its (state, pods)


def _hook(sp, name: str):
    ext = sp.extender
    return getattr(ext, name, None) if ext is not None else None


def _carry(sp, carries: dict) -> dict:
    return {"carry": carries[sp.plugin.name]} if sp.plugin.name in carries else {}


class StagedProgram:
    """A profile's rows grouped into kernel E launches (module docstring),
    and the batch evaluation and the scan over them."""

    def __init__(self, prog, stages: Stages = STAGES) -> None:
        self.prog = prog
        self.stages = stages
        self.filter_groups = self._groups(prog.filters, "before_filter", filters=True)
        self.score_groups = self._groups(prog.scores, "before_score", filters=False)
        # The selection commits the node state and the carries of every
        # plugin with kernel code; the others' carries commit in torch.
        self.commit_sub = self._sub([sp for sp in prog.plugins if chain.has_kernel_code(sp.plugin)])
        self.torch_carried = [sp for sp in prog.plugins
                              if not chain.has_kernel_code(sp.plugin) and hasattr(sp.plugin, "carry_init")]
        self._weights: dict = {}

    def _sub(self, sps, *, filters: "bool | None" = None):
        """The sub-profile of ``sps`` with no hooks: their filters
        (``filters`` True), their scores (False) or both (None)."""
        rows = tuple(
            dataclasses.replace(sp, extender=None,
                                filter_enabled=sp.filter_enabled and filters is not False,
                                score_enabled=sp.score_enabled and filters is not True)
            for sp in sps
        )
        return type(self.prog)(rows, "full", self.prog.exact)

    def _groups(self, sps, before: str, *, filters: bool) -> list:
        groups, shared = [], None
        for row, sp in enumerate(sps):
            if not chain.has_kernel_code(sp.plugin):
                groups.append(StageGroup([row], [sp], None, True))
            elif _hook(sp, before) is not None:
                groups.append(StageGroup([row], [sp], self._sub([sp], filters=filters), True))
            else:
                if shared is None:
                    shared = StageGroup()
                    groups.append(shared)
                shared.rows.append(row)
                shared.sps.append(sp)
        if shared is not None:
            shared.sub = self._sub(shared.sps, filters=filters)
        return groups

    def launches_per_pod(self, sampled: bool = False) -> int:
        """Kernel E launches per pod of the scan."""
        kernel = [g for g in self.filter_groups if g.sub is not None]
        scored = [g for g in self.score_groups if g.sub is not None]
        return len(kernel) + 2 * len(scored) + 1 + int(sampled)

    # -- the stages, over a block of B pods ------------------------------------

    def eval_filters(self, state, pods, aux: dict, carries: dict):
        """(feasible [B, N], reason codes per profile filter row [B, N])."""
        B, N = pods.index.shape[0], state.valid.shape[0]
        ok = state.valid[None, :].expand(B, N)
        bits: list = [None] * len(self.prog.filters)
        for g in self.filter_groups:
            sp0 = g.sps[0]
            f_state, f_pods = state, pods
            if g.own and _hook(sp0, "before_filter") is not None:
                f_state, f_pods = sp0.extender.before_filter(state, pods, aux)
            if g.sub is None:
                out = sp0.plugin.filter(f_state, f_pods, aux, **_carry(sp0, carries))
                after = _hook(sp0, "after_filter")
                if after is not None:
                    out = after(f_state, f_pods, aux, out)
                bits[g.rows[0]] = out.reason_bits
                ok = ok & out.ok
                continue
            codes, group_ok = self.stages.filter(g.sub, f_state, f_pods, aux, carries)
            # The launch's ok is the rows' AND over the launch's own node
            # validity: it stands for the rows only over the unchanged
            # state and with no after_filter to apply.
            whole = not g.own and all(_hook(sp, "after_filter") is None for sp in g.sps)
            if whole:
                ok = ok & group_ok
            for i, (row, sp) in enumerate(zip(g.rows, g.sps)):
                code = codes[:, i]
                after = _hook(sp, "after_filter")
                if after is not None:
                    out = after(f_state, f_pods, aux, FilterOutput(ok=code == 0, reason_bits=code))
                    code = out.reason_bits
                    ok = ok & out.ok
                elif not whole:
                    ok = ok & (code == 0)  # every plugin's ok is its code == 0
                bits[row] = code
        return ok, bits

    def eval_scores(self, state, pods, aux: dict, carries: dict, ok):
        """(raw scores, normalized scores before the weight), per profile
        score row [B, N], with ``ok`` the mask scores and normalizes run
        over (the feasible set, or under sampling the sampled one)."""
        exact = self.prog.exact
        raws: list = [None] * len(self.prog.scores)
        norms: list = [None] * len(self.prog.scores)
        for g in self.score_groups:
            sp0 = g.sps[0]
            s_state, s_pods = state, pods
            if g.own and _hook(sp0, "before_score") is not None:
                s_state, s_pods = sp0.extender.before_score(state, pods, aux)
            if g.sub is None:
                p = sp0.plugin
                raw = p.score(s_state, s_pods, aux, ok, exact=exact, **_carry(sp0, carries))
                raw = self._after_score(sp0, s_state, s_pods, aux, raw)
                norm = self._before_normalize(sp0, s_state, s_pods, aux, raw, ok)
                if hasattr(p, "normalize"):
                    norm = p.normalize(norm, ok, pods=s_pods, aux=aux, exact=exact)
                raws[g.rows[0]] = raw
                norms[g.rows[0]] = self._after_normalize(sp0, s_state, s_pods, aux, norm, ok)
                continue
            group_raw = self.stages.score(g.sub, s_state, s_pods, aux, carries, ok)
            between = any(_hook(sp, "after_score") or _hook(sp, "before_normalize") for sp in g.sps)
            pre = []
            for i, (row, sp) in enumerate(zip(g.rows, g.sps)):
                dtype = sp.plugin.raw_dtype(exact)
                raw = self._after_score(sp, s_state, s_pods, aux, group_raw[:, i].to(dtype))
                raws[row] = raw
                if between:
                    pre.append(self._before_normalize(sp, s_state, s_pods, aux, raw, ok).to(dtype))
            group_in = torch.stack([x.to(torch.int64) for x in pre], dim=1) if between else group_raw
            group_norm = self.stages.normalize(g.sub, s_state, s_pods, aux, carries, group_in, ok)
            for i, (row, sp) in enumerate(zip(g.rows, g.sps)):
                norm = group_norm[:, i]
                if _hook(sp, "after_normalize") is not None:
                    norm = norm.to(torch.int32 if hasattr(sp.plugin, "normalize") else sp.plugin.raw_dtype(exact))
                    norm = self._after_normalize(sp, s_state, s_pods, aux, norm, ok)
                norms[row] = norm
        return raws, norms

    @staticmethod
    def _after_score(sp, state, pods, aux, raw):
        hook = _hook(sp, "after_score")
        return raw if hook is None else hook(state, pods, aux, raw)

    @staticmethod
    def _before_normalize(sp, state, pods, aux, raw, ok):
        hook = _hook(sp, "before_normalize")
        return raw if hook is None else hook(state, pods, aux, raw, ok)

    @staticmethod
    def _after_normalize(sp, state, pods, aux, norm, ok):
        hook = _hook(sp, "after_normalize")
        return norm if hook is None else hook(state, pods, aux, norm, ok)

    def _weights_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._weights:
            self._weights[key] = torch.tensor([sp.weight for sp in self.prog.scores], dtype=torch.int32,
                                              device=device)
        return self._weights[key]

    def _select(self, state, pods, aux, carries, norms, ok, out: dict, *, commit: bool) -> None:
        B, N = ok.shape
        norm = (torch.stack([x.to(torch.int64) for x in norms], dim=1) if norms
                else torch.zeros((B, 0, N), dtype=torch.int64, device=ok.device))
        self.stages.select(self.commit_sub, state, pods, aux, carries, norm, self._weights_on(ok.device), ok, out,
                           commit=commit)

    def _record(self, out: dict, rows: slice, bits, raws) -> None:
        """The record="full" reason codes and raw scores of ``rows``."""
        if self.prog.record != "full":
            return
        bits_dtype, _, raw_dtype = self.prog.dtypes
        if bits:
            out["bits"][rows] = torch.stack([x.to(bits_dtype) for x in bits], dim=1)
        if raws:
            out["raw"][rows] = torch.stack([x.to(raw_dtype) for x in raws], dim=1)

    # -- the entry points ----------------------------------------------------------

    def batch(self, state, pods, aux: dict, carries: dict) -> dict:
        """Every pod of ``pods`` (a PodBatch) against the fixed ``state``:
        the outputs of the record mode (kernels/batch_eval.py's)."""
        B, N = pods.index.shape[0], state.valid.shape[0]
        out = chain.empty_outputs(self.prog, B, N, state.valid.device)
        view = pods.view()
        ok, bits = self.eval_filters(state, view, aux, carries)
        raws, norms = self.eval_scores(state, view, aux, carries, ok)
        self._select(state, pods, aux, carries, norms, ok, out, commit=False)
        self._record(out, slice(0, B), bits, raws)
        return out

    def scan(self, state, pods, aux: dict, carries: dict, sampling: "tuple | None" = None):
        """The sequential-commit scan of ``pods`` in order:
        ``(state, carries, out)``, or with ``sampling`` = (start 0-d int32,
        n_real, k) ``(state, carries, start, out)``.  Its inputs are never
        modified: the scan commits into fresh copies on the device."""
        prog, st = self.prog, self.stages
        device = state.valid.device
        state, carries = chain.fresh_scan_state(prog, state, carries)
        P, N = pods.index.shape[0], state.valid.shape[0]
        out = chain.empty_outputs(prog, P, N, device, sampled=sampling is not None)
        if sampling is not None:
            start, n_real, k = sampling
            start = start.reshape(1).to(torch.int32).clone()
        # Under record="selection" a padding pod records -1 and changes
        # nothing: it is skipped (the one host read of the chunk).
        skip = pods.valid.cpu().logical_not().tolist() if prog.record == "selection" else [False] * P
        out["selected"].fill_(-1)
        for p in range(P):
            if skip[p]:
                continue
            pod = pods.rows(p, p + 1)
            view = pod.view()
            ok, bits = self.eval_filters(state, view, aux, carries)
            mask = ok
            if sampling is not None:
                mask, visited, start = st.window(ok, start, pod.valid, n_real, k)
                if "visited" in out:
                    out["visited"][p] = visited[0]
            raws, norms = self.eval_scores(state, view, aux, carries, mask)
            rows = {key: out[key][p:p + 1] for key in ("selected", "total", "final") if key in out}
            self._select(state, pod, aux, carries, norms, mask, rows, commit=True)
            for sp in self.torch_carried:
                name = sp.plugin.name
                carries[name] = sp.plugin.carry_commit(carries[name], aux, view, rows["selected"][0])
            self._record(out, slice(p, p + 1), bits, raws)
        if sampling is not None:
            return state, carries, start.reshape(()), out
        return state, carries, out
