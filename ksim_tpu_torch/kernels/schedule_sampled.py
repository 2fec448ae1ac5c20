"""Kernel C wrapper: the sequential-commit scan with percentageOfNodesToScore
sampling, over one pod chunk.

``schedule_sampled(prog, state, pods, aux, carries, start, n_real, k)``
runs the engine program ``prog`` over the pods of ``pods`` in order.  Each
pod runs every filter on every node, then visits the real nodes in index
order from the rotating ``start`` (a 0-d int32 tensor) and stops after
its ``k``-th feasible node (upstream schedule_one.go
findNodesThatPassFilters + numFeasibleNodesToFind, as the deterministic
sequential visit); scores, normalizes and selection run over the
visited feasible nodes only, and the start advances by the nodes visited
(valid pods only).  Returns ``(state, carries, start, out)``; under
record="full", ``out["visited"]`` holds each pod's visited mask.  Its
inputs are never modified.

Tensors on the CPU take ``schedule_sampled_plain``; tensors on a CUDA
device launch csrc/schedule_sampled.cu once for the whole chunk, on one
thread-block cluster (kernels/chain.py ``launch_cluster``); what the last
launch ran is kept in ``schedule_sampled.last``.
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.kernels import build, chain

_INT32_MAX = torch.iinfo(torch.int32).max


def sample_visited(ok: torch.Tensor, start: torch.Tensor, n_real: int, k: int):
    """(visited [N], sample = ok & visited [N], next start 0-d) for one pod
    whose filters gave ``ok`` [N]: nodes are visited in index order from
    ``start`` modulo the real node count, until the k-th feasible one
    (all of them when fewer than k are feasible)."""
    n = ok.shape[0]
    i = torch.arange(n, dtype=torch.int32, device=ok.device)
    nr = max(n_real, 1)
    in_real = i < n_real
    pos = torch.where(in_real, torch.remainder(i - start, nr), _INT32_MAX)  # visit position
    feasible = ok & in_real
    # Positions are distinct, so the k-th smallest feasible one is unique.
    kth = torch.where(feasible, pos, _INT32_MAX).kthvalue(k).values
    threshold = torch.where(feasible.sum() >= k, kth, n_real - 1)
    visited = in_real & (pos <= threshold)
    return visited, ok & visited, torch.remainder(start + threshold + 1, nr).to(torch.int32)


def schedule_sampled_plain(prog, state, pods, aux, carries, start, n_real: int, k: int):
    """The plain PyTorch version: a Python loop over the pods of
    [N]-wide tensor ops (the reference's lax.scan body)."""
    outs = []
    for i in range(pods.valid.shape[0]):
        pod = pods.rows(i, i + 1)
        view = pod.view()
        ok, bits = prog.eval_filters(state, view, aux, carries)
        visited, sample, next_start = sample_visited(ok[0], start, n_real, k)
        # Padding pods never ran a cycle upstream: no rotation.
        start = torch.where(pod.valid[0], next_start, start)
        raw, final, total = prog.eval_scores(state, view, aux, carries, sample[None])
        best = torch.where(pod.valid, prog.select(sample[None], total), -1)  # [1]
        state = state.commit(best[0], pod.requests[0], pod.nonzero_requests[0])
        carries = prog.commit_carries(carries, view, best[0], aux)
        outs.append(prog.pod_outputs(pod.valid, best, bits, raw, final, total, visited=visited[None]))
    if not outs:
        out = chain.empty_outputs(prog, 0, state.valid.shape[0], state.valid.device, sampled=True)
        return state, carries, start, out
    return state, carries, start, {key: torch.cat([o[key] for o in outs]) for key in outs[0]}


def schedule_sampled(prog, state, pods, aux, carries, start, n_real: int, k: int):
    device = state.valid.device
    if device.type == "cpu":
        return schedule_sampled_plain(prog, state, pods, aux, carries, start, n_real, k)
    if device.type != "cuda":
        raise ValueError(f"schedule_sampled runs on cpu or cuda, not {device}")
    lib = build.load("schedule_sampled")
    state, carries = chain.fresh_scan_state(prog, state, carries)
    start = start.reshape(1).clone()
    out = chain.empty_outputs(prog, pods.valid.shape[0], state.valid.shape[0], device, sampled=True)
    prm = chain.chain_params(prog, state, pods, aux, carries, out, cluster=True, sampling=(start, n_real, k))
    schedule_sampled.last = chain.launch_cluster(lib, "ksim_schedule_sampled", prm)
    schedule_sampled.launches += 1
    return state, carries, start.reshape(()), out


schedule_sampled.launches = 0
schedule_sampled.last = None
