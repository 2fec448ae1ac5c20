"""Kernel A wrapper: the sequential-commit scan over one pod chunk.

``schedule_scan(prog, state, pods, aux, carries)`` runs the engine
program ``prog`` (engine/core.py ``_Program``) over the pods of ``pods``
in order, committing each placed pod into the node state and the
plugins' carries.  It returns ``(state, carries, out)``: the committed state, the
committed carries and the recorded outputs of ``prog.record``.  Its
inputs are never modified.

Tensors on the CPU take ``schedule_scan_plain``; tensors on a CUDA
device launch csrc/schedule_scan.cu once for the whole chunk, on one
thread-block cluster (kernels/chain.py ``launch_cluster``); what the last
launch ran (its cluster size, threads, shared memory and on-card stats)
is kept in ``schedule_scan.last``.
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.kernels import build, chain


def schedule_scan_plain(prog, state, pods, aux, carries):
    """The plain PyTorch version: a Python loop over the pods of
    [N]-wide tensor ops (the reference's lax.scan body)."""
    outs = []
    for i in range(pods.valid.shape[0]):
        pod = pods.rows(i, i + 1)
        view = pod.view()
        ok, bits, raw, final, total = prog.eval_block(state, view, aux, carries)
        best = torch.where(pod.valid, prog.select(ok, total), -1)  # [1]
        state = state.commit(best[0], pod.requests[0], pod.nonzero_requests[0])
        carries = prog.commit_carries(carries, view, best[0], aux)
        outs.append(prog.pod_outputs(pod.valid, best, bits, raw, final, total))
    if not outs:
        return state, carries, chain.empty_outputs(prog, 0, state.valid.shape[0], state.valid.device)
    return state, carries, {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def schedule_scan(prog, state, pods, aux, carries):
    device = state.valid.device
    if device.type == "cpu":
        return schedule_scan_plain(prog, state, pods, aux, carries)
    if device.type != "cuda":
        raise ValueError(f"schedule_scan runs on cpu or cuda, not {device}")
    lib = build.load("schedule_scan")
    state, carries = chain.fresh_scan_state(prog, state, carries)
    out = chain.empty_outputs(prog, pods.valid.shape[0], state.valid.shape[0], device)
    prm = chain.chain_params(prog, state, pods, aux, carries, out, cluster=True)
    schedule_scan.last = chain.launch_cluster(lib, "ksim_schedule_scan", prm)
    schedule_scan.launches += 1
    return state, carries, out


schedule_scan.launches = 0
schedule_scan.last = None
