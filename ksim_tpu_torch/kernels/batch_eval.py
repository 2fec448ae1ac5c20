"""Kernel B wrapper: batch evaluation of a pod chunk against a fixed
node state (no commit).

``batch_eval(prog, state, pods, aux, carries)`` returns the recorded
outputs of ``prog.record`` for every pod of ``pods``.  Tensors on the CPU
take ``batch_eval_plain``; tensors on a CUDA device launch
csrc/batch_eval.cu once for the whole chunk.
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.kernels import build, chain

# Pods per step of the plain version: bounds its [B, N, vocab]
# intermediates, as the reference's lax.map over vmap blocks does.
PLAIN_BLOCK = 256


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


def batch_eval(prog, state, pods, aux, carries, block: int = PLAIN_BLOCK):
    """``block``: the plain version's pods per step; the kernel runs one
    pod per thread block."""
    device = state.valid.device
    if device.type == "cpu":
        return batch_eval_plain(prog, state, pods, aux, carries, block)
    if device.type != "cuda":
        raise ValueError(f"batch_eval runs on cpu or cuda, not {device}")
    lib = build.load("batch_eval")
    out = chain.empty_outputs(prog, pods.valid.shape[0], state.valid.shape[0], device)
    prm = chain.chain_params(prog, state, pods, aux, carries, out, grid=max(pods.valid.shape[0], 1))
    chain.launch(lib, "ksim_batch_eval", prm)
    batch_eval.launches += 1
    return out


batch_eval.launches = 0
