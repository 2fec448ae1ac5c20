#!/usr/bin/env python3
"""Time kernels A, B and C on the card at the main path's shape.

    python3 chip_scan_timing.py [--reps 3] [--cluster 0] [--threads 0] [--drop-each]

Featurizes random_cluster(0, 5000 nodes, 10000 pods, bound_fraction=0)
(padded to 12288 x 6144, the whole default profile, exact mode) and times
with CUDA events (mean of ``--reps`` launches after one warm-up): kernel
A's whole-queue pass (record="selection"), kernel C's whole-queue pass
(sampling_k=500, record="selection") and its record="full" pass over the
first 2048 pods, kernel B's fused launch (record="final") and its
record="full" launch over the first 2048 pods.  Where the
tree's kernels A and C run on a thread-block cluster, ``--cluster`` and
``--threads`` set its size and block width (0: the launch's own choice)
and the line reports what ran, with block 0's share of the cycles in each
phase of a pod; likewise kernel B's persistent grid, where the tree has
one.  ``--drop-each`` also times B's fused launch with each plugin of the
profile left out in turn: what each plugin costs it.  Prints one JSON line: the card (nvidia-smi name and
power limit), the tree it ran from, and the times.  Run it from the root
of the tree to time; to compare two trees, run it from each on one card,
in turns (A, B, B, A)."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
sys.path.insert(0, str(Path.cwd() / "tests"))

from helpers import random_cluster  # noqa: E402
from ksim_tpu_torch.engine.core import Engine  # noqa: E402
from ksim_tpu_torch.engine.profiles import default_plugins  # noqa: E402
from ksim_tpu_torch.kernels import chain  # noqa: E402
from ksim_tpu_torch.kernels.batch_eval import batch_eval  # noqa: E402
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled  # noqa: E402
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan  # noqa: E402
from ksim_tpu_torch.state.featurizer import Featurizer  # noqa: E402

MAIN = (5000, 10000)
PREFIX = 2048
SAMPLING_K = 500


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ran(wrapper) -> dict | None:
    """What the tree's last cluster launch ran, or None (one block)."""
    last = getattr(wrapper, "last", None)
    if last is None:
        return None
    stats = [int(x) for x in last["stats"].cpu()]
    out = {k: last[k] for k in ("cluster", "threads", "smem_bytes")}
    out["barriers_per_pod"] = stats[0] / max(stats[1], 1)
    cycles = stats[2:]
    phases = getattr(chain, "CLUSTER_PHASES", ())
    if cycles and phases:
        out["phase_share"] = {name: c / max(sum(cycles), 1) for name, c in zip(phases, cycles)}
    return out


def batch_ran() -> dict | None:
    """What the tree's last kernel-B launch ran (its persistent grid and
    block 0's cycle share per phase of a pod), or None where kernel B
    runs one pod per block."""
    last = getattr(batch_eval, "last", None)
    if last is None:
        return None
    import ksim_tpu_torch.kernels.batch_eval as batch_mod

    out = {k: last[k] for k in ("grid", "blocks_per_sm", "registers", "local_bytes", "smem_bytes")}
    cycles = [int(x) for x in last["stats"].cpu()][2:]
    out["phase_share"] = {name: sum(cycles[i] for i in idx) / max(sum(cycles), 1)
                          for name, idx in batch_mod.B_PHASES.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cluster", type=int, default=0)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--drop-each", action="store_true",
                    help="also time kernel B's fused launch with each plugin left out in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_scan_timing: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if hasattr(chain, "CLUSTER_SIZE"):
        chain.CLUSTER_SIZE, chain.CLUSTER_THREADS = args.cluster, args.threads
    nodes, pods = random_cluster(0, *MAIN, bound_fraction=0.0)
    feats = Featurizer().featurize(nodes, pods)
    feats_2k = Featurizer().featurize(nodes, pods[:PREFIX])
    n_real, n_pods = len(feats.nodes.names), len(feats.pods.keys)
    plugins, plugins_2k = default_plugins(feats), default_plugins(feats_2k)
    start0 = torch.zeros((), dtype=torch.int32, device="cuda")
    out = {"card": card, "tree": str(Path.cwd()), "shape": f"{feats.pods.valid.shape[0]}x{feats.nodes.valid.shape[0]}",
           "real_pods": n_pods}

    eng = Engine(feats, plugins, record="selection", exact=True, device="cuda")
    prog, state, pods_t, aux = eng._prog, eng._node_state, eng._pods, eng._aux
    carries = prog.init_carries(aux)
    out["a_ms"] = cuda_ms(lambda: schedule_scan(prog, state, pods_t, aux, carries), args.reps)
    out["a_ran"] = ran(schedule_scan)
    sprog = Engine(feats, plugins, record="selection", exact=True, device="cuda", sampling_k=SAMPLING_K)._prog
    out["c_queue_ms"] = cuda_ms(
        lambda: schedule_sampled(sprog, state, pods_t, aux, carries, start0, n_real, SAMPLING_K), args.reps)
    out["c_queue_ran"] = ran(schedule_sampled)
    full = Engine(feats_2k, plugins_2k, record="full", exact=True, device="cuda", sampling_k=SAMPLING_K)
    fcarries = full._prog.init_carries(full._aux)
    out["c_full_2k_ms"] = cuda_ms(lambda: schedule_sampled(full._prog, full._node_state, full._pods, full._aux,
                                                           fcarries, start0, n_real, SAMPLING_K), args.reps)
    out["c_full_2k_ran"] = ran(schedule_sampled)
    fused = Engine(feats, plugins, record="final", exact=True, device="cuda")
    bcarries = fused._prog.init_carries(fused._aux)
    out["b_fused_ms"] = cuda_ms(
        lambda: batch_eval(fused._prog, fused._node_state, fused._pods, fused._aux, bcarries), args.reps)
    out["b_fused_ran"] = batch_ran()
    chunk = Engine(feats_2k, plugins_2k, record="full", exact=True, device="cuda")
    ccarries = chunk._prog.init_carries(chunk._aux)
    out["b_full_2k_ms"] = cuda_ms(
        lambda: batch_eval(chunk._prog, chunk._node_state, chunk._pods, chunk._aux, ccarries), args.reps)
    if args.drop_each:
        out["b_fused_without_ms"] = {}
        for sp in plugins:
            rest = tuple(p for p in plugins if p is not sp)
            eng = Engine(feats, rest, record="final", exact=True, device="cuda")
            c = eng._prog.init_carries(eng._aux)
            out["b_fused_without_ms"][sp.plugin.name] = cuda_ms(
                lambda: batch_eval(eng._prog, eng._node_state, eng._pods, eng._aux, c), args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
