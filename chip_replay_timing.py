#!/usr/bin/env python3
"""Time kernel D on the card: the solo launch, and the fleet launch where
the tree has one, on the fullest segment of the 6k churn replay.

    python3 chip_replay_timing.py [--lanes 8] [--reps 5] [--cluster 0] [--threads 0]

Runs ScenarioRunner(device_replay=True) on churn_scenario(0, 2000 nodes,
6000 events, 100 ops per step), f32 mode, K = 16, captures every kernel-D
launch, and times the launch with the most attempts with CUDA events
(mean of ``--reps`` launches after one warm-up).  With ``--lanes S`` and
a kernels/replay_segment.py that has ``replay_segment_fleet``, it also
times one fleet launch of S identical lanes of that segment.  Where the
tree runs kernel D on a thread-block cluster, ``--cluster`` and
``--threads`` force its size and block width (0: the launch's choice),
and the line also holds what each launch ran: the cluster size, the
threads and shared memory per block, the cluster barriers and attempts
block 0 counted, and block 0's share of its clock cycles by phase.
Prints one JSON line: the card (nvidia-smi name and power limit), the
tree it ran from, the segment's shape and the times.  Run it from the
root of the tree to time; to compare two trees, run it from each on one
card, one after the other, in turns (A, B, B, A)."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))

import ksim_tpu_torch.engine.replay as replay_mod  # noqa: E402
from ksim_tpu_torch.kernels import chain  # noqa: E402
from ksim_tpu_torch.kernels import replay_segment as segment_mod  # noqa: E402
from ksim_tpu_torch.scenario.generate import churn_scenario  # noqa: E402
from ksim_tpu_torch.scenario.runner import ScenarioRunner  # noqa: E402


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


def ran(last: dict) -> dict:
    """What a clustered launch ran, with block 0's cycle share by phase."""
    stats = [int(x) for x in last["stats"].cpu()]
    cycles = stats[2:]
    share = {name: round(c / max(sum(cycles), 1), 4) for name, c in zip(chain.CLUSTER_PHASES, cycles) if c}
    return {"cluster": last["cluster"], "threads": last["threads"], "smem_bytes": last["smem_bytes"],
            "barriers": stats[0], "attempts": stats[1], "barriers_per_attempt": stats[0] / max(stats[1], 1),
            "phase_share": share}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cluster", type=int, default=0)
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_replay_timing: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    segments = []
    kernel = replay_mod.replay_segment

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments.append((st, prog, const, ev, held, outs))
        return final, outs

    replay_mod.replay_segment = capture
    runner = ScenarioRunner(max_pods_per_pass=1024, pod_bucket_min=128, device_replay=True,
                            device_segment_steps=16, exact=False, device="cuda")
    res = runner.run(list(churn_scenario(0, n_nodes=2000, n_events=6000, ops_per_step=100)))
    replay_mod.replay_segment = kernel
    if (res.pods_scheduled, res.unschedulable_attempts) != (2524, 471):
        raise AssertionError(f"the 6k lock failed: {res.pods_scheduled}/{res.unschedulable_attempts}")

    def attempts(seg) -> int:
        return int((seg[5]["idx"] < seg[2]["pods"]["requests"].shape[0]).sum())

    st, prog, const, ev, state0, _outs = max(segments, key=attempts)
    clustered = hasattr(segment_mod, "CLUSTER_SIZE")
    if clustered:
        segment_mod.CLUSTER_SIZE, segment_mod.CLUSTER_THREADS = args.cluster, args.threads
    out = {
        "card": card,
        "tree": str(Path.cwd()),
        "segment": {"k": st.k, "q": st.q, "nodes": int(const["node"]["allocatable"].shape[0]),
                    "pod_rows": int(const["pods"]["requests"].shape[0]), "attempts": attempts(max(segments, key=attempts))},
        "solo_ms": cuda_ms(lambda: kernel(st, prog, const, ev, state0), args.reps),
    }
    if clustered:
        out["solo_ran"] = ran(kernel.last)
    fleet = getattr(segment_mod, "replay_segment_fleet", None)
    if fleet is not None:
        stacked = {k: torch.stack([v] * args.lanes) for k, v in state0.items()}
        out[f"fleet_{args.lanes}_ms"] = cuda_ms(lambda: fleet(st, prog, const, ev, stacked), args.reps)
        if clustered:
            out["fleet_ran"] = ran(fleet.last)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
