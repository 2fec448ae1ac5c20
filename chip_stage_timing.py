#!/usr/bin/env python3
"""Time kernel E's filter and score stages (E1, E2) on the card at the main
path's shape.

    python3 chip_stage_timing.py [--reps 50] [--cluster 0]

Featurizes random_cluster(0, 5000 nodes, 10000 pods, bound_fraction=0)
(6144 padded nodes, the whole default profile in one launch per stage,
exact mode, as chip_smoke.py phase 11 (d) (iv)) and times E1 and E2 over
the first pod (the scan's shape) and over the first 256 pods (a chunk's):
each stage's kernel time from CUPTI's kernel records in a torch.profiler
trace of ``--reps`` calls (after one untraced call), without the host's
time between launches.  Where the tree runs E1 and E2 on thread-block
clusters, ``--cluster`` forces their size (0: the launch's choice) and the
line reports what ran.  Prints one JSON line: the card (nvidia-smi name
and power limit), the tree it ran from, and the times.  Run it from the
root of the tree to time; to compare two trees, run it from each on one
card, in turns (A, B, B, A)."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
sys.path.insert(0, str(Path.cwd() / "tests"))

from helpers import random_cluster  # noqa: E402
from ksim_tpu_torch.engine.core import Engine  # noqa: E402
from ksim_tpu_torch.engine.profiles import default_plugins  # noqa: E402
from ksim_tpu_torch.engine.staged import StagedProgram  # noqa: E402
from ksim_tpu_torch.kernels import chain_stages  # noqa: E402
from ksim_tpu_torch.state.featurizer import Featurizer  # noqa: E402

MAIN = (5000, 10000)
ROWS = (1, 256)


def cupti_ms(fn, reps: int, kernel: str) -> float:
    """Mean milliseconds of one launch of the kernel whose name holds
    ``kernel``, from CUPTI's records of ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="ksim-stage-timing-") as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    durs = [float(e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel" and kernel in str(e.get("name"))]
    if len(durs) != reps:
        raise AssertionError(f"CUPTI recorded {len(durs)} launches of {kernel} in {reps} calls")
    return sum(durs) / reps / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cluster", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_stage_timing: no CUDA device", file=sys.stderr)
        return 2
    if hasattr(chain_stages, "STAGE_CLUSTER"):
        chain_stages.STAGE_CLUSTER = args.cluster
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    nodes, pods = random_cluster(0, *MAIN, bound_fraction=0.0)
    feats = Featurizer().featurize(nodes, pods)
    eng = Engine(feats, default_plugins(feats), record="selection", exact=True, device="cuda")
    staged = StagedProgram(eng._prog)
    fsub, ssub = staged.filter_groups[0].sub, staged.score_groups[0].sub
    state, aux = eng._node_state, eng._aux
    carries = eng._prog.init_carries(aux)
    out = {"card": card, "tree": str(Path.cwd()), "nodes": int(state.valid.shape[0]), "reps": args.reps}
    for B in ROWS:
        view = eng._pods.rows(0, B).view()
        ok = chain_stages.filter_stage(fsub, state, view, aux, carries)[1]
        calls = {"E1": (lambda: chain_stages.filter_stage(fsub, state, view, aux, carries), "filter_stage_kernel",
                        chain_stages.filter_stage),
                 "E2": (lambda: chain_stages.score_stage(ssub, state, view, aux, carries, ok), "score_stage_kernel",
                        chain_stages.score_stage)}
        for name, (call, kernel, wrapper) in calls.items():
            out[f"{name}_ms_{B}"] = cupti_ms(call, args.reps if B == 1 else max(1, args.reps // 10), kernel)
            out[f"{name}_ran_{B}"] = getattr(wrapper, "last", None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
