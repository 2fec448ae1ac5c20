#!/usr/bin/env python3
"""Time kernel E's stages (E1 filter, E2 score, E3 normalize, E4 select,
the scan's committing select and E4's visit window) on the card at the
main path's shape.

    python3 chip_stage_timing.py [--reps 50] [--cluster 0]

Featurizes random_cluster(0, 5000 nodes, 10000 pods, bound_fraction=0)
(6144 padded nodes, the whole default profile in one launch per stage,
exact mode, as chip_smoke.py phase 11 (d) (iv)) and times E1, E2, E3 and
E4's selection over the first pod (the scan's shape) and over the first
256 pods (a chunk's), the committing selection over the first pod (it
takes one pod; each call commits it again into a copy of the state and
carries) and the visit window over the first pod's feasible set
(sampling_k 500, the start carried from call to call): each stage's kernel time from CUPTI's kernel records in a
torch.profiler trace of ``--reps`` calls (after one untraced call),
without the host's time between launches, and its wrapper's host time
per call (calls back to back, from a synchronized card, not waiting for
the last).  Where the tree runs a stage on
thread-block clusters, ``--cluster`` forces their size (0: the launch's
choice) and the line reports what ran.  Prints one JSON line: the card (nvidia-smi name
and power limit), the tree it ran from, and the times.  Run it from the
root of the tree to time; to compare two trees, run it from each on one
card, in turns (A, B, B, A)."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
sys.path.insert(0, str(Path.cwd() / "tests"))

from helpers import random_cluster  # noqa: E402
from ksim_tpu_torch.engine.core import Engine  # noqa: E402
from ksim_tpu_torch.engine.profiles import default_plugins  # noqa: E402
from ksim_tpu_torch.engine.staged import StagedProgram  # noqa: E402
from ksim_tpu_torch.kernels import chain, chain_stages  # noqa: E402
from ksim_tpu_torch.state.featurizer import Featurizer  # noqa: E402

MAIN = (5000, 10000)
ROWS = (1, 256)
SAMPLING_K = 500


def cupti_ms(fn, reps: int, kernel: str) -> float:
    """Mean milliseconds of one launch of the kernel whose name holds
    ``kernel``, from CUPTI's records of ``reps`` calls of ``fn``.  A
    session whose trace holds other than ``reps`` records (CUPTI dropped
    one) is traced again, up to three sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
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
        if len(durs) == reps:
            return sum(durs) / reps / 1e3
    raise AssertionError(f"CUPTI recorded {len(durs)} launches of {kernel} in {reps} calls, in each of three sessions")


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds of one call of ``fn`` over ``reps`` calls back
    to back (chip_smoke.py's wrapper host time)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return ms


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
    fsub, ssub, csub = staged.filter_groups[0].sub, staged.score_groups[0].sub, staged.commit_sub
    state, aux = eng._node_state, eng._aux
    carries = eng._prog.init_carries(aux)
    N = int(state.valid.shape[0])
    n_real = len(feats.nodes.names)
    weights = torch.tensor([sp.weight for sp in eng._prog.scores], dtype=torch.int32, device="cuda")
    out = {"card": card, "tree": str(Path.cwd()), "nodes": N, "reps": args.reps}
    for B in ROWS:
        pods = eng._pods.rows(0, B)
        view = pods.view()
        ok = chain_stages.filter_stage(fsub, state, view, aux, carries)[1]
        raw = chain_stages.score_stage(ssub, state, view, aux, carries, ok)
        norm = chain_stages.normalize_stage(ssub, state, view, aux, carries, raw, ok)
        sel = {"selected": torch.empty(B, dtype=torch.int32, device="cuda"),
               "total": torch.empty((B, N), dtype=torch.int32, device="cuda"), "final": None}
        calls = {"E1": (lambda: chain_stages.filter_stage(fsub, state, view, aux, carries), "filter_stage_kernel",
                        chain_stages.filter_stage),
                 "E2": (lambda: chain_stages.score_stage(ssub, state, view, aux, carries, ok), "score_stage_kernel",
                        chain_stages.score_stage),
                 "E3": (lambda: chain_stages.normalize_stage(ssub, state, view, aux, carries, raw, ok),
                        "normalize_stage_kernel", chain_stages.normalize_stage),
                 "E4select": (lambda: chain_stages.select_stage(csub, state, pods, aux, carries, norm, weights, ok,
                                                                sel), "select_stage_kernel", chain_stages.select_stage)}
        if B == 1:
            c_state, c_carries = chain.fresh_scan_state(csub, state, carries)
            calls["E4commit"] = (lambda: chain_stages.select_stage(csub, c_state, pods, aux, c_carries, norm, weights,
                                                                   ok, sel, commit=True),
                                 "select_stage_kernel", chain_stages.select_stage)
            start = torch.zeros(1, dtype=torch.int32, device="cuda")
            calls["E4window"] = (lambda: chain_stages.window_stage(ok, start, pods.valid, n_real, SAMPLING_K),
                                 "window_stage_kernel", chain_stages.window_stage)
        for name, (call, kernel, wrapper) in calls.items():
            reps = args.reps if B == 1 else max(1, args.reps // 10)
            out[f"{name}_ms_{B}"] = cupti_ms(call, reps, kernel)
            out[f"{name}_host_ms_{B}"] = host_ms(call, reps)
            out[f"{name}_ran_{B}"] = getattr(wrapper, "last", None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
