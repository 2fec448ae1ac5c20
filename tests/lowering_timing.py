"""Host lowering time of ksim_tpu against the port, on one CPU.

    JAX_PLATFORMS=cpu python -m tests.lowering_timing [--events 6000] [--rounds 2]

Runs the churn lock stream (seed 0, 2000 nodes, 100 operations per step,
K = 16, f32, ``max_pods_per_pass=1024``, ``pod_bucket_min=128``) through
each package's device replay path on the CPU, in turns (ksim_tpu, port,
port, ksim_tpu, ...), and reads each run's ``replay.lower`` span total
(the segment lowering: ``ReplayDriver.prepare_segment`` around ``_lower``,
the same code in both) and its count.  Prints one JSON line.  A host-code
comparison: the kernels run on the CPU here (XLA for ksim_tpu, the plain
PyTorch version for the port) and their times are not reported.
"""

from __future__ import annotations

import argparse
import json
import platform
import time

import jax
import torch


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def _run(package: str, n_events: int) -> dict:
    kw = dict(max_pods_per_pass=1024, pod_bucket_min=128, device_replay=True, device_segment_steps=16)
    if package == "ksim_tpu":
        from ksim_tpu.scenario import ScenarioRunner, churn_scenario

        jax.config.update("jax_enable_x64", False)
        runner = ScenarioRunner(**kw)
    else:
        from ksim_tpu_torch.scenario.generate import churn_scenario
        from ksim_tpu_torch.scenario.runner import ScenarioRunner

        runner = ScenarioRunner(**kw, exact=False, device="cpu")
    ops = list(churn_scenario(0, n_nodes=2000, n_events=n_events, ops_per_step=100))
    t = time.perf_counter()
    res = runner.run(ops)
    wall = time.perf_counter() - t
    drv = runner.replay_driver
    return {
        "package": package,
        "counts": [res.pods_scheduled, res.unschedulable_attempts],
        "lower_s": res.phase_seconds.get("replay.lower"),
        "lowerings": res.phase_counts.get("replay.lower"),
        "prelower_s": res.phase_seconds.get("replay.prelower"),
        "device_steps": drv.device_steps,
        "wall_s": wall,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--events", type=int, default=6000)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    order = []
    for r in range(args.rounds):
        order += ["ksim_tpu", "ksim_tpu_torch"] if r % 2 == 0 else ["ksim_tpu_torch", "ksim_tpu"]
    runs = [_run(p, args.events) for p in order]
    print(json.dumps({"cpu": _cpu_model(), "torch_threads": 1, "events": args.events, "runs": runs}))


if __name__ == "__main__":
    main()
