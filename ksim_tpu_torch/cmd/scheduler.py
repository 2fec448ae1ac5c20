"""Debuggable-scheduler entrypoint (reference simulator/cmd/scheduler/
scheduler.go:17-28 + pkg/debuggablescheduler NewSchedulerCommand): run the
batch-evaluating scheduler standalone over a snapshot, printing the
recorded results — the library analogue of pointing the scheduler binary
at a cluster with ``--config``.

Run: ``python -m ksim_tpu_torch.cmd.scheduler --snapshot snap.json
[--config scheduler.yaml] [--watch] [--device cuda|cpu]`` (or the
``ksim-torch-scheduler`` script).  Out-of-tree plugins register through
ksim_tpu_torch.scheduler.profile.Builder registries in library use (the
WithPlugin analogue).

The port of ``ksim_tpu/cmd/scheduler.py``.  The pass runs on the CUDA
card (kernels A, B and C); ``--device cpu`` runs the plain PyTorch
versions.  Without a card and without ``--device cpu`` the service
refuses to start."""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading

from ksim_tpu_torch.cmd import add_device_argument

logger = logging.getLogger(__name__)


def run_scheduler(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="ksim-torch-scheduler")
    ap.add_argument("--snapshot", required=True, help="reference-format snapshot JSON")
    ap.add_argument("--config", default=None, help="KubeSchedulerConfiguration yaml")
    ap.add_argument(
        "--watch",
        action="store_true",
        help="keep running and schedule on cluster events (default: one pass)",
    )
    ap.add_argument("--out", default="-", help="write the result snapshot here")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )

    import yaml

    from ksim_tpu_torch.scheduler.service import SchedulerService
    from ksim_tpu_torch.state.cluster import ClusterStore
    from ksim_tpu_torch.state.snapshot import SnapshotService

    sched_cfg = None
    if args.config:
        with open(args.config) as f:
            sched_cfg = yaml.safe_load(f) or {}

    store = ClusterStore()
    service = SchedulerService(store, config=sched_cfg, device=args.device)
    snap = SnapshotService(store, scheduler_service=service)
    with open(args.snapshot) as f:
        snap.load(json.load(f), ignore_scheduler_configuration=args.config is not None)

    if args.watch:
        service.start()
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        stop.wait()
        service.stop(timeout=None)  # process exit: join the loop for real
    else:
        placements = service.schedule_pending()
        scheduled = sum(1 for v in placements.values() if v)
        logger.info(
            "scheduled %d/%d pods", scheduled, len(placements)
        )
    out = snap.export_json()
    if args.out == "-":
        print(out)
    else:
        with open(args.out, "w") as f:
            f.write(out)
    return 0


def main() -> None:
    sys.exit(run_scheduler())


if __name__ == "__main__":
    main()
