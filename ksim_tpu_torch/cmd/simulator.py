"""Simulator server entrypoint (reference simulator/cmd/simulator/
simulator.go:35-136): load config, wire the DI container, optionally
one-shot-import or continuously sync an external snapshot source, start
the scheduler watch loop and the HTTP server, then wait for SIGTERM.

Run: ``python -m ksim_tpu_torch.cmd.simulator [--config config.yaml]
[--device cuda|cpu]`` (or the ``ksim-torch-simulator`` console script).

The port of ``ksim_tpu/cmd/simulator.py``, with these differences:

- ``--device`` (default ``cuda``) goes to the DI container: the watch
  loop's passes run kernels A, B and C on the card, or the plain PyTorch
  versions with ``--device cpu``.  Without a card and without that flag
  the scheduler service refuses to start.
- No compilation-cache setup: the port's persistent cache is the hashed
  kernel library that ``kernels/build.py`` writes at first use.
- ``KSIM_AOT_PREWARM=1`` or ``2`` loads, on a daemon thread, every kernel
  library already built (``engine/replay.py prewarm_aot_cache``).  Mode 2
  loads once, as mode 1 does: the port has one library per source for
  every shape, so there are no per-rung executables to rescan.
- ``--profile-dir`` starts the service's ``torch.profiler`` hooks: the
  scheduling passes' Chrome trace (TensorBoard's trace format) is written
  there when the server stops.
- The tenant job plane (``/api/v1/jobs``, jobs/manager.py) runs its
  jobs on the same ``--device``.  Its knobs reach the server through
  the environment alone, read when the DI container builds the
  ``JobManager``: eagerly at startup when ``KSIM_JOBS_DIR`` is set (the
  journal is replayed before the first request; ``KSIM_JOBS_RESUME=1``
  re-runs interrupted jobs from their newest checkpoint), else at the
  first job request.  ``KSIM_JOBS_WORKERS``, ``KSIM_JOBS_QUEUE``,
  ``KSIM_JOBS_CHECKPOINT_EVERY`` and the rest are listed in the
  manager's docstring; ``KSIM_WORKERS_ROLE=frontdoor`` makes this server
  the front door of a fleet of ``python -m ksim_tpu_torch.jobs``
  workers sharing ``KSIM_JOBS_DIR``."""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading

from ksim_tpu_torch.cmd import add_device_argument

logger = logging.getLogger(__name__)


def start_simulator(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="ksim-torch-simulator")
    ap.add_argument("--config", default=None, help="SimulatorConfiguration yaml")
    ap.add_argument("--port", type=int, default=None, help="override the port")
    ap.add_argument("--host", default=None, help="bind address (0.0.0.0 for containers)")
    ap.add_argument(
        "--profile-dir",
        default=None,
        help="write a torch.profiler Chrome trace (TensorBoard's trace "
        "format) of the scheduling passes to this directory",
    )
    add_device_argument(ap)
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )

    from ksim_tpu_torch.config import load_config
    from ksim_tpu_torch.oneshotimporter import OneShotImporter
    from ksim_tpu_torch.server import DIContainer, SimulatorServer
    from ksim_tpu_torch.state.cluster import ClusterStore
    from ksim_tpu_torch.state.snapshot import SnapshotService
    from ksim_tpu_torch.syncer import Syncer

    cfg = load_config(args.config)
    if args.port is not None:
        cfg.port = args.port
    if args.host is not None:
        cfg.host = args.host

    di = DIContainer(
        scheduler_config=cfg.initial_scheduler_cfg,
        scheduler_config_path=cfg.kube_scheduler_config_path or None,
        device=args.device,
    )

    syncer = None
    kube_source = None
    if cfg.external_import_enabled or cfg.resource_sync_enabled:
        if cfg.kube_config:
            # Live kube-apiserver source (reference cmd/simulator/
            # simulator.go:59-71 builds external clients from kubeConfig).
            from ksim_tpu_torch.syncer.kubeapi import KubeApiSource

            kube_source = KubeApiSource.from_kubeconfig(cfg.kube_config)
            export_side: object = kube_source
            sync_source: object = kube_source
        else:
            # Static snapshot-file source.
            with open(cfg.external_snapshot_path) as f:
                snap_data = json.load(f)
            file_store = ClusterStore()
            SnapshotService(file_store).load(snap_data, ignore_err=True)
            export_side = SnapshotService(file_store)
            sync_source = file_store
        if cfg.external_import_enabled:
            OneShotImporter(di.snapshot_service, export_side).import_cluster_resources(
                cfg.resource_import_label_selector
            )
        else:
            syncer = Syncer(sync_source, di.store).run()

    writeback = None
    from ksim_tpu_torch.syncer.writeback import LiveWriteBack, writeback_enabled

    if writeback_enabled():
        if kube_source is not None and syncer is not None:
            # Opt-in live scheduling: push binds + result annotations back
            # to the real cluster (the reference's debuggable-scheduler
            # promise, docs/debuggable-scheduler.md:64).
            writeback = LiveWriteBack(kube_source, di.store).start()
            di.scheduler_service.add_eviction_listener(writeback.note_eviction)
            logger.info("live write-back enabled (KSIM_ALLOW_LIVE_WRITEBACK=1)")
        else:
            # Continuous sync only: one-shot import leaves a frozen
            # snapshot, and binding a live cluster from stale state would
            # race every real controller on it.  Say so loudly — a user
            # who set the flag would otherwise only learn from the
            # cluster staying untouched.
            logger.warning(
                "KSIM_ALLOW_LIVE_WRITEBACK=1 ignored: write-back needs "
                "continuous kube sync (resourceSyncEnabled + kubeConfig), "
                "not one-shot import or a snapshot file"
            )

    if os.environ.get("KSIM_AOT_PREWARM") in ("1", "2"):
        # Load-only warm start: every kernel library already on disk
        # (engine/replay.py prewarm_aot_cache never builds one).  Daemon
        # thread: a slow first touch of the card must never block server
        # startup.
        from ksim_tpu_torch.engine.replay import prewarm_aot_cache

        threading.Thread(target=prewarm_aot_cache, name="aot-prewarm", daemon=True).start()

    if args.profile_dir:
        di.scheduler_service.start_profiling(args.profile_dir)
    di.scheduler_service.start()
    server = SimulatorServer(
        di,
        host=cfg.host,
        port=cfg.port,
        cors_allowed_origins=cfg.cors_allowed_origin_list,
    ).start()
    logger.info("simulator server started on :%d", server.port)

    stop = threading.Event()

    def on_signal(signum, frame):
        logger.info("signal %s: shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    try:
        stop.wait()
    finally:
        server.shutdown_server()
        di.scheduler_service.stop_profiling()
        if writeback is not None:
            writeback.stop()
        if syncer is not None:
            syncer.stop()
        if kube_source is not None:
            kube_source.close()
        di.shutdown(timeout=None)  # process exit: join the loop for real
    return 0


def main() -> None:
    sys.exit(start_simulator())


if __name__ == "__main__":
    main()
