#!/usr/bin/env python3
"""Drive ksim_tpu_torch's scheduling path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name, count and power limit;
2. build: nvcc builds every kernel from ksim_tpu_torch/csrc, one process
   per source, all at once (seconds and ptxas register / shared-memory
   lines); kernel D's, the longest, is waited for only before phase 6;
3. kernel vs plain: on random_cluster(0, 512 nodes, 128 pods), a cluster
   with images and host ports, a spread/affinity-heavy cluster and a
   volume cluster, kernels A (schedule_scan) and B (batch_eval) equal
   their plain PyTorch versions element for element (record modes full,
   final, selection; exact and f32 modes); kernel C (schedule_sampled)
   likewise for a few k and start values.  The plain versions run once
   per cluster and mode, record="full", and each record mode of the
   kernels is held against the fields it records;
4. main path at full width: random_cluster(0, 5000 nodes, 10000 pods,
   bound_fraction=0), padded by the featurizer to 12288 x 6144, with the
   whole default profile (14 plugins): featurize -> Engine(record=
   "selection").schedule() on the card, evaluate_batch_fused(record=
   "final"), evaluate_batch(record="full") and a record="full" schedule
   on the first 2048 pods, the 13 annotations of a few pods, and the
   sampled pass (sampling_k=500, upstream's adaptive percentageOfNodes-
   ToScore at 5000 nodes) over the whole queue and, record="full", over
   the first 2048 pods.  The kernels' launch counts are read around
   exactly that; then the results are held against the plain versions
   and the commit invariant: kernel A's record="full" 2048-pod pass
   against the plain scan over its first 512 pods on the card (timed),
   its whole-queue pass against those and against the plain scan over
   the whole queue on the CPU (selections and final node state: a child
   process, `--plain-queue`, started after phase 2 on two cores beside
   phases 3-9, no CUDA context; its result and the pairs it counted,
   for A's bound, are read at the end, its inputs' digest held equal to
   the main path's), kernel C's 2048-pod full-record pass and its whole
   queue against the plain sampled scan over the first 512 pods (a
   sequential scan's prefix is the whole run's prefix; a plain scan
   takes 15-19 ms a pod on the card).  Kernels A and C run on one
   thread-block cluster whose size the launch picks (16 blocks where the
   card has room, else 8); the main path must get at least 8;
5. timings with CUDA events, beside each kernel's bound.  Kernels A and C
   at clusters of 8 and of 16 blocks, each size held equal again (A's
   whole queue to the main path's launch, C's 2048-pod full-record pass
   to the main path's and, with its whole queue, to the plain version on
   their first 512 pods) and timed, with the microseconds per real pod,
   the cluster barriers per evaluated pod and block 0's cycles by phase
   of a pod (counted by the kernel).  Each kernel's ms, plain_ms and
   bound_ms are taken on one shape: A over the whole queue (selection;
   its plain_ms over the first 512 pods, record="full", "plain_shape"),
   B fused over the whole queue (final), C on the 2048-pod full-record
   pass; C's whole-queue selection time is printed on its own line and
   kept as the kernel's "queue_ms", beside its bound ("queue_bound_ms")
   from the visit windows the queue needs, read off a rerun of the queue
   one pod per launch.  Kernel B (a pre-pass over the nodes, then a
   persistent grid over the pods) reports its blocks per SM (the
   occupancy query; at least 4 at 6144 nodes, or the resource that stops
   it and by how much), registers, local memory and shared memory per
   block, block 0's cycle share per phase of a pod, and its pre-pass
   (node_summary) is timed alone against its plain version;
6. churn replay, the whole default profile: ScenarioRunner on
   churn_scenario(0, 2000 nodes, 6000 events, 100 ops per step) must give
   the behavior lock (6430 events, 2524 scheduled, 471 unschedulable) on
   the per-pass path (kernel A per step) and on the device-resident path
   (kernel D, 16 steps per launch, device_steps >= 32; its launch count,
   and the runs of row 6 inside it, which the kernel counts on the card,
   are read around that run), in f32 and exact modes; kernel D equals its
   plain version on the f32 run's fullest segment (every output and the
   final state) and on the first segment of the exact run, and row 6's
   standalone entry (derive_interpod) equals its plain version on the
   first segment's state; then the 50k flagship (52781 / 42829) through
   kernel D, its host and kernel time apart, D's time on that run's
   fullest segment, and D on the segment of its widest pod-row shape with
   the fewest attempts against its plain version, timed beside its
   bound.  D's and derive_interpod's
   ms, plain ms and bound are taken on one segment of the 6k f32 run.
   Kernel D runs each lane on a thread-block cluster (16 blocks where the
   card has room, else 8; the main path must get at least 8): its row
   carries the cluster, the threads per block, the cluster barriers per
   attempt and block 0's cycle share by phase of a step, counted on the
   card, and D's time at clusters of 8 and 16 blocks;
7. fleet replay (rows 10-11): ScenarioRunner(fleet=8, device_replay=True,
   preemption=True) on the 6k stream, in both cohort modes (dedupe: the
   leader's solo kernel-D launch fanned out; vmap, KSIM_FLEET_VMAP=1: one
   launch of 8 blocks, replay_segment_fleet).  Every lane lands the lock
   with step triples equal to phase 6's solo device run, and only the
   leader lowers.  The vmap leg's launch counts (and row 6's runs, 8 per
   active step) are read around it; its fullest launch equals, lane by
   lane, the solo kernel-D launch on the same inputs, and a 1-lane fleet
   launch of that segment equals replay_segment_fleet_plain.  Rows
   10-11's ms and bound are the 8-lane launch's, its plain ms the 1-lane
   plain version's on that segment; the row carries the cluster size the
   occupancy query chose for 8 lanes;
8. kernel D completed (record="full", the on-device victim search): the
   hand-derived preemption fixtures (tests/fixtures/preemption_victims.py)
   and a priority-strata churn on the device path equal the per-pass path
   (nominations, victims in order, steps, store), record="full"
   annotations of a 24-node churn equal the per-pass path's, and kernel D
   equals its plain version on every segment of those runs; D's time in
   its preemption + full-record form is taken on the strata churn's
   fullest searching segment.  Then a preemption-heavy churn at 2000
   nodes (tests/test_torch_gpu_replay.py preemption_churn_stream, 2 waves
   of preempting arrivals) on the
   device path equals the per-pass path (steps, store with nominations,
   evictions in order), at least one device segment's kernel D nominated,
   that segment equals D's plain version, and the count of windows the
   search's bounds sent per-pass (preemption_overflow) is reported;
9. the chain past its old caps: on tests/test_torch_clusters.py
   wide_cluster with every profile table past its old fixed width (9 Fit
   resources on a 17-point RequestedToCapacityRatio shape, 9 Balanced
   resources, 17 attach pools, 17 spread keys, 9 constraints on one pod)
   and EBSLimits and GCEPDLimits beside NodeVolumeLimits, kernels A, B
   and C equal their plain versions (exact and f32), and kernel D equals
   its plain version on every segment of a churn with that profile
   compiled from a KubeSchedulerConfiguration, the run equal to the
   per-pass path's; then kernel B at a padded node axis of 24,576 (past
   the old one-block bound of about 17,590) equals its plain version;
10. the replay executor and streaming trace ingest.  Phase 6's device
   runs go through the pipelined executor (the dispatch on a watchdogged
   worker, the next window pre-parsed meanwhile, device-buffer reuse):
   each prints the prelower's consumed and discarded windows, the seconds
   of prelower inside the worker's dispatch intervals (from the trace
   spans), the lower / dispatch / reconcile split, the reused and sent
   constant tensors and the bytes sent per window.  Phase 10 then runs
   the 6k lock with KSIM_REPLAY_DEV_CACHE=0 and =1 (equal step triples;
   every constant tensor a launch read unchanged after the run), with a
   2 s watchdog over a first dispatch that hangs 4 s (one timeout, the
   head step per-pass, the locks, kernel D equal to its plain version on
   the leg's launch of fewest attempts), and with every dispatch failing (the breaker
   opens after 3, the rest per-pass, the locks); then a synthetic Borg
   trace (bench.py's streaming generator, seed 0) compiled onto 2000
   nodes, 20,000 events at 100 per step, replayed streamed through
   ScenarioRunner(device_replay=True) and materialized (equal steps, no
   per-pass step), and tests/fixtures/traces/borg_mini.jsonl at 24 nodes
   (126 events, 56 scheduled, 19 unschedulable) streamed and
   materialized;
11. the extension surface: (a) phase 4's cluster with the default
   profile plus NodeNumber (weight 1) and a DataProviderScore "Renewable"
   (weight 2, scores 0-100 from --seed) through kernels A, C (whole
   queue, selection) and B (fused, and the 2048-pod full chunk), each
   against its plain version (A and C on a 512-pod full-record prefix and
   the whole queue's selections on it), timed beside this run's default
   profile and the baseline's (the tree before the samples' rows), the
   default profile held within 5% of the baseline at a 700 W limit; (b)
   the 6k churn with NodeNumber through kernel D against the per-pass
   path (steps, store, nominations), D on one segment against its plain
   version and timed on the fullest, and one 8-lane vmap fleet leg equal
   to the solo run; (c) a webhook
   extender served on 127.0.0.1 (2000 nodes, 64 pods) through the
   service, equal to the CPU run, with the per-pod split; (d) hooked
   profiles through kernel E's stages (the "staged" route, no launch of
   A-D; (i)-(iii) run beside phase 12, (iv) after it): (i) identity
   hooks on all six device fields of every default plugin, phase 4's
   whole queue (selection) equal to kernel A's
   selections there; (ii) the hooked profile of tests/test_torch_hooks.py
   (test_torch_clusters.torch_hooks) through the scan and the sampled
   scan on the 512-pod full-record prefix, the 2048-pod full-record chunk
   and the fused batch (final) over the whole queue, each equal to the
   same profile through kernel E's plain versions, and E1-E4 each against
   its plain version on 256 pods; (iii) one SchedulerService pass with
   that profile (2000 x 256) equal to its CPU run; (iv) E1, E2, E3 and
   E4's selection (each pod row on a thread-block cluster) against their
   plain versions at one pod of the scan and at 256 pods, at the cluster
   size the launch picks there and at a forced size of 1, the committing
   selection at one pod on a copy of the state, and each stage's kernel
   time (CUPTI) at one pod and at 256 pods beside its wrapper's host
   time, its plain version and its bound (the bytes of its own rows'
   tables), the committing selection's at one pod, the cluster stages'
   also at a forced cluster of one block, the launches per pod,
   and (i)'s wall beside kernel A's; then a torch.profiler trace of (i)'s
   first TRACE_PODS pods: the card's busy ms and idle share beside the
   wall per pod; (e) a profiled pass whose trace names the pass and kernel A's launch, its profile holding
   the lifecycle samples (FifoSort, NamePrefixGate, PlacementExport);
12. the front door: the port's commands as processes on the card, on
   random_cluster(0, 200 nodes, 1000 pods, bound_fraction=0) (BASELINE.json
   config 2's shape, the whole default profile, record="full"; the
   export is about 235 MB of JSON): (a) `python -m
   ksim_tpu_torch.cmd.scheduler` writes the same bytes as its `--device
   cpu` run; (b) `python -m ksim_tpu_torch.cmd.simulator` with the
   snapshot one-shot imported before its loop starts: after the first
   pass every pod's node and first attempt's result annotations equal
   (a)'s, `PUT /api/v1/reset` answers 202 and re-exports the boot state,
   and SIGTERM ends it with exit 0; (c) (b) under KSIM_PNTS_EMULATION=1
   (kernel C, k = 100) against cmd.scheduler's CPU run under the same
   env; (d) (b) with a KubeSchedulerConfiguration naming one webhook
   extender served here (kernel B pod by pod) against the CPU run; (e)
   `python -m ksim_tpu_torch.cmd.simulation` on the 6k churn (inline,
   per-pass) ends Succeeded with the lock; (f) the servers of (b)-(d) run
   with `--profile-dir`, and each trace holds the card's launches of A, C
   and B respectively, with the card's kernel, copy and busy time and its
   idle share.  The three `--device cpu` runs start after phase 2, on the
   last two CPU cores beside phases 3-4; (a) and (e) run one at a time,
   unprofiled (the commands' front-door walls); (b)-(d) run at once, each
   on its own cores (a correctness run under load), with phase 13
   beside them; phase 11 (d)'s legs run in this process the whole time;
13. the job plane: the simulator as a process on the card with
   KSIM_JOBS_DIR (a fresh directory) and KSIM_JOBS_CHECKPOINT_EVERY=1,
   its torch.profiler on: (a) the 6k churn document (seed 0, 2000 nodes,
   100 operations per step) POSTed to /api/v1/jobs with deviceReplay:
   true, its SSE stream followed to the end, its result Succeeded with
   the lock 6430 / 2524 / 471; (b) the same document with fleet: 2
   (KSIM_FLEET_VMAP=1: kernel D's lanes entry), each lane [2524, 471];
   SIGTERM, and the server's trace holds replay_segment and
   replay_segment_fleet launches; (c) a second server on the same
   directory takes the (a) document again; once the journal holds the job's
   first checkpoint record it is SIGKILLed (its KSIM_JOBS_FAULTS holds
   that job's first two dispatches 3 s each, so the kill lands while the
   second waits), and a third, with KSIM_JOBS_RESUME=1, resumes the job
   from that checkpoint (fromSegment >= 1, fewer than 6430 events
   replayed, on kernel D) to the same lock, and serves (a)'s result as
   the first server did (equal in canonical JSON: the journal stores
   sorted keys) and byte for byte as the second did.  Phase 13 runs at
   the same time as phase 12's (b)-(d), each leg on two cores of its own.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors, times and bounds (each with
its phase-11 numbers, all measured in this run, under "phase_11").
"""

from __future__ import annotations

import atexit
import dataclasses
import hashlib
import http.client
import json
import os
import random
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

import ksim_tpu_torch.engine.replay as replay_mod
import ksim_tpu_torch.kernels.replay_segment as segment_mod
from ksim_tpu_torch.engine.annotations import ALL_RESULT_KEYS, RESULT_HISTORY_KEY, RenderCtx, render_pod_results
from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.engine.staged import StagedProgram
from ksim_tpu_torch.kernels import build, chain, chain_stages
import ksim_tpu_torch.engine.core as port_core
import ksim_tpu_torch.kernels.batch_eval as batch_mod
import ksim_tpu_torch.plugins.noderesources as port_res
import ksim_tpu_torch.plugins.volumes as port_vol
from ksim_tpu_torch.kernels.batch_eval import batch_eval, batch_eval_plain, node_summary, node_summary_plain
from ksim_tpu_torch.kernels.replay_segment import (
    derive_interpod,
    derive_interpod_plain,
    derive_layout,
    derive_runs,
    replay_segment,
    replay_segment_fleet,
    replay_segment_fleet_plain,
    replay_segment_plain,
    reset_derive_runs,
)
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled, schedule_sampled_plain
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan, schedule_scan_plain
from ksim_tpu_torch.faults import FAULTS
from ksim_tpu_torch.obs import TRACE
from ksim_tpu_torch.plugins.samples import (
    data_provider_builder,
    encode_node_number,
    node_number_builder,
    provider_encoder,
)
from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scenario.runner import Operation, ScenarioRunner
from ksim_tpu_torch.scenario.spec import spec_from_operations
from ksim_tpu_torch.scheduler.extender import EXTENDER_FILTER_RESULT_KEY
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import ClusterStore
from ksim_tpu_torch.state.featurizer import Featurizer
from ksim_tpu_torch.state.snapshot import SnapshotService
from ksim_tpu_torch.traces import stream_trace_operations, trace_operations

# The cluster builders live in tests/ (stdlib only).  They are imported
# from that directory, not as the package ``tests``: an installed package
# of that name can shadow it.
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from fixtures.preemption_victims import CASES as PREEMPTION_CASES  # noqa: E402
from helpers import random_cluster  # noqa: E402
from test_torch_clusters import (  # noqa: E402
    hooked_profile,
    identity_hooks,
    images_ports_cluster,
    spread_affinity_cluster,
    torch_hooks,
    volume_cluster,
    wide_cluster,
    wide_profile,
)
from test_torch_gpu_replay import (  # noqa: E402
    case_objects,
    preemption_churn_stream,
    priority_strata_stream,
    store_view,
    wide_runner,
    wide_stream,
)

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM
# bandwidth, and the float32 rate outside the tensor cores, which this
# script charges every scalar integer or float operation against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

RESULT_FIELDS = ("selected", "total", "final_scores", "reason_bits", "scores", "visited")
# The result fields each record mode keeps (engine/core.py pod_outputs).
RECORDED = {
    "selection": ("selected",),
    "final": ("selected", "total", "final_scores"),
    "full": RESULT_FIELDS,
}
DEVICE = "cuda"
# Shapes: phase 3's clusters, the main path, its full-record prefix, the
# sampled pass's k (numFeasibleNodesToFind at 5000 nodes: 10%).
SMALL = (512, 128)
MAIN = (5000, 10000)
PREFIX = 2048
# The pods of the full-record pass that kernels A's and C's plain versions
# run on the card (a plain scan is a Python loop of about 15-19 ms a pod
# there); kernel A's whole queue is held on the CPU besides.
PLAIN_PREFIX = 512
SAMPLING_K = 500
# Phase 5: the cluster sizes timed for kernels A and C.
CLUSTER_SIZES = (8, 16)
# The churn replay: the behavior locks (seed 0, 2000 nodes, 100 ops per
# step), events -> (events applied, scheduled, unschedulable).
CHURN_NODES = 2000
CHURN_LOCKS = {6000: (6430, 2524, 471), 50_000: (None, 52781, 42829)}
SEGMENT_K = 16
# ksim_tpu's own device lock asks the kernel to carry at least this many
# of the 6k run's 41 steps (tests/test_replay_device.py).
MIN_DEVICE_STEPS = 32
# Phase 6: the cluster sizes kernel D is timed at.
D_CLUSTER_SIZES = (8, 16)
# Phase 7: the fleet's lanes, and the lanes of the plain comparison (a
# plain lane of the fullest segment takes about 20 s on the card; every
# lane is held against the solo kernel besides).
FLEET_LANES = 8
FLEET_PLAIN_LANES = 1
# Phase 8: the preemption-heavy churn's node count.
PREEMPT_NODES = 2000
# Its waves of preempting arrivals (tests/test_torch_gpu_replay.py
# preemption_churn_stream; 8 there): the per-pass leg's host
# DefaultPreemption sets the phase's time.  Wave 0 preempts.
PREEMPT_WAVES = 2

# Each kernel: its source, the ksim_tpu function it replaces, and the
# rows of PERF.md's table of ksim_tpu's 11 device programs it carries.
KERNELS = {
    "schedule_scan": ("ksim_tpu_torch/csrc/schedule_scan.cu", "ksim_tpu/engine/core.py:790", (1,)),
    "batch_eval": ("ksim_tpu_torch/csrc/batch_eval.cu", "ksim_tpu/engine/core.py:670", (2, 3, 4)),
    # Kernel B's pre-pass: a kernel every B launch runs once.
    "node_summary": ("ksim_tpu_torch/csrc/batch_eval.cu", "ksim_tpu/engine/core.py:670", (3, 4)),
    "schedule_sampled": ("ksim_tpu_torch/csrc/schedule_sampled.cu", "ksim_tpu/engine/core.py:750", (5,)),
    "replay_segment": ("ksim_tpu_torch/csrc/replay_segment.cu", "ksim_tpu/engine/replay.py:492", (7, 8, 9)),
    "derive_interpod": ("ksim_tpu_torch/csrc/derive_interpod.cuh", "ksim_tpu/engine/replay.py:459", (6,)),
    "replay_segment_fleet": ("ksim_tpu_torch/csrc/replay_segment.cu", "ksim_tpu/engine/replay.py:1244", (10, 11)),
    # Kernel E, the staged route of hooked and kernel-less profiles (phase
    # 11 (d)): its stages stand for rows 1-5 of such a profile; each names
    # the program its main leg (the scan) replaces.
    "chain_filter": ("ksim_tpu_torch/csrc/chain_stages.cu", "ksim_tpu/engine/core.py:790", (1, 2, 3, 4, 5)),
    "chain_score": ("ksim_tpu_torch/csrc/chain_stages.cu", "ksim_tpu/engine/core.py:790", (1, 2, 3, 4, 5)),
    "chain_normalize": ("ksim_tpu_torch/csrc/chain_stages.cu", "ksim_tpu/engine/core.py:790", (1, 2, 3, 4, 5)),
    "chain_window": ("ksim_tpu_torch/csrc/chain_stages.cu", "ksim_tpu/engine/core.py:750", (5,)),
    "chain_select": ("ksim_tpu_torch/csrc/chain_stages.cu", "ksim_tpu/engine/core.py:790", (1, 2, 3, 4, 5)),
}
# Kernel E's entries in the kernels line, by stage (kernels/chain_stages.py
# launches()): E1 filter, E2 score, E3 normalize, E4 window and select,
# each running a pod row on a thread-block cluster.
STAGE_KERNELS = {"chain_filter": "filter", "chain_score": "score", "chain_normalize": "normalize",
                 "chain_window": "window", "chain_select": "select"}
# Phase 11 (d): the pods of kernel E's stage-by-stage comparison, and the
# launches per timing of a stage at the scan's shape (one pod).
STAGE_BLOCK = 256
STAGE_REPS = 50
# Phase 11 (d): the pods of (i)'s traced stretch.
TRACE_PODS = 256
WRAPPERS = {"schedule_scan": schedule_scan, "batch_eval": batch_eval, "schedule_sampled": schedule_sampled,
            "node_summary": node_summary}
# Phase 9: kernel B past the old one-block node bound (padded to 24,576).
WIDE_NODES = 20_000
# Phase 10: the watchdog leg (a first dispatch hanging HANG_S against a
# WATCHDOG_S watchdog), and the streamed synthetic Borg trace.
WATCHDOG_S, HANG_S = 2, 4
STREAM_RECORDS, STREAM_EVENTS, STREAM_NODES = 12_000, 20_000, 2000
BORG_MINI = "tests/fixtures/traces/borg_mini.jsonl"
BORG_MINI_LOCK = (126, 56, 19)
# Phase 11: kernels A and C with the samples against their plain versions
# on this full-record prefix of the queue (B on PREFIX), and (d) the hooked
# profile's scans on it; the extender run (2000 nodes, 64 pending pods),
# (d)'s hooked service pass (2000 x 256) and the profiled pass (500 nodes,
# 64 pods).
SAMPLES_PREFIX = 512
# Launches per CUDA-event timing of kernel B (2-10 ms per launch): the
# host's first launch after the start event (building its params) is
# then a small share of the mean, where 3 launches left it at several
# percent.
B_REPS = 20
EXT_SHAPE = (2000, 64)
HOOK_SHAPE = (2000, 256)
PROFILED_SHAPE = (500, 64)
# The baseline, on the tree before the samples' rows (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md section 6), each measured as this script
# measures it: A, C's whole queue (2 launches) and kernel D's fullest 6k
# segment from this script's final run there; B fused and its 2048-pod
# chunk over B_REPS launches, the mean of that tree's two runs of
# `chip_scan_timing.py --reps 20` in one call beside this tree's.
BASELINE_MS = {"A": 382.56, "C queue": 415.87, "B fused": 9.764, "B chunk": 2.144, "D": 48.31}
# The default profile's times may be at most this share over the
# baseline's, at the baseline's power limit: a row the samples skip costs
# nothing.
BASELINE_TOLERANCE, BASELINE_POWER_W = 0.05, 700.0
# Phase 12: the front door, the port's commands run as processes on the
# card: BASELINE.json config 2's shape (200 nodes, 1000 pods) with the
# whole default profile, record="full".  A wait on one of its processes
# lasts at most FRONT_WAIT_S.
FRONT_SHAPE = (200, 1000)
FRONT_WAIT_S = 300
FRONT_KERNELS = {"A": "cluster_scan_kernel<false", "C": "cluster_scan_kernel<true", "B": "batch_eval_kernel"}
FRONT_PNTS = {"KSIM_PNTS_EMULATION": "1"}
# Phase 13: kernel D's two entries by their names in a CUDA trace.
JOB_KERNELS = {"D": "replay_segment_kernel", "D lanes": "replay_segment_lanes_kernel"}
JOB_WAIT_S = 240


class PlainEngine(Engine):
    """The same engine running the kernels' plain versions."""

    _scan_fn = staticmethod(schedule_scan_plain)
    _sampled_fn = staticmethod(schedule_sampled_plain)
    _batch_fn = staticmethod(batch_eval_plain)
    _stages = chain_stages.PLAIN_STAGES


class Check:
    """Exact comparisons of kernel results with plain results; records
    the largest absolute difference seen per kernel."""

    def __init__(self) -> None:
        self.max_err = {name: 0 for name in KERNELS}

    def equal(self, kernel: str, what: str, got: np.ndarray, want: np.ndarray) -> None:
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{what}: {got.dtype}{got.shape} vs {want.dtype}{want.shape}")
        err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0))
        self.max_err[kernel] = max(self.max_err[kernel], err)
        if err:
            raise AssertionError(f"{what}: kernel differs from plain (max |diff| {err})")

    def results(self, kernel: str, what: str, got, want, record: str = "full", rows: "int | None" = None) -> None:
        """``got`` (kernel, record mode ``record``) against ``want`` (plain,
        record="full" or the same mode), on the fields ``record`` keeps.
        With ``rows``, ``want`` covers only the first ``rows`` pods of
        ``got``'s scan (a sequential scan's prefix is the whole run's
        prefix), and the next start, which is the whole run's, is not
        compared."""
        for name in RESULT_FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            if rows is not None and a is not None:
                a = a[:rows]
            if name not in RECORDED[record]:
                if a is not None:
                    raise AssertionError(f"{what}.{name}: recorded outside record={record}")
                continue
            if (a is None) != (b is None):
                raise AssertionError(f"{what}.{name}: recorded by one side only")
            if a is not None:
                self.equal(kernel, f"{what}.{name}", a, b)
        if rows is None and got.sampling_next_start != want.sampling_next_start:
            raise AssertionError(
                f"{what}: next start {got.sampling_next_start} vs {want.sampling_next_start}"
            )


def same_state(kernel: str, what: str, check: Check, got, want) -> None:
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, torch.Tensor):
            b = b.cpu().numpy()
        check.equal(kernel, f"{what} state.{field}", a, b)


def host_state(state):
    """A node state's tensors pulled to numpy arrays."""
    return state._replace(**{f: getattr(state, f).cpu().numpy() for f in state._fields})


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return sum(tensor_bytes(v) for v in tree)


def pair_ops(eng: Engine) -> dict[str, float]:
    """``chain_pair_ops`` of an engine's snapshot, over its queue."""
    return chain_pair_ops(eng._aux, eng._plugins, eng._node_state.allocatable.shape[1],
                          eng._pods.valid.cpu().numpy())


def chain_pair_ops(aux: dict, plugins, R: int, valid) -> dict[str, float]:
    """Scalar operations per pod-node pair of the 14-plugin chain, from
    the kernels' arithmetic (csrc/plugin_chain.cuh) with this run's vocab
    sizes, in four parts: "filter" (every filter, and the statistics
    they need), "score" (raw scores, normalizes, total and selection),
    "commit" (the scan kernels' InterPodAffinity domain commit; batch
    evaluation commits nothing) and "sample" (kernel C's visit window).
    Each raw score is counted once, though the kernels compute the
    spread and interpod ones twice to save shared memory.  The
    data-dependent loops (required node-affinity terms, the spread and
    interpod branches, the interpod commit) are counted for the share of
    the pods of ``valid`` (a bool mask over the pod rows) that take
    them."""

    def share(mask) -> float:
        return float(np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)[valid].mean())

    W = aux["taints"]["forbidding"].shape[0]
    T = aux["affinity"]["term_size"].shape[0]
    V = aux["nodeports"]["pod_wants"].shape[1]
    I = aux["imagelocality"]["image_size"].shape[0]
    vol, sp, ip = aux["volumes"], aux["spread"], aux["interpod"]
    NPV, NC = vol["pv_node_ok"].shape[0], vol["pvc_cand_ok"].shape[0]
    VV, RW, DD = vol["pod_vol"].shape[1], vol["pod_rwop"].shape[1], vol["pod_disk_any"].shape[1]
    npools = len(next(s.plugin.pool_ids for s in plugins if s.plugin.name == "NodeVolumeLimits"))
    MC = sp["con_valid"].shape[1]
    T2, TKI = ip["dom_t"].shape[1], ip["node_dom"].shape[1]
    active_f = share((sp["con_valid"] & (sp["con_mode"] == 0)).any(dim=1))
    has_score = share(sp["has_score_con"])
    req_share = share(aux["affinity"]["has_required"])
    raff = share(ip["req_aff"].any(dim=1))
    ipa_filter = share((ip["req_aff"] | ip["req_anti"] | ip["pod_term_match"]).any(dim=1))
    ipa_score = share((ip["pref_w"] != 0).any(dim=1) | ip["pod_term_match"].any(dim=1))
    ipa_commit = share(ip["pod_term_match"].any(dim=1) | (ip["pod_vw"] != 0).any(dim=1)
                       | (ip["pod_eat"] != 0).any(dim=1))
    node_pred = 4 * W + 3 + 2 * T * req_share  # taint_block + affinity_match, once per pair
    filt = 2 + 2  # NodeUnschedulable, NodeName
    filt += node_pred  # taint filter / affinity filter
    filt += 2 * V  # port conflicts
    filt += 2 + 4 * R  # Fit filter
    filt += 2 * RW + 8 * DD  # VolumeRestrictions
    filt += npools * 3 * VV + 3  # NodeVolumeLimits
    filt += 2 * NPV + 3 * NC + 3  # VolumeBinding
    filt += 2 * NPV  # VolumeZone
    filt += active_f * (node_pred + 14 * MC + 10 * MC)  # spread filter: statistics, code
    filt += ipa_filter * 6 * T2 + raff * 2 * TKI * T2  # interpod filter
    score = 3 * W  # prefer-taint count
    score += 3 + 2 * T  # added affinity, preferred sum
    score += 2 * 8 + 2  # Fit LeastAllocated score over cpu, memory
    score += 14  # BalancedAllocation (exact, int64)
    score += I + 12  # ImageLocality sum and clamp
    score += has_score * (6 * MC + 6 * MC + 12 * MC + 8)  # registration, sums, raw, norm
    score += ipa_score * 4 * T2 + 8  # interpod raw, norm
    score += 2 * 4 + 6 + 9  # two default normalizes, total, selection key, extrema
    return {
        "filter": filt,
        "score": score,
        "commit": ipa_commit * 3 * T2,  # interpod domain commit (scan kernels)
        "sample": 10,  # window counts, prefix count, visit position
    }


class PairCount:
    """The pod-node pairs a plain version evaluates, counted while it
    runs: every real pod (index < ``n_rows``) against the nodes valid at
    that moment ("pairs"), and the feasible ones among them ("feasible"),
    the only pairs whose scores a selection needs.  It wraps the
    program's ``eval_block``, which every plain version calls once per
    pod or block of pods; the sums stay on the card until read."""

    def __init__(self, prog, n_rows: int) -> None:
        self.prog, self.n_rows = prog, n_rows
        self._pairs = torch.zeros((), dtype=torch.int64, device=DEVICE)
        self._feasible = torch.zeros((), dtype=torch.int64, device=DEVICE)

    def __enter__(self) -> "PairCount":
        evaluate = self.prog.eval_block

        def counting(state, pods, aux, carries):
            out = evaluate(state, pods, aux, carries)
            real = pods.index < self.n_rows
            self._pairs += real.sum() * state.valid.sum()
            self._feasible += (out[0] & real[:, None]).sum()
            return out

        self.prog.eval_block = counting
        return self

    def __exit__(self, *exc) -> None:
        del self.prog.eval_block  # the class's method again

    @property
    def pairs(self) -> int:
        return int(self._pairs)

    @property
    def feasible(self) -> int:
        return int(self._feasible)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sampled_queue_bound(prog, state, pods, aux, carries, start, n_real: int, whole, ops: dict, n_pods: int):
    """Kernel C's bound on the whole queue under record="selection", from
    the visit windows this run's data needs: the queue again one pod per
    launch (untimed), each pod's window read off the rotating start it
    leaves ((next - start) mod n_real nodes, all of them when it wraps
    once round), its selections held equal to the whole-queue launch's.
    The filters run on the visited pairs; the scores on k sampled feasible
    pairs where the window stopped at the k-th feasible node, and on at
    least one (the selected) where it covered every node."""
    P = pods.valid.shape[0]
    valid = pods.valid.cpu().numpy()
    visited, scored, selected = 0, 0, []
    for i in range(P):
        state, carries, nxt, out = schedule_sampled(prog, state, pods.rows(i, i + 1), aux, carries, start, n_real,
                                                    SAMPLING_K)
        sel = int(out["selected"][0])
        selected.append(sel)
        if valid[i]:
            window = (int(nxt) - int(start)) % n_real or n_real
            visited += window
            scored += SAMPLING_K if window < n_real else (1 if sel >= 0 else 0)
        start = nxt
    if not np.array_equal(np.array(selected, dtype=whole.selected.dtype), whole.selected):
        raise AssertionError("kernel C one pod per launch differs from its whole-queue launch")
    n_bytes = (tensor_bytes(state) + tensor_bytes(pods) + tensor_bytes(aux) + 4 * P
               + tensor_bytes([state.requested, state.nonzero_requested, state.pod_count, carries]) + 4)
    n_ops = (ops["sample"] + ops["commit"]) * n_pods * n_real + ops["filter"] * visited + ops["score"] * scored
    bound, by = bound_ms(n_bytes, n_ops)
    return bound, by, f"{visited} visited pairs, {scored} scored, {n_bytes} bytes"


def tensor_digest(tree, h=None) -> str:
    """A sha256 over every tensor of ``tree`` (shape, dtype and values, in
    traversal order, dict keys sorted): the same inputs in two processes
    hash alike, whatever device holds them."""
    top = h is None
    h = hashlib.sha256() if top else h
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        h.update(f"{tuple(t.shape)} {t.dtype}".encode())
        h.update(t.numpy().tobytes())
    elif isinstance(tree, dict):
        for key in sorted(tree):
            h.update(str(key).encode())
            tensor_digest(tree[key], h)
    else:
        for v in tree:
            tensor_digest(v, h)
    return h.hexdigest() if top else ""


def main_path_inputs(device):
    """Phase 4's cluster, featurized, its plugins, and the
    record="selection" engine on ``device`` that kernel A's whole-queue
    pass runs in."""
    nodes, pods = random_cluster(0, *MAIN, bound_fraction=0.0)
    feats = Featurizer().featurize(nodes, pods)
    plugins = default_plugins(feats)
    sched = Engine(feats, plugins, record="selection", exact=True, device=device)
    return nodes, pods, feats, plugins, sched


def plain_queue_child(out: str) -> int:
    """``chip_smoke.py --plain-queue OUT.npz`` (started by ``PlainQueue``):
    kernel A's plain version over phase 4's whole queue on the CPU, with
    the pairs it evaluates counted; writes the selections, the final node
    state, the counts, the wall and the inputs' digest."""
    global DEVICE
    DEVICE = "cpu"
    torch.set_num_threads(2)
    _, _, feats, _, sched = main_path_inputs("cpu")
    prog, state0, pods0, aux = sched._prog, sched._node_state, sched._pods, sched._aux
    carries0 = prog.init_carries(aux)
    digest = tensor_digest((state0, pods0, aux, carries0))
    t = time.perf_counter()
    with PairCount(prog, len(feats.pods.keys)) as count:
        state, _, outs = schedule_scan_plain(prog, state0, pods0, aux, carries0)
    wall = time.perf_counter() - t
    np.savez(out, selected=outs["selected"].numpy(), pairs=count.pairs, feasible=count.feasible, wall_s=wall,
             digest=digest, **{f"state_{f}": getattr(state, f).numpy() for f in state._fields})
    return 0


class PlainQueue:
    """``plain_queue_child`` as a child process on the CPU (no CUDA
    context, so it takes nothing from the card's timings), pinned to two
    cores beside the phases that follow; ``result()`` waits for it."""

    def __init__(self, cores: "set[int] | None") -> None:
        self.work = Path(tempfile.mkdtemp(prefix="ksim-plain-"))
        self.out = self.work / "plain-queue.npz"
        self.log_path = self.work / "plain-queue.log"
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--plain-queue", str(self.out)],
            stdout=self._log, stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"})
        if cores:
            os.sched_setaffinity(self.proc.pid, cores)
        atexit.register(self.close)

    def result(self, timeout: float = 900.0) -> dict:
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the CPU plain scan outlived {timeout} s") from None
        if rc != 0:
            raise AssertionError(f"the CPU plain scan exited {rc}:\n{self.log_path.read_text()[-3000:]}")
        with np.load(self.out) as z:
            return {k: z[k] for k in z.files}

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._log.close()
        shutil.rmtree(self.work, ignore_errors=True)


class LateBuild:
    """build.build(names) on a thread of its own; wait() joins it and
    raises what it raised."""

    def __init__(self, names: tuple[str, ...]):
        self.names, self.error = names, None
        self.thread = threading.Thread(target=self._run, name="late-build")
        self.thread.start()

    def _run(self) -> None:
        try:
            build.build(self.names)
        except BaseException as e:  # re-raised on the main thread by wait()
            self.error = e

    def wait(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise self.error


def print_build_log(names) -> None:
    for name in names:
        log = build.BUILD_LOG[name]
        print(f"  {name}: nvcc {log['seconds']:.1f}s")
        for line in log["ptxas"]:
            print(f"    {line.strip()}")


def phase(name: str) -> None:
    at = time.perf_counter() - T0
    print(f"== {name} (at {at:.1f} s)", flush=True)
    # On standard error too: where a run is cut, its last lines name the
    # phase it was in.
    print(f"chip_smoke: phase {name.split(' ', 1)[0]} began at {at:.1f} s", file=sys.stderr, flush=True)


def commit_invariant(feats, res, state, what: str) -> int:
    """Placements match the committed node state; returns the count."""
    n_pods, n_nodes = len(feats.pods.keys), len(feats.nodes.names)
    sel = res.selected
    placed = sel[sel >= 0]
    if (sel[n_pods:] != -1).any():
        raise AssertionError(f"{what}: a padding pod was placed")
    if (placed >= n_nodes).any():
        raise AssertionError(f"{what}: a pod was placed on a padding node")
    per_node = np.bincount(placed, minlength=feats.nodes.valid.shape[0])
    if not np.array_equal(state.pod_count - feats.nodes.pod_count, per_node):
        raise AssertionError(f"{what}: committed pod_count differs from the placements")
    want_req = feats.nodes.requested.astype(np.int64)
    np.add.at(want_req, placed, feats.pods.requests[sel >= 0])
    if not np.array_equal(state.requested, want_req):
        raise AssertionError(f"{what}: committed requests differ from the placed pods' requests")
    return len(placed)


def tree_equal(check: Check, kernel: str, what: str, got: dict, want: dict) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{what}: keys {sorted(got)} vs {sorted(want)}")
    for key in got:
        check.equal(kernel, f"{what}.{key}", got[key].cpu().numpy(), want[key].cpu().numpy())


def traced(fn):
    """``fn()`` with the trace plane's ring on: (its result, the ring's
    records); the plane's settings are restored after."""
    active, ring = TRACE._active, TRACE._ring_on
    TRACE.reset()
    TRACE.enable(ring=True)
    try:
        out = fn()
        return out, TRACE.ring_records()
    finally:
        TRACE.reset()
        TRACE._active, TRACE._ring_on = active, ring


def executor_report(what: str, drv, res, records, card: str) -> dict:
    """The pipelined executor's evidence for one device run: the prelower
    (at least one window consumed), its seconds inside the dispatch
    worker's intervals, the phase split, the device-buffer reuse and the
    bytes each window sent."""
    st = drv.stats()
    pre, dc = st["prelower"], st["dev_const"]
    inside, total = replay_mod.prelower_overlap_seconds(records)
    if pre["consumed"] < 1:
        raise AssertionError(f"{what}: no pre-parsed window was consumed ({pre})")
    split = {k: res.phase_seconds.get(k, 0.0)
             for k in ("replay.lower", "replay.prelower", "replay.dispatch", "replay.exec", "replay.reconcile",
                       "runner.step")}
    sent = dc["bytes_per_dispatch"]
    print(f"  {what}, executor: prelower windows {pre['windows']}, consumed {pre['consumed']}, discarded "
          f"{pre['discarded']}, faults {pre['faults']}; {inside:.3f} s of the prelower's {total:.3f} s inside the "
          f"dispatch worker's intervals; split {split}; dev-const hits {dc['hits']}, misses {dc['misses']}; H2D "
          f"bytes per window {min(sent)}-{max(sent)} (mean {sum(sent) / len(sent):.0f}, first {sent[0]}); "
          f"compile-once rungs {st['compile_cache']['rungs']} {card}", flush=True)
    return {"prelower": pre, "overlap_s": inside, "prelower_s": total, "split_s": split,
            "dev_const_hits": dc["hits"], "dev_const_misses": dc["misses"],
            "h2d_bytes_per_window": {"min": min(sent), "max": max(sent), "mean": sum(sent) / len(sent),
                                     "first": sent[0]}}


def churn_run(n_events: int, *, device_replay: bool, exact: bool, min_device_steps: "int | None" = None):
    runner = ScenarioRunner(
        max_pods_per_pass=1024,
        pod_bucket_min=128,
        device_replay=device_replay,
        device_segment_steps=SEGMENT_K,
        exact=exact,
        device=DEVICE,
    )
    ops = list(churn_scenario(0, n_nodes=CHURN_NODES, n_events=n_events, ops_per_step=100))
    t = time.perf_counter()
    res = runner.run(ops)
    wall = time.perf_counter() - t
    want = CHURN_LOCKS[n_events]
    got = (res.events_applied if want[0] is not None else None, res.pods_scheduled, res.unschedulable_attempts)
    path = "device" if device_replay else "per-pass"
    what = f"{n_events // 1000}k churn, {path}, {'exact' if exact else 'f32'}"
    if got != want:
        raise AssertionError(f"{what}: {got} against the lock {want}")
    drv = runner.replay_driver
    if device_replay:
        if drv.device_steps + drv.fallback_steps != len(res.steps):
            raise AssertionError(f"{what}: device {drv.device_steps} + fallback {drv.fallback_steps} "
                                 f"!= {len(res.steps)} steps")
        if min_device_steps is None:
            min_device_steps = MIN_DEVICE_STEPS
        if drv.device_steps < min_device_steps:
            raise AssertionError(f"{what}: the kernel carried {drv.device_steps} steps, "
                                 f"fewer than {min_device_steps}")
    return res, drv, wall, what


def churn_phase(check: Check, card: str) -> dict:
    """Phase 6; returns kernel D's and row 6's launches and measurements."""
    t6 = time.perf_counter()
    for exact in (False, True):
        res, _, wall, what = churn_run(6000, device_replay=False, exact=exact)
        print(f"  {what}: {res.events_applied} events, {res.pods_scheduled} scheduled, "
              f"{res.unschedulable_attempts} unschedulable (the lock) in {wall:.1f} s {card}", flush=True)

    # Every dispatch's inputs and outputs, for the plain comparison.
    segments = []
    kernel = replay_mod.replay_segment

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments.append((st, prog, const, ev, held, final, outs))
        return final, outs

    replay_mod.replay_segment = capture
    runs, executors = {}, {}
    try:
        for exact in (False, True):
            segments.clear()
            replay_segment.launches = 0
            reset_derive_runs()
            derive_interpod.launches = 0
            (res, drv, wall, what), records = traced(lambda: churn_run(6000, device_replay=True, exact=exact))
            # Row 6 has no launch of its own on this path: kernel D counts
            # its runs on the card, one per active step.
            launches = {"replay_segment": replay_segment.launches, "derive_interpod": derive_runs()}
            print(f"  {what}: the lock, {drv.device_steps} steps on the card, {drv.fallback_steps} "
                  f"per-pass, {drv.unsupported or 'no fallback'}; launches {launches}; wall {wall:.2f} s, "
                  f"kernel {drv.kernel_ms:.1f} ms, phases {res.phase_seconds} {card}", flush=True)
            if launches["replay_segment"] < 1 or launches["derive_interpod"] < 1:
                raise AssertionError(f"{what}: kernel D was not launched, or row 6 did not run in it")
            active = sum(int(seg[3]["active"].sum()) for seg in segments)
            if launches["derive_interpod"] != active:
                raise AssertionError(f"{what}: row 6 ran {launches['derive_interpod']} times in kernel D, "
                                     f"for {active} active steps")
            if derive_interpod.launches:
                raise AssertionError("the standalone derive_interpod entry ran on the main path")
            executors[exact] = executor_report(what, drv, res, records, card)
            runs[exact] = (list(segments), launches, drv.kernel_ms, step_triples(res))
    finally:
        replay_mod.replay_segment = kernel

    segments, launches, kernel_ms_6k, solo_steps = runs[False]
    # D against its plain version on the f32 run's fullest segment (the
    # one timed below) and the exact run's first: a plain segment takes
    # 15-20 s, and phase 10's watchdog leg holds every launch of another
    # f32 run against it.
    pick = max(range(len(segments)), key=lambda i: int((segments[i][6]["idx"] < segments[i][2]["pods"]["requests"].shape[0]).sum()))
    t = time.perf_counter()
    plain_seg_ms, seg_pairs = {}, {}
    for mode, i, (st, prog, const, ev, state0, final, outs) in (("f32", pick, segments[pick]),
                                                                ("exact", 0, runs[True][0][0])):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with PairCount(prog, const["pods"]["requests"].shape[0]) as count:
            start.record()
            want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
            end.record()
            torch.cuda.synchronize()
        if mode == "f32":
            plain_seg_ms[i] = start.elapsed_time(end)
            seg_pairs[i] = (count.pairs, count.feasible)
        tree_equal(check, "replay_segment", f"6k {mode} segment {i} outputs", outs, want_outs)
        tree_equal(check, "replay_segment", f"6k {mode} segment {i} final state", final, want_final)
    print(f"  kernel D equals its plain version on segment {pick} of the {len(segments)} of the f32 run (the "
          f"fullest) and on the first of the exact run ({time.perf_counter() - t:.1f} s)", flush=True)
    # Row 6 alone on every segment's starting state (the first segment
    # starts before any pod is bound: its counts are all zero).
    views = []
    for i, (st0, _prog0, const0, _ev0, state00) in enumerate(s[:5] for s in segments):
        ipa0 = const0["aux"]["interpod"]
        loc0 = {"cnt": state00["ip_cnt"], "eat": state00["ip_eat"], "vw": state00["ip_vw"]}
        got_view = derive_interpod(loc0, ipa0, st0.n_tk, st0.n_dom)
        tree_equal(check, "derive_interpod", f"segment {i}'s domain view", got_view,
                   derive_interpod_plain(loc0, ipa0, st0.n_tk, st0.n_dom))
        views.append(int(got_view["total"].sum()))
    print(f"  derive_interpod equals its plain version on every segment's starting state "
          f"(matching-pod term counts {views})")

    segments50 = []

    def capture50(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments50.append((st, prog, const, ev, held, final, outs))
        return final, outs

    replay_mod.replay_segment = capture50
    try:
        (res50, drv50, wall50, what50), records50 = traced(
            lambda: churn_run(50_000, device_replay=True, exact=False))
    finally:
        replay_mod.replay_segment = kernel
    host50 = {k: v for k, v in res50.phase_seconds.items() if k.startswith("replay.") or k == "runner.step"}
    print(f"  {what50}: {res50.pods_scheduled} scheduled, {res50.unschedulable_attempts} unschedulable (the "
          f"lock); {drv50.device_steps} steps on the card in {drv50.device_round_trips} launches, "
          f"{drv50.fallback_steps} per-pass; wall {wall50:.2f} s, kernel {drv50.kernel_ms:.1f} ms, "
          f"host phases {host50} {card}", flush=True)
    executor_50k = executor_report(what50, drv50, res50, records50, card)
    # The 50k run: D's time on its fullest segment, and on the segment of
    # its widest pod-row shape with the fewest attempts, where it is held
    # against its plain version (about 15 ms an attempt on the card) and
    # its bound is taken from the pairs that run counts.
    def attempts(seg) -> int:
        return int((seg[6]["idx"] < seg[2]["pods"]["requests"].shape[0]).sum())

    def seg_shape(seg) -> str:
        st_, _, const_, _, _, _, _ = seg
        return (f"K={st_.k} x Q={st_.q} x {const_['node']['allocatable'].shape[0]} nodes x "
                f"{const_['pods']['requests'].shape[0]} pod rows, {attempts(seg)} attempts")

    fullest = max(segments50, key=attempts)
    ms50 = cuda_ms(lambda: kernel(*fullest[:5]), reps=3)
    shape50 = seg_shape(fullest)
    rows50 = max(seg[2]["pods"]["requests"].shape[0] for seg in segments50)
    light = min((seg for seg in segments50 if seg[2]["pods"]["requests"].shape[0] == rows50 and attempts(seg)),
                key=attempts)
    st, prog, const, ev, state0, final, outs = light
    with PairCount(prog, rows50) as count:
        want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
    tree_equal(check, "replay_segment", "50k light widest segment outputs", outs, want_outs)
    tree_equal(check, "replay_segment", "50k light widest segment final state", final, want_final)
    ms_light = cuda_ms(lambda: kernel(st, prog, const, ev, state0), reps=3)
    bytes50, ops50 = segment_work(st, prog, const, ev, state0, outs, final, (count.pairs, count.feasible))
    bound50, by50 = bound_ms(bytes50, ops50)
    shape_light = seg_shape(light)
    del fullest, light, want_final, want_outs
    segments50.clear()
    print(f"  the 50k run's fullest segment ({shape50}): {ms50:.3f} ms per launch {card}")
    print(f"  the 50k run's lightest segment of its widest shape ({shape_light}): {ms_light:.3f} ms per launch; "
          f"bound {bound50:.4f} ms by {by50} ({bytes50} bytes; {count.pairs} attempted pod x valid node pairs, "
          f"{count.feasible} feasible); equal to D's plain version {card}", flush=True)

    # Timings on one segment of the 6k f32 run: the fullest one.
    st, prog, const, ev, state0, final, outs = segments[pick]
    P = const["pods"]["requests"].shape[0]
    N = const["node"]["allocatable"].shape[0]
    idx = outs["idx"]
    attempted = idx[idx < P].long()
    n_att = int(attempted.numel())
    ms_d = cuda_ms(lambda: kernel(st, prog, const, ev, state0), reps=3)
    d_ran = launch_notes(replay_segment.last)
    if d_ran["cluster"] < 8:
        raise AssertionError(f"kernel D ran on a cluster of {d_ran['cluster']} blocks on the main path")
    ms_by_cluster = {}
    for cs in D_CLUSTER_SIZES:
        segment_mod.CLUSTER_SIZE = cs
        try:
            got_final, got_outs = kernel(st, prog, const, ev, state0)
            tree_equal(check, "replay_segment", f"cluster of {cs}: segment {pick} outputs", got_outs, outs)
            tree_equal(check, "replay_segment", f"cluster of {cs}: segment {pick} final state", got_final, final)
            ms_by_cluster[cs] = cuda_ms(lambda: kernel(st, prog, const, ev, state0), reps=3)
        finally:
            segment_mod.CLUSTER_SIZE = 0
    d_ran["ms_by_cluster"] = ms_by_cluster
    print(f"  kernel D ran {d_ran['cluster']} blocks of {d_ran['threads']} threads ({d_ran['smem_bytes']} B shared "
          f"memory each), {d_ran['barriers_per_attempt']:.2f} cluster barriers per attempt; by cluster size "
          f"{ms_by_cluster} ms; block 0's cycles by phase: {shares(d_ran['phase_share'])} {card}", flush=True)
    mask = np.zeros(P, bool)
    mask[attempted.cpu().numpy()] = True
    ops = chain_pair_ops(const["aux"], prog.plugins, const["node"]["allocatable"].shape[1], mask)
    # Each attempt filters the nodes valid at its step; only the feasible
    # pairs need scores (selection record).
    d_pairs, d_feasible = seg_pairs[pick]
    d_ops = (ops["filter"] + ops["commit"]) * d_pairs + ops["score"] * d_feasible
    d_bytes = tensor_bytes(const) + tensor_bytes(ev) + tensor_bytes(state0) + tensor_bytes(outs) + tensor_bytes(final)
    d_bound, d_by = bound_ms(d_bytes, d_ops)
    d_shape = f"K={st.k} x Q={st.q} x {N} nodes x {P} pod rows, {n_att} attempts"
    print(f"  replay_segment (kernel D), {d_shape}: {ms_d:.3f} ms per launch; plain {plain_seg_ms[pick]:.1f} ms; "
          f"bound {d_bound:.4f} ms by {d_by} ({d_bytes} bytes; {ops['filter'] + ops['commit']:.1f} ops on each "
          f"of {d_pairs} attempted pod x valid node pairs, {ops['score']:.1f} more on each of {d_feasible} "
          f"feasible ones) {card}")
    # Row 6 alone: the wrapper's host work (the key layout, the parameter
    # block) is done once, and only the kernel's launches are timed.
    st0, ipa0 = st, const["aux"]["interpod"]
    loc0 = {"cnt": state0["ip_cnt"], "eat": state0["ip_eat"], "vw": state0["ip_vw"]}
    layout0 = derive_layout(ipa0["node_dom"])
    got_view = derive_interpod(loc0, ipa0, st0.n_tk, st0.n_dom)
    T2 = ipa0["dom_t"].shape[1]
    lib, keep = segment_mod._load(), []
    view_v = segment_mod._view_out(loc0["cnt"], T2)
    prm_v = segment_mod._derive_params(loc0, ipa0, view_v, keep, layout0)
    ms_v = cuda_ms(lambda: segment_mod._launch_derive(lib, prm_v), reps=100, warmup=3)
    tree_equal(check, "derive_interpod", "the timed launches' view", view_v,
               derive_interpod_plain(loc0, ipa0, st0.n_tk, st0.n_dom))
    wrapper_v = cuda_ms(lambda: derive_interpod(loc0, ipa0, st0.n_tk, st0.n_dom), reps=10)
    plain_v = cuda_ms(lambda: derive_interpod_plain(loc0, ipa0, st0.n_tk, st0.n_dom), reps=3)
    v_bytes = tensor_bytes(loc0) + tensor_bytes([ipa0["node_dom"], ipa0["dom_t"], ipa0["term_tk"]]) + tensor_bytes(got_view)
    n0 = state0["valid"].shape[0]
    v_bound, v_by = bound_ms(v_bytes, 12 * n0 * T2)  # three sums and reads per (node, term)
    v_shape = f"{n0} nodes x {T2} terms"
    print(f"  derive_interpod (row 6 alone), {v_shape}: {ms_v:.4f} ms per launch (the wrapper with its layout "
          f"built per call: {wrapper_v:.4f} ms); plain {plain_v:.3f} ms; bound {v_bound:.5f} ms by {v_by} "
          f"({v_bytes} bytes) {card}")
    print(f"  kernel D over the whole 6k f32 run: {kernel_ms_6k:.1f} ms in {launches['replay_segment']} launches; "
          f"phase 6 took {time.perf_counter() - t6:.1f} s")
    return {
        "launches": launches,
        "replay_segment": (ms_d, plain_seg_ms[pick], d_bound, d_by, d_shape),
        "derive_interpod": (ms_v, plain_v, v_bound, v_by, v_shape),
        "solo_steps": solo_steps,
        "d_ran": d_ran,
        "kernel_ms": {"6k_f32": kernel_ms_6k, "50k_f32": drv50.kernel_ms, "50k_launches": drv50.device_round_trips},
        "fullest_50k": {"ms": ms50, "shape": shape50},
        "widest_light_50k": {"ms": ms_light, "bound_ms": bound50, "bound_by": by50, "shape": shape_light},
        "executor": {"6k_f32": executors[False], "6k_exact": executors[True], "50k_f32": executor_50k,
                     "50k_wall_s": wall50},
    }


def shares(share: dict) -> str:
    return ", ".join(f"{name} {100 * x:.1f}%" for name, x in share.items() if x)


def launch_notes(last: dict) -> dict:
    """What a kernel-D launch ran (replay_segment.last): cluster, threads,
    shared memory, the cluster barriers per attempt and block 0's share of
    its cycles by phase, as the kernel counted them."""
    stats = [int(x) for x in last["stats"].cpu()]
    cycles = stats[2:]
    return {"cluster": int(last["cluster"]), "threads": int(last["threads"]), "smem_bytes": int(last["smem_bytes"]),
            "barriers_per_attempt": stats[0] / max(stats[1], 1), "attempts": stats[1],
            "phase_share": {name: c / max(sum(cycles), 1) for name, c in zip(chain.CLUSTER_PHASES, cycles)}}


def step_triples(res) -> list[tuple[int, int, int]]:
    return [(s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


def segment_work(st, prog, const, ev, state0, outs, final, pairs: tuple[int, int]) -> tuple[float, float]:
    """(bytes, operations) one lane of kernel D needs on a segment: its
    inputs read once and outputs written once; the chain's operations on
    the attempted pods against the valid nodes, scores on the feasible
    pairs only (``pairs`` = (pairs, feasible), counted by PairCount)."""
    P = const["pods"]["requests"].shape[0]
    idx = outs["idx"]
    mask = np.zeros(P, bool)
    mask[idx[idx < P].long().cpu().numpy()] = True
    ops = chain_pair_ops(const["aux"], prog.plugins, const["node"]["allocatable"].shape[1], mask)
    n_ops = (ops["filter"] + ops["commit"]) * pairs[0] + ops["score"] * pairs[1]
    n_bytes = tensor_bytes(const) + tensor_bytes(ev) + tensor_bytes(state0) + tensor_bytes(outs) + tensor_bytes(final)
    return n_bytes, n_ops


def fleet_phase(check: Check, card: str, solo_steps) -> dict:
    """Phase 7; returns rows 10-11's launches and measurements."""
    t7 = time.perf_counter()
    ops = list(churn_scenario(0, n_nodes=CHURN_NODES, n_events=6000, ops_per_step=100))
    lock = CHURN_LOCKS[6000]
    captured = []
    fleet_kernel = replay_mod.replay_segment_fleet

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = fleet_kernel(st, prog, const, ev, state0)
        captured.append((st, prog, const, ev, held, final, outs))
        return final, outs

    counts = {}
    replay_mod.replay_segment_fleet = capture
    try:
        for mode in ("dedupe", "vmap"):
            os.environ["KSIM_FLEET_VMAP"] = "1" if mode == "vmap" else "0"
            captured.clear()
            replay_segment.launches = 0
            replay_segment_fleet.launches = 0
            reset_derive_runs()
            runner = ScenarioRunner(max_pods_per_pass=1024, pod_bucket_min=128, device_replay=True,
                                    device_segment_steps=SEGMENT_K, preemption=True, exact=False,
                                    device=DEVICE, fleet=FLEET_LANES)
            t = time.perf_counter()
            agg = runner.run(ops)
            wall = time.perf_counter() - t
            launched = {"replay_segment": replay_segment.launches,
                        "replay_segment_fleet": replay_segment_fleet.launches, "derive_runs": derive_runs()}
            stats = runner.fleet_driver.stats()
            what = f"fleet {FLEET_LANES} x 6k, {mode}"
            for ln in runner.fleet_lanes:
                r = ln.result
                if (r.events_applied, r.pods_scheduled, r.unschedulable_attempts) != lock:
                    raise AssertionError(f"{what}: lane {ln.idx} {r.pods_scheduled}/{r.unschedulable_attempts}")
                if step_triples(r) != solo_steps:
                    raise AssertionError(f"{what}: lane {ln.idx}'s steps differ from the solo device run")
            lowerings = stats["lane_lowerings"]
            if not (sum(lowerings) == lowerings[0] > 0) or stats["lanes_on_device"] != 1.0:
                raise AssertionError(f"{what}: {stats}")
            dispatches = stats["group_dispatches"]
            active = sum(int(seg[3]["active"].sum()) for seg in captured)
            if mode == "vmap":
                if launched["replay_segment_fleet"] != dispatches or dispatches < 1 or launched["replay_segment"]:
                    raise AssertionError(f"{what}: launches {launched} for {dispatches} group dispatches")
                if launched["derive_runs"] != FLEET_LANES * active:
                    raise AssertionError(f"{what}: row 6 ran {launched['derive_runs']} times, for "
                                         f"{FLEET_LANES} lanes x {active} active steps")
            elif launched["replay_segment"] != dispatches or launched["replay_segment_fleet"]:
                raise AssertionError(f"{what}: launches {launched} for {dispatches} group dispatches")
            counts[mode] = launched
            print(f"  {what}: every lane {lock[1]}/{lock[2]} with the solo run's steps; lowerings {lowerings}; "
                  f"{dispatches} group dispatches; launches {launched}; wall {wall:.2f} s, fleet kernel "
                  f"{stats['kernel_ms']:.1f} ms, phases {agg.phase_seconds} {card}", flush=True)
    finally:
        replay_mod.replay_segment_fleet = fleet_kernel
        os.environ.pop("KSIM_FLEET_VMAP", None)

    # The vmap leg's fullest launch: lane by lane against the solo kernel,
    # then a FLEET_PLAIN_LANES-lane launch against the plain fleet version.
    pick = max(range(len(captured)), key=lambda i: int((captured[i][6]["idx"][0] < captured[i][2]["pods"]["requests"].shape[0]).sum()))
    st, prog, const, ev, state0, final, outs = captured[pick]
    lane0 = {k: v[0] for k, v in state0.items()}
    solo_final, solo_outs = replay_segment(st, prog, const, ev, lane0)
    for i in range(FLEET_LANES):
        tree_equal(check, "replay_segment_fleet", f"fleet lane {i} outputs", {k: v[i] for k, v in outs.items()},
                   solo_outs)
        tree_equal(check, "replay_segment_fleet", f"fleet lane {i} final state",
                   {k: v[i] for k, v in final.items()}, solo_final)
    two = {k: v[:FLEET_PLAIN_LANES].contiguous() for k, v in state0.items()}
    got_final, got_outs = replay_segment_fleet(st, prog, const, ev, two)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with PairCount(prog, const["pods"]["requests"].shape[0]) as count:
        start.record()
        want_final, want_outs = replay_segment_fleet_plain(st, prog, const, ev, two)
        end.record()
        torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    tree_equal(check, "replay_segment_fleet", f"{FLEET_PLAIN_LANES}-lane fleet outputs", got_outs, want_outs)
    tree_equal(check, "replay_segment_fleet", f"{FLEET_PLAIN_LANES}-lane fleet final state", got_final, want_final)
    ms_fleet = cuda_ms(lambda: fleet_kernel(st, prog, const, ev, state0), reps=3)
    fleet_ran = launch_notes(replay_segment_fleet.last)
    ms_two = cuda_ms(lambda: fleet_kernel(st, prog, const, ev, two), reps=3)
    ms_solo = cuda_ms(lambda: replay_segment(st, prog, const, ev, lane0), reps=3)
    # Bound: every lane's needed work (the plain run counted two lanes'
    # pairs); const and ev are read once for all lanes.
    lane_pairs = (count.pairs // FLEET_PLAIN_LANES, count.feasible // FLEET_PLAIN_LANES)
    lane_bytes, lane_ops = segment_work(st, prog, const, ev, lane0, solo_outs, solo_final, lane_pairs)
    shared = tensor_bytes(const) + tensor_bytes(ev)
    f_bytes = shared + FLEET_LANES * (lane_bytes - shared)
    f_bound, f_by = bound_ms(f_bytes, FLEET_LANES * lane_ops)
    P = const["pods"]["requests"].shape[0]
    N = const["node"]["allocatable"].shape[0]
    n_att = int((outs["idx"][0] < P).sum())
    f_shape = f"{FLEET_LANES} lanes x K={st.k} x Q={st.q} x {N} nodes x {P} pod rows, {n_att} attempts per lane"
    print(f"  the {FLEET_LANES}-lane launch ran {fleet_ran['cluster']} blocks of {fleet_ran['threads']} threads per "
          f"lane (the occupancy query's choice)")
    print(f"  replay_segment_fleet (rows 10-11), {f_shape}: {ms_fleet:.3f} ms per launch; the solo launch "
          f"{ms_solo:.3f} ms ({ms_fleet / ms_solo:.2f}x); {FLEET_PLAIN_LANES} lanes {ms_two:.3f} ms; plain "
          f"{FLEET_PLAIN_LANES} lanes {plain_ms:.1f} ms; bound {f_bound:.4f} ms by {f_by} ({f_bytes} bytes) {card}")
    print(f"  the fleet launch equals the solo kernel lane by lane and, on {FLEET_PLAIN_LANES} lanes, its plain "
          f"version; phase 7 took {time.perf_counter() - t7:.1f} s", flush=True)
    return {
        "launches": counts["vmap"]["replay_segment_fleet"],
        "measured": (ms_fleet, f_bound, f_by, f_shape),
        "plain_ms": plain_ms,
        "extra": {"plain_shape": f"{FLEET_PLAIN_LANES} lanes of the same segment",
                  f"ms_{FLEET_PLAIN_LANES}_lanes": ms_two, "solo_ms_same_segment": ms_solo,
                  "dedupe_launches": counts["dedupe"]["replay_segment"],
                  "cluster": fleet_ran["cluster"], "threads": fleet_ran["threads"]},
    }


def batch_shape(run, card: str) -> dict:
    """Kernel B's last launch (``run`` makes one): the grid, blocks per SM
    and what bounds them, registers, local memory, shared memory per
    block, and block 0's cycle share per phase of a pod."""
    run()
    last = batch_mod.batch_eval.last
    stats = [int(x) for x in last["stats"].cpu()]
    cycles = stats[2:]
    share = {name: sum(cycles[i] for i in idx) / max(sum(cycles), 1) for name, idx in batch_mod.B_PHASES.items()}
    regs, smem = last["registers"], last["smem_bytes"]
    by_regs = 65536 // (batch_mod.B_THREADS * max(regs, 1))
    by_smem = batch_mod.SM_SMEM_BYTES // (smem + batch_mod.BLOCK_RESERVED_BYTES)
    print(f"  kernel B's launch: grid {last['grid']} ({last['blocks_per_sm']} blocks of {batch_mod.B_THREADS} threads "
          f"per SM x {last['sms']} SMs), {regs} registers per thread, {last['local_bytes']} B local memory per "
          f"thread, {smem} B shared memory per block (node arrays in a global row per block); registers allow "
          f"{by_regs} blocks per SM, "
          f"shared memory {by_smem} {card}")
    if last["blocks_per_sm"] < batch_mod.MIN_BLOCKS:
        short = {"registers": by_regs, "shared memory": by_smem}
        name = min(short, key=short.get)
        print(f"  kernel B holds {last['blocks_per_sm']} blocks per SM, short of {batch_mod.MIN_BLOCKS}: "
              f"{name} stops it ({short[name]} blocks)")
    print(f"  kernel B, block 0's cycles by phase ({stats[0]} pods): {shares(share)}", flush=True)
    return {"grid": last["grid"], "blocks_per_sm": last["blocks_per_sm"], "registers": regs,
            "local_bytes": last["local_bytes"], "smem_bytes": smem,
            "blocks_per_sm_by_registers": by_regs, "blocks_per_sm_by_smem": by_smem, "phase_share": share}


def prepass_phase(check: Check, args: tuple, card: str) -> dict:
    """Kernel B's pre-pass alone on ``args`` (prog, state, aux, carries):
    equal to node_summary_plain, timed, beside its bound."""
    got, want = node_summary(*args), node_summary_plain(*args)
    for key in want:
        if (got[key] is None) != (want[key] is None):
            raise AssertionError(f"node_summary {key}: produced by one side only")
        if want[key] is not None:
            check.equal("node_summary", f"main-path node_summary {key}", got[key].cpu().numpy(), want[key].cpu().numpy())
    launch, _ = batch_mod.node_summary_launcher(*args)
    ms = cuda_ms(launch, reps=50)
    wrapper_ms = cuda_ms(lambda: node_summary(*args), reps=20)
    plain = cuda_ms(lambda: node_summary_plain(*args), reps=3)
    prog, state, aux, carries = args
    N = state.valid.shape[0]
    a = aux["affinity"]
    reads = [aux["taints"]["node_taint_order"], aux["taints"]["forbidding"], aux["taints"]["prefer"], a["term_ok"],
             a["added_pref"], a["added_terms"], a["has_added"], aux["imagelocality"]["node_has_image"],
             aux["volumes"]["limits"], aux["volumes"]["vol_key"]]
    # Only the carries the pre-pass reads: not spread's counts nor the inter-pod weights.
    if "NodePorts" in carries:
        reads.append(carries["NodePorts"])
    if "VolumeRestrictions" in carries:
        reads += [carries["VolumeRestrictions"][k] for k in ("rwop", "disk_any", "disk_rw")]
    if "InterPodAffinity" in carries:
        reads += [carries["InterPodAffinity"][k] for k in ("cnt", "ecnt")]
    nvl = chain.volume_limits_carry(prog)
    if nvl is not None:
        reads.append(carries[nvl])
    n_bytes = tensor_bytes(reads) + tensor_bytes([v for v in got.values() if v is not None])
    sizes = batch_mod.group_sizes(aux)
    VV, NK = aux["volumes"]["pod_vol"].shape[1], aux["volumes"]["limits"].shape[1]
    n_ops = N * (sum(sizes[:batch_mod.NODE_GROUPS]) + NK * VV + 2 * sizes[3])
    bound, by = bound_ms(n_bytes, n_ops)
    print(f"  node_summary (kernel B's pre-pass), {N} nodes: {ms:.4f} ms per launch (the wrapper, its parameters "
          f"built per call: {wrapper_ms:.4f} ms); plain {plain:.3f} ms; bound "
          f"{bound:.5f} ms by {by} ({n_bytes} bytes, {n_ops} operations); equal to its plain version {card}",
          flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "wrapper_ms": wrapper_ms}


def wide_phase(check: Check, card: str) -> None:
    """Phase 9: kernels A-D on the profile past every old cap, and kernel
    B past the old node bound, each against its plain version."""
    t9 = time.perf_counter()
    nodes, pods, kw = wide_cluster(0)
    feats = Featurizer().featurize(nodes, pods, **kw)
    plugins = wide_profile("all", feats, port_core, port_res, port_vol, default_plugins)
    for exact in (True, False):
        what = f"wide profile exact={exact}"
        plain = PlainEngine(feats, plugins, record="full", exact=exact, device=DEVICE)
        kernel = Engine(feats, plugins, record="full", exact=exact, device=DEVICE)
        want, want_state = plain.schedule(chunk=16)
        got, got_state = kernel.schedule(chunk=16)
        check.results("schedule_scan", f"{what} schedule", got, want)
        same_state("schedule_scan", what, check, got_state, want_state)
        check.results("batch_eval", f"{what} batch", kernel.evaluate_batch(chunk=16), plain.evaluate_batch(chunk=16))
        fused = Engine(feats, plugins, record="final", exact=exact, device=DEVICE)
        fused_plain = PlainEngine(feats, plugins, record="final", exact=exact, device=DEVICE)
        check.results("batch_eval", f"{what} fused", fused.evaluate_batch_fused(), fused_plain.evaluate_batch_fused(),
                      "final")
        ks = Engine(feats, plugins, record="full", exact=exact, device=DEVICE, sampling_k=5)
        ks_plain = PlainEngine(feats, plugins, record="full", exact=exact, device=DEVICE, sampling_k=5)
        check.results("schedule_sampled", f"{what} sampled", ks.schedule(chunk=16, sampling_start=3)[0],
                      ks_plain.schedule(chunk=16, sampling_start=3)[0])
    names = [sp.plugin.name for sp in plugins]
    print(f"  wide profile ({len(names)} plugins, with {names[names.index('NodeVolumeLimits') + 1:][:2]}): "
          f"A, B, C equal their plain versions in exact and f32 modes", flush=True)
    segments = []
    kernel = replay_mod.replay_segment

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments.append((st, prog, const, ev, held, final, outs))
        return final, outs

    replay_mod.replay_segment = capture
    try:
        dev = wide_runner(DEVICE, device_replay=True)
        res = dev.run(list(wide_stream()))
    finally:
        replay_mod.replay_segment = kernel
    base = wide_runner(DEVICE, device_replay=False).run(list(wide_stream()))
    if dev.replay_driver.device_steps < 8 or step_triples(res) != step_triples(base):
        raise AssertionError(f"wide churn: device path {step_triples(res)} vs per-pass {step_triples(base)}, "
                             f"{dev.replay_driver.device_steps} device steps, {dev.replay_driver.unsupported}")
    for i, (st, prog, const, ev, state0, final, outs) in enumerate(segments):
        want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
        tree_equal(check, "replay_segment", f"wide churn segment {i} outputs", outs, want_outs)
        tree_equal(check, "replay_segment", f"wide churn segment {i} final state", final, want_final)
    print(f"  wide churn (the profile compiled from a KubeSchedulerConfiguration): {dev.replay_driver.device_steps} "
          f"steps through kernel D, equal to the per-pass path; D equals its plain version on its "
          f"{len(segments)} segments", flush=True)
    nodes, pods = random_cluster(0, WIDE_NODES, 40)
    feats = Featurizer().featurize(nodes, pods)
    n_pad = feats.nodes.valid.shape[0]
    if n_pad <= 17_590:
        raise AssertionError(f"{n_pad} padded nodes: not past the old bound")
    for exact in (True, False):
        plugins = default_plugins(feats)
        kernel = Engine(feats, plugins, record="full", exact=exact, device=DEVICE)
        plain = PlainEngine(feats, plugins, record="full", exact=exact, device=DEVICE)
        check.results("batch_eval", f"{n_pad} nodes exact={exact}", kernel.evaluate_batch(chunk=32),
                      plain.evaluate_batch(chunk=32))
    print(f"  kernel B at {n_pad} padded nodes (node arrays in global memory, "
          f"{batch_mod.batch_eval.last['smem_bytes']} B shared memory per block, "
          f"{batch_mod.batch_eval.last['blocks_per_sm']} blocks per SM): equal to its plain version; "
          f"phase 9 took {time.perf_counter() - t9:.1f} s {card}", flush=True)


def synthetic_borg(path: str, records: int, seed: int) -> None:
    """A synthetic Borg JSONL (bench.py ``child_churn_stream``'s
    generator): SUBMIT/FINISH pairs with lifetimes short against the
    trace's span, so deletes interleave with arrivals."""
    rng = random.Random(seed)
    t_us = 0
    with open(path, "w") as f:
        for i in range(records):
            t_us += rng.randrange(1_000, 50_000)
            life_us = rng.randrange(500_000, 60_000_000)
            req = {"cpus": rng.choice((0.01, 0.025, 0.05, 0.1)), "memory": rng.choice((0.005, 0.01, 0.02, 0.05))}
            f.write(json.dumps({"time": t_us, "type": "SUBMIT", "collection_id": i, "instance_index": 0,
                                "priority": rng.choice((0, 103, 117, 200, 360)), "resource_request": req}) + "\n")
            f.write(json.dumps({"time": t_us + life_us, "type": "FINISH", "collection_id": i,
                                "instance_index": 0}) + "\n")


def join_abandoned_workers() -> None:
    """Wait for dispatch workers the watchdog left behind (they finish
    their own launch and touch nothing else)."""
    for t in threading.enumerate():
        if t.name == "replay-dispatch":
            t.join(120)


def trace_run(ops, *, device_replay: bool, **kw):
    runner = ScenarioRunner(device_replay=device_replay, exact=False, device=DEVICE, **kw)
    t = time.perf_counter()
    res = runner.run(ops)
    return runner, res, time.perf_counter() - t


def executor_phase(check: Check, card: str) -> dict:
    """Phase 10: the executor's device-buffer reuse, watchdog and breaker
    on the card, and streaming trace ingest through ScenarioRunner."""
    t10 = time.perf_counter()
    out = {}
    kernel = replay_mod.replay_segment
    lock = CHURN_LOCKS[6000]

    # Device-buffer reuse off and on; with it on, every constant tensor a
    # launch read must still hold its bytes after the run.
    seen = []

    def watching(st, prog, const, ev, state0):
        for part in ("node", "pods"):
            seen.extend((t, t.clone()) for t in const[part].values())
        for fam in const["aux"].values():
            seen.extend((t, t.clone()) for t in fam.values())
        return kernel(st, prog, const, ev, state0)

    triples, walls, reuse = {}, {}, {}
    for flag in ("0", "1"):
        os.environ["KSIM_REPLAY_DEV_CACHE"] = flag
        replay_mod.replay_segment = watching if flag == "1" else kernel
        try:
            res, drv, wall, what = churn_run(6000, device_replay=True, exact=False)
        finally:
            replay_mod.replay_segment = kernel
            os.environ.pop("KSIM_REPLAY_DEV_CACHE", None)
        dc = drv.stats()["dev_const"]
        triples[flag], walls[flag] = step_triples(res), wall
        reuse[flag] = {"hits": dc["hits"], "misses": dc["misses"], "bytes": dc["bytes_per_dispatch"]}
        print(f"  {what}, KSIM_REPLAY_DEV_CACHE={flag}: the lock; wall {wall:.2f} s; dev-const hits {dc['hits']}, "
              f"misses {dc['misses']}; H2D bytes per window {dc['bytes_per_dispatch']} {card}", flush=True)
    if triples["0"] != triples["1"]:
        raise AssertionError("6k churn: the step triples differ between device-buffer reuse off and on")
    if reuse["1"]["hits"] < 1:
        raise AssertionError("6k churn: device-buffer reuse on reused no constant tensor")
    shared = {id(t) for t, _ in seen if sum(u is t for u, _ in seen) > 1}
    changed = sum(not torch.equal(t, before) for t, before in seen)
    if changed:
        raise AssertionError(f"{changed} constant tensors changed after a launch read them")
    print(f"  reuse off and on: equal step triples; {len(seen)} constant tensors read by the launches, {len(shared)} "
          f"of them by more than one launch, every one unchanged after the run {card}", flush=True)
    out["dev_cache"] = {"walls_s": walls, "reuse": reuse, "consts_read": len(seen), "consts_shared": len(shared)}
    seen.clear()

    # The watchdog: the first dispatch hangs past it.
    segments = []

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments.append((st, prog, const, ev, held, final, outs))
        return final, outs

    os.environ["KSIM_REPLAY_WATCHDOG_S"] = str(WATCHDOG_S)
    FAULTS.arm("replay.dispatch", f"hang:{HANG_S}:1")
    replay_mod.replay_segment = capture
    try:
        res, drv, wall, what = churn_run(6000, device_replay=True, exact=False)
        fired = FAULTS.fired("replay.dispatch")
    finally:
        replay_mod.replay_segment = kernel
        FAULTS.reset()
        os.environ.pop("KSIM_REPLAY_WATCHDOG_S", None)
    join_abandoned_workers()
    if fired != 1 or drv.watchdog_timeouts != 1 or drv.unsupported.get("device_error") != 1:
        raise AssertionError(f"{what}, watchdog: fired {fired}, timeouts {drv.watchdog_timeouts}, {drv.unsupported}")
    if drv.fallback_steps < 1 or drv.breaker_tripped:
        raise AssertionError(f"{what}, watchdog: {drv.fallback_steps} per-pass steps, breaker {drv.breaker_tripped}")
    # The launch with the fewest attempts against the plain version (the
    # others' results make the lock; a plain segment takes 15-20 s).
    att = [int((seg[6]["idx"] < seg[2]["pods"]["requests"].shape[0]).sum()) for seg in segments]
    i = min(range(len(segments)), key=att.__getitem__)
    st, prog, const, ev, state0, final, outs = segments[i]
    want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
    tree_equal(check, "replay_segment", f"watchdog leg launch {i} outputs", outs, want_outs)
    tree_equal(check, "replay_segment", f"watchdog leg launch {i} final state", final, want_final)
    print(f"  {what}, {WATCHDOG_S} s watchdog, first dispatch hung {HANG_S} s: the lock; 1 timeout, "
          f"{drv.fallback_steps} step per-pass, {drv.device_steps} on the card; {len(segments)} launches (the "
          f"abandoned worker's included), attempts {att}: kernel D equal to its plain version on the launch of "
          f"{att[i]}; wall {wall:.2f} s {card}", flush=True)
    out["watchdog"] = {"timeouts": drv.watchdog_timeouts, "fallback_steps": drv.fallback_steps,
                       "device_steps": drv.device_steps, "launches": len(segments), "launches_checked": 1,
                       "wall_s": wall}
    segments.clear()

    # The breaker: every dispatch fails.
    FAULTS.arm("replay.dispatch", "always")
    try:
        res, drv, wall, what = churn_run(6000, device_replay=True, exact=False, min_device_steps=0)
        fired = FAULTS.fired("replay.dispatch")
    finally:
        FAULTS.reset()
    n = drv.breaker_threshold
    if not (fired == n == drv.device_errors and drv.breaker_tripped and drv.device_steps == 0
            and drv.fallback_steps == len(res.steps)):
        raise AssertionError(f"{what}, breaker: fired {fired}, {drv.stats()}")
    print(f"  {what}, every dispatch failing: the lock; the breaker opened after {fired} dispatches, "
          f"{drv.unsupported.get('breaker_open', 0)} windows per-pass behind it, all {drv.fallback_steps} steps "
          f"per-pass; wall {wall:.2f} s {card}", flush=True)
    out["breaker"] = {"opened_after": fired, "breaker_open_windows": drv.unsupported.get("breaker_open", 0),
                      "wall_s": wall}

    # Streaming ingest: a synthetic Borg trace onto 2000 nodes.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        path = os.path.join(tmp, "synthetic_borg.jsonl")
        synthetic_borg(path, STREAM_RECORDS, seed=0)
        kw = dict(nodes=STREAM_NODES, max_events=STREAM_EVENTS, seed=0, ops_per_step=100)
        rkw = dict(max_pods_per_pass=1024, pod_bucket_min=128, device_segment_steps=SEGMENT_K)
        stream = stream_trace_operations(path, "borg", **kw)
        runner, rs, wall_s = trace_run(stream, device_replay=True, **rkw)
        sstats = stream.stats()
        drv_s = runner.replay_driver
        t = time.perf_counter()
        ops = trace_operations(path, "borg", **kw)
        compile_s = time.perf_counter() - t
        runner_m, rm, wall_m = trace_run(list(ops), device_replay=True, **rkw)
        drv_m = runner_m.replay_driver
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts_s = (rs.events_applied, rs.pods_scheduled, rs.unschedulable_attempts)
    counts_m = (rm.events_applied, rm.pods_scheduled, rm.unschedulable_attempts)
    if counts_s != counts_m or step_triples(rs) != step_triples(rm):
        raise AssertionError(f"streamed trace {counts_s} differs from materialized {counts_m}")
    if drv_s.fallback_steps or drv_m.fallback_steps or sstats["fallback"]:
        raise AssertionError(f"streamed trace: per-pass steps {drv_s.fallback_steps} / {drv_m.fallback_steps}, "
                             f"{drv_s.unsupported} {drv_m.unsupported}, producer fallback {sstats['fallback']}")
    pre = drv_s.stats()["prelower"]
    print(f"  synthetic Borg trace ({STREAM_RECORDS} records, seed 0) on {STREAM_NODES} nodes, {rs.events_applied} "
          f"events in {len(rs.steps)} steps: streamed {rs.pods_scheduled} scheduled / {rs.unschedulable_attempts} "
          f"unschedulable, equal to the materialized run step for step, 0 per-pass steps; streamed wall "
          f"{wall_s:.2f} s ({rs.events_applied / wall_s:.0f} events/s, ingest included), materialized "
          f"{wall_m:.2f} s after a {compile_s:.2f} s compile; producer windows {sstats['windows']}, queue peak "
          f"{sstats['queue_peak']}; ingest prefetches {drv_s.ingest_prefetches}; prelower {pre} {card}", flush=True)
    out["stream"] = {"events": rs.events_applied, "steps": len(rs.steps), "counts": counts_s[1:],
                     "wall_s": wall_s, "events_per_s": rs.events_applied / wall_s, "materialized_wall_s": wall_m,
                     "compile_s": compile_s, "windows": sstats["windows"], "queue_peak": sstats["queue_peak"],
                     "ingest_prefetches": drv_s.ingest_prefetches, "device_round_trips": drv_s.device_round_trips}

    # borg_mini: the trace lock, streamed and materialized.
    mini = {}
    for mode in ("streamed", "materialized"):
        src = (stream_trace_operations(BORG_MINI, "borg", nodes=24, ops_per_step=2, window=8, queue_windows=2)
               if mode == "streamed" else list(trace_operations(BORG_MINI, "borg", nodes=24, ops_per_step=2)))
        runner, res, wall = trace_run(src, device_replay=True, pod_bucket_min=64)
        got = (res.events_applied, res.pods_scheduled, res.unschedulable_attempts)
        drv = runner.replay_driver
        if got != BORG_MINI_LOCK or drv.fallback_steps:
            raise AssertionError(f"borg_mini {mode}: {got} against {BORG_MINI_LOCK}, {drv.fallback_steps} per-pass")
        mini[mode] = step_triples(res)
        print(f"  borg_mini on 24 nodes, {mode}: {got[0]} events, {got[1]} scheduled, {got[2]} unschedulable "
              f"(the lock), {drv.device_steps} steps on the card in {wall:.2f} s {card}", flush=True)
    if mini["streamed"] != mini["materialized"]:
        raise AssertionError("borg_mini: streamed and materialized steps differ")
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s {card}", flush=True)
    return out


def completed_d_phase(check: Check, card: str) -> dict:
    """Phase 8; returns kernel D's measurements in its preemption +
    full-record form."""
    t8 = time.perf_counter()
    segments = []
    kernel = replay_mod.replay_segment

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments.append((st, prog, const, ev, held, final, outs))
        return final, outs

    def plain_equal(what: str, segs) -> None:
        for i, (st, prog, const, ev, state0, final, outs) in enumerate(segs):
            want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
            tree_equal(check, "replay_segment", f"{what} segment {i} outputs", outs, want_outs)
            tree_equal(check, "replay_segment", f"{what} segment {i} final state", final, want_final)

    replay_mod.replay_segment = capture
    try:
        for case in PREEMPTION_CASES:
            segments.clear()
            nodes, victims, pre = case_objects(case)
            store = ClusterStore()
            for n in nodes:
                store.create("nodes", n)
            for v in victims:
                store.create("pods", v)
            runner = ScenarioRunner(store=store, preemption=True, device_replay=True, device_segment_steps=4,
                                    exact=False, device=DEVICE)
            evicted = []
            runner.service.add_eviction_listener(lambda ns, nm: evicted.append(nm))
            runner.run(iter([Operation(step=1, op="create", kind="pods", obj=pre)]))
            nominated = store.get("pods", "preemptor").get("status", {}).get("nominatedNodeName")
            if (runner.replay_driver.device_steps < 1 or nominated != case["expected_nominated"]
                    or evicted != case["expected_victims"] or not all(s[0].preempt for s in segments)):
                raise AssertionError(f"preemption fixture {case['name']}: nominated {nominated}, evicted "
                                     f"{evicted}, {runner.replay_driver.unsupported}")
            plain_equal(f"fixture {case['name']}", segments)
        print(f"  the {len(PREEMPTION_CASES)} preemption fixtures: the hand-derived nominations and victims "
              f"through kernel D's victim search; D equals its plain version on each", flush=True)
        strata = {}
        for record in ("selection", "full"):
            outcome = {}
            for device_replay in (True, False):
                segments.clear()
                runner = ScenarioRunner(preemption=True, record=record, device_replay=device_replay,
                                        device_segment_steps=4, exact=False, device=DEVICE)
                evicted = []
                runner.service.add_eviction_listener(lambda ns, nm: evicted.append(nm))
                res = runner.run(priority_strata_stream())
                outcome[device_replay] = (step_triples(res), store_view(runner), evicted)
                if device_replay:
                    drv = runner.replay_driver
                    if drv.device_steps < 8 or drv.unsupported or not any(s[0].preempt for s in segments):
                        raise AssertionError(f"strata churn {record}: {drv.device_steps} steps, {drv.unsupported}")
                    plain_equal(f"strata churn {record}", segments)
                    strata[record] = list(segments)
            if outcome[True] != outcome[False] or not outcome[True][2]:
                raise AssertionError(f"strata churn {record}: the device path differs from the per-pass path")
            print(f"  priority-strata churn, record={record}: device path equals per-pass "
                  f"({len(outcome[True][2])} evictions, in order); D equals its plain version", flush=True)
        segments.clear()
        kw = dict(record="full", max_pods_per_pass=64, pod_bucket_min=32, exact=False, device=DEVICE)
        dev = ScenarioRunner(**kw, device_replay=True, device_segment_steps=8)
        dev_res = dev.run(churn_scenario(0, n_nodes=24, n_events=160, ops_per_step=16))
        base = ScenarioRunner(**kw)
        base_res = base.run(churn_scenario(0, n_nodes=24, n_events=160, ops_per_step=16))
        if (dev.replay_driver.device_steps < 4 or step_triples(dev_res) != step_triples(base_res)
                or store_view(dev) != store_view(base)):
            raise AssertionError("record=full churn: the device path's annotations differ from the per-pass path")
        plain_equal("record=full churn", segments)
        n_annotated = sum(1 for p in dev.store.list("pods") if p["metadata"].get("annotations"))
        print(f"  record=full churn (24 nodes): {n_annotated} pods' annotations equal the per-pass path's; "
              f"D equals its plain version on its {len(segments)} segments", flush=True)
    finally:
        replay_mod.replay_segment = kernel

    preempt = preemption_churn_phase(check, card)

    # D in its preemption + full-record form: the strata churn's segment
    # with the most victim searches.
    segs = strata["full"]
    pick = max(range(len(segs)), key=lambda i: int((segs[i][6]["nom"] >= 0).sum()))
    st, prog, const, ev, state0, final, outs = segs[pick]
    ms = cuda_ms(lambda: kernel(st, prog, const, ev, state0), reps=5)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with PairCount(prog, const["pods"]["requests"].shape[0]) as count:
        start.record()
        replay_segment_plain(st, prog, const, ev, state0)
        end.record()
        torch.cuda.synchronize()
    n_bytes, n_ops = segment_work(st, prog, const, ev, state0, outs, final, (count.pairs, count.feasible))
    bound, by = bound_ms(n_bytes, n_ops)
    P = const["pods"]["requests"].shape[0]
    N = const["node"]["allocatable"].shape[0]
    shape = (f"K={st.k} x Q={st.q} x {N} nodes x {P} pod rows, record=full, {int((outs['nom'] >= 0).sum())} "
             f"nominations; pairs counted in the plain version's chain only ({count.pairs})")
    print(f"  replay_segment (kernel D) with the victim search and record=full, {shape}: {ms:.3f} ms per launch; "
          f"plain {start.elapsed_time(end):.1f} ms; bound {bound:.5f} ms by {by} {card}")
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s", flush=True)
    return {"preempt_full_ms": ms, "preempt_full_plain_ms": start.elapsed_time(end),
            "preempt_full_bound_ms": bound, "preempt_full_shape": shape, **preempt}


def preemption_churn_phase(check: Check, card: str) -> dict:
    """The preemption-heavy churn at PREEMPT_NODES nodes: the device path
    (kernel D's victim search) against the per-pass path."""
    t = time.perf_counter()
    segments = []
    kernel = replay_mod.replay_segment

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments.append((st, prog, const, ev, held, final, outs))
        return final, outs

    outcome, walls = {}, {}
    for device_replay in (True, False):
        runner = ScenarioRunner(preemption=True, device_replay=device_replay, device_segment_steps=SEGMENT_K,
                                max_pods_per_pass=1024, pod_bucket_min=128, exact=False, device=DEVICE)
        evicted = []
        runner.service.add_eviction_listener(lambda ns, nm: evicted.append(nm))
        replay_mod.replay_segment = capture if device_replay else kernel
        t0 = time.perf_counter()
        try:
            res = runner.run(preemption_churn_stream(n_nodes=PREEMPT_NODES, n_waves=PREEMPT_WAVES))
        finally:
            replay_mod.replay_segment = kernel
        walls[device_replay] = time.perf_counter() - t0
        outcome[device_replay] = (step_triples(res), store_view(runner), evicted)
        if device_replay:
            drv = runner.replay_driver
            scheduled, unsched = res.pods_scheduled, res.unschedulable_attempts
    if outcome[True] != outcome[False]:
        raise AssertionError(f"{PREEMPT_NODES}-node preemption churn: the device path differs from the per-pass path")
    nominating = [seg for seg in segments if seg[0].preempt and bool((seg[6]["nom"] >= 0).any())]
    if not nominating:
        raise AssertionError(f"{PREEMPT_NODES}-node preemption churn: no device segment's kernel D nominated "
                             f"({drv.unsupported})")
    st, prog, const, ev, state0, final, outs = nominating[0]
    want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
    tree_equal(check, "replay_segment", "preemption churn's nominating segment outputs", outs, want_outs)
    tree_equal(check, "replay_segment", "preemption churn's nominating segment final state", final, want_final)
    overflow = drv.unsupported.get("preemption_overflow", 0)
    evictions = len(outcome[True][2])
    print(f"  preemption churn, {PREEMPT_NODES} nodes: device path equals per-pass ({scheduled} scheduled, "
          f"{unsched} unschedulable, {evictions} evictions in order); {drv.device_steps} steps on the card, "
          f"{drv.fallback_steps} per-pass, {len(nominating)} device segments nominated "
          f"({int((outs['nom'] >= 0).sum())} nominations in the first, equal to D's plain version); "
          f"preemption_overflow fallbacks {overflow}; walls device {walls[True]:.1f} s, per-pass "
          f"{walls[False]:.1f} s ({time.perf_counter() - t:.1f} s) {card}", flush=True)
    return {"preempt_churn": {"nodes": PREEMPT_NODES, "evictions": evictions, "nominating_segments": len(nominating),
                              "device_steps": drv.device_steps, "fallback_steps": drv.fallback_steps,
                              "preemption_overflow": overflow}}


T0 = time.perf_counter()


def renewable_provider(seed: int):
    """Phase 11's data provider: a per-node value in 0..100, made from
    ``seed`` with numpy, in the order of the nodes it is given."""

    def provide(nodes):
        return np.random.default_rng(seed).integers(0, 101, size=len(nodes))

    return provide


def sample_profile(feats, provider):
    """The default profile plus NodeNumber (weight 1) and one
    DataProviderScore "Renewable" (weight 2)."""
    return default_plugins(feats) + (
        node_number_builder(weight=1)(feats, {}),
        data_provider_builder("Renewable", provider, weight=2)(feats, {}),
    )


def _suffix(name: str) -> int:
    digits = name[len(name.rstrip("0123456789")):]
    return int(digits) if digits else 0


class ParityExtender(BaseHTTPRequestHandler):
    """Phase 11's webhook: its filter drops the nodes whose name ends in an
    odd digit, its prioritize gives int(suffix) % 11."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        names = body.get("nodenames") or [n["metadata"]["name"] for n in (body.get("nodes") or {}).get("items", [])]
        if self.path.endswith("/filter"):
            odd = [n for n in names if n[-1:].isdigit() and int(n[-1]) % 2 == 1]
            out = {"nodenames": [n for n in names if n not in set(odd)],
                   "failedNodes": {n: "odd digit suffix" for n in odd}}
        else:
            out = [{"host": n, "score": _suffix(n) % 11} for n in names]
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def _launches() -> dict:
    return {"schedule_scan": schedule_scan.launches, "schedule_sampled": schedule_sampled.launches,
            "batch_eval": batch_eval.launches, "replay_segment": replay_segment.launches,
            "replay_segment_fleet": replay_segment_fleet.launches}


def _zero_launches() -> None:
    for wrapper in (schedule_scan, schedule_sampled, batch_eval, node_summary, replay_segment, replay_segment_fleet):
        wrapper.launches = 0


# Which stage of kernel E each recorded field of a staged entry point
# comes out of last.
STAGED_FIELDS = {"reason_bits": "chain_filter", "scores": "chain_score", "final_scores": "chain_select",
                 "total": "chain_select", "selected": "chain_select", "visited": "chain_window"}


def staged_results(check: Check, what: str, got, want) -> None:
    """A staged entry point's result (record="full" or "final") against
    the same profile through kernel E's plain versions, each field under
    the stage that writes it."""
    for name, kernel in STAGED_FIELDS.items():
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None):
            raise AssertionError(f"{what}.{name}: recorded by one side only")
        if a is not None:
            check.equal(kernel, f"{what}.{name}", a, b)
    if got.sampling_next_start != want.sampling_next_start:
        raise AssertionError(f"{what}: next start {got.sampling_next_start} vs {want.sampling_next_start}")


# The tables each plugin's code reads in a stage of kernel E (csrc/
# plugin_chain.cuh): "state.<field>" of the node state, "pods.<field>" of
# the pod rows, "<aux family>.<key>" ("spread.con_*": every constraint
# table) and "carry.<plugin>[.<key>]".  A stage is charged the tables of
# its own rows and no others.  The profile's own small tables (the fit
# spec, the volume-limit pools, the spread keys' sizes) are left out.
_TAINT_FILTER = ("taints.node_taint_order", "taints.forbidding", "taints.pod_tolerated")
_AFFINITY_FILTER = ("affinity.term_ok", "affinity.selector_term", "affinity.has_required",
                    "affinity.required_terms")
_FIT_SCORE = ("state.allocatable", "state.nonzero_requested", "pods.nonzero_requests")
_SPREAD = ("spread.node_ldom", "spread.con_*", "spread.has_score_con")
_INTERPOD = ("interpod.req_aff", "interpod.req_anti", "interpod.pod_term_match", "interpod.pref_w",
             "interpod.self_aff", "carry.InterPodAffinity.cnt", "carry.InterPodAffinity.total")
STAGE_READS = {
    "NodeUnschedulable": {"filter": ("state.unschedulable", "pods.tolerates_unschedulable")},
    "NodeName": {"filter": ("nodename.pod_req_node",)},
    "TaintToleration": {"filter": _TAINT_FILTER,
                        "score": ("taints.node_taint_order", "taints.prefer", "taints.pod_tolerated_prefer")},
    "NodeAffinity": {"filter": _AFFINITY_FILTER + ("affinity.added_terms", "affinity.has_added"),
                     "score": ("affinity.term_ok", "affinity.preferred_weights", "affinity.added_pref")},
    "NodePorts": {"filter": ("nodeports.pod_wants", "carry.NodePorts")},
    "NodeResourcesFit": {"filter": ("state.allocatable", "state.requested", "state.allowed_pods", "state.pod_count",
                                    "pods.requests", "pods.has_requests"),
                         "score": _FIT_SCORE},
    "NodeResourcesBalancedAllocation": {"score": _FIT_SCORE},
    "ImageLocality": {"score": ("imagelocality.node_has_image", "imagelocality.image_size",
                                "imagelocality.image_num_nodes", "imagelocality.total_nodes_f",
                                "imagelocality.pod_image_count", "imagelocality.pod_num_containers")},
    "VolumeRestrictions": {"filter": ("volumes.pod_rwop", "volumes.pod_disk_any", "volumes.pod_disk_rw",
                                      "volumes.disk_ro_shareable", "carry.VolumeRestrictions")},
    "NodeVolumeLimits": {"filter": ("volumes.limits", "volumes.vol_key", "volumes.pod_vol", "carry.NodeVolumeLimits")},
    "VolumeBinding": {"filter": ("volumes.pod_pv", "volumes.pv_node_ok", "volumes.pod_wffc", "volumes.pvc_cand_ok",
                                 "volumes.pvc_provisionable", "volumes.pod_fail")},
    "VolumeZone": {"filter": ("volumes.pod_pv", "volumes.pv_zone_ok")},
    "PodTopologySpread": {"filter": _SPREAD + ("state.valid", "carry.PodTopologySpread"),
                          "score": _SPREAD + ("state.valid", "carry.PodTopologySpread", "spread.log_w"),
                          "normalize": _SPREAD},
    "InterPodAffinity": {"filter": _INTERPOD + ("interpod.dom_t", "interpod.term_tk", "carry.InterPodAffinity.ecnt"),
                         "score": _INTERPOD + ("carry.InterPodAffinity.ew",)},
    "NodeNumber": {"score": ("nodenumber.node_digit", "nodenumber.pod_digit")},
}


def stage_bytes(sub, stage: str, state, pods, aux: dict, carries: dict, *extra) -> int:
    """The bytes kernel E's ``stage`` ("filter", "score" or "normalize")
    over the pod rows ``pods`` (a PodView) must read and write for the
    rows of the sub-profile ``sub``: the tables STAGE_READS gives its
    plugins (each node-side one whole, B rows of each per-pod one), the
    pods' index, and ``extra`` (its other inputs and its outputs).  A
    spread row that honors the node's affinity or taints for one of these
    pods reads those filters' tables too; DataProviderScore reads its
    [N] scores."""
    B, N = pods.index.shape[0], state.valid.shape[0]
    P_all = aux["nodename"]["pod_req_node"].shape[0]
    if P_all == N:
        raise ValueError("stage_bytes tells per-pod tables from node-side ones by their rows: P != N is needed")
    rows = sub.filters if stage == "filter" else sub.scores
    names, n = set(), tensor_bytes(extra) + tensor_bytes([pods.index])
    for sp in rows:
        plugin = sp.plugin
        sid = chain.sample_id(plugin)
        if sid == chain.SAMPLE_IDS["DataProviderScore"]:
            n += 4 * N
            continue
        name = ("NodeNumber" if sid is not None else "NodeVolumeLimits" if chain.is_volume_limits(plugin)
                else plugin.name)
        names.update(STAGE_READS[name].get(stage, ()))
        if name == "PodTopologySpread" and stage != "normalize":
            con = {k: aux["spread"][k][pods.index.long()] for k in ("con_valid", "con_honor_aff", "con_honor_taints")}
            if bool((con["con_valid"] & con["con_honor_aff"]).any()):
                names.update(_AFFINITY_FILTER)
            if bool((con["con_valid"] & con["con_honor_taints"]).any()):
                names.update(_TAINT_FILTER)
    tables = []
    for name in sorted(names):
        src, key = name.split(".", 1)
        if src == "state":
            tables.append(getattr(state, key))
        elif src == "pods":
            tables.append(getattr(pods, key))
        elif src == "carry":
            plugin, _, part = key.partition(".")
            if plugin == "NodeVolumeLimits":
                plugin = chain.volume_limits_carry(sub)
            c = carries[plugin]
            tables.extend([c[part]] if part else (c.values() if isinstance(c, dict) else [c]))
        elif key == "log_w":
            tables.append(aux[src]["log_w64" if sub.exact else "log_w32"])
        else:
            tables.extend(t for k, t in aux[src].items() if k == key or (key.endswith("*") and k.startswith(key[:-1])))
    for t in tables:
        full = tensor_bytes(t)
        n += full * B // P_all if t.dim() and t.shape[0] == P_all else full
    return n


def cupti_ms(fn, reps: int, kernel: str) -> float:
    """Mean milliseconds of one launch of the CUDA kernel whose name holds
    ``kernel``, from CUPTI's kernel records in a torch.profiler trace of
    ``reps`` calls of ``fn`` (after one untraced call): the card's time
    alone, without the host's time between launches.  A session whose
    trace holds other than ``reps`` records (CUPTI dropped one) is traced
    again, up to three sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="ksim-stage-trace-") as d:
            path = Path(d) / "stage.pt.trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        durs = [float(e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("cat") == "kernel" and kernel in str(e.get("name"))]
        if len(durs) == reps:
            return sum(durs) / reps / 1e3
    raise AssertionError(f"CUPTI recorded {len(durs)} launches of {kernel} in {reps} calls, in each of three sessions")


def stage_by_stage(check: Check, staged: StagedProgram, state, batch, aux: dict, carries: dict, n_real: int) -> None:
    """Each of kernel E's stages against its plain version on the same
    inputs: every launch group of ``staged`` (its hooks applied as the
    route applies them) over the pods of ``batch``, E4's selection, and
    the visit window and committing selection of its first pods."""
    view = batch.view()
    for g in staged.filter_groups:
        if g.sub is None:
            continue
        f_state, f_pods = state, view
        if g.own and g.sps[0].extender is not None and g.sps[0].extender.before_filter is not None:
            f_state, f_pods = g.sps[0].extender.before_filter(state, view, aux)
        got = chain_stages.filter_stage(g.sub, f_state, f_pods, aux, carries)
        want = chain_stages.filter_stage_plain(g.sub, f_state, f_pods, aux, carries)
        for part, a, b in zip(("codes", "ok"), got, want):
            check.equal("chain_filter", f"E1 rows {g.rows} {part}", a.cpu().numpy(), b.cpu().numpy())
    ok, _ = staged.eval_filters(state, view, aux, carries)
    ok = ok.contiguous()
    for g in staged.score_groups:
        if g.sub is None:
            continue
        s_state, s_pods = state, view
        if g.own and g.sps[0].extender is not None and g.sps[0].extender.before_score is not None:
            s_state, s_pods = g.sps[0].extender.before_score(state, view, aux)
        raw = chain_stages.score_stage(g.sub, s_state, s_pods, aux, carries, ok)
        want = chain_stages.score_stage_plain(g.sub, s_state, s_pods, aux, carries, ok)
        check.equal("chain_score", f"E2 rows {g.rows}", raw.cpu().numpy(), want.cpu().numpy())
        norm = chain_stages.normalize_stage(g.sub, s_state, s_pods, aux, carries, raw, ok)
        want = chain_stages.normalize_stage_plain(g.sub, s_state, s_pods, aux, carries, raw, ok)
        check.equal("chain_normalize", f"E3 rows {g.rows}", norm.cpu().numpy(), want.cpu().numpy())
    _, norms = staged.eval_scores(state, view, aux, carries, ok)
    norm = torch.stack([x.to(torch.int64) for x in norms], dim=1)
    weights = staged._weights_on(ok.device)
    P, N = ok.shape
    _, final_dtype, _ = staged.prog.dtypes

    def outs(rows):
        return {"selected": torch.empty(rows, dtype=torch.int32, device=DEVICE),
                "total": torch.empty((rows, N), dtype=torch.int32, device=DEVICE),
                "final": torch.empty((rows, norm.shape[1], N), dtype=final_dtype, device=DEVICE)}

    got, want = outs(P), outs(P)
    chain_stages.select_stage(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, got)
    chain_stages.select_stage_plain(staged.commit_sub, state, batch, aux, carries, norm, weights, ok, want)
    for key in got:
        check.equal("chain_select", f"E4 select {key}", got[key].cpu().numpy(), want[key].cpu().numpy())
    k_state, k_carries = chain.fresh_scan_state(staged.prog, state, carries)
    p_state, p_carries = chain.fresh_scan_state(staged.prog, state, carries)
    start_k = torch.tensor([n_real - 3], dtype=torch.int32, device=DEVICE)
    start_p = start_k.clone()
    for i in range(8):
        pod = batch.rows(i, i + 1)
        got_w = chain_stages.window_stage(ok[i:i + 1], start_k, pod.valid, n_real, SAMPLING_K)
        want_w = chain_stages.window_stage_plain(ok[i:i + 1], start_p, pod.valid, n_real, SAMPLING_K)
        start_k, start_p = got_w[2], want_w[2]
        for part, a, b in zip(("sample", "visited", "next start"), got_w, want_w):
            check.equal("chain_window", f"E4 window pod {i} {part}", a.cpu().numpy(), b.cpu().numpy())
        got, want = outs(1), outs(1)
        chain_stages.select_stage(staged.commit_sub, k_state, pod, aux, k_carries, norm[i:i + 1], weights,
                                  ok[i:i + 1], got, commit=True)
        chain_stages.select_stage_plain(staged.commit_sub, p_state, pod, aux, p_carries, norm[i:i + 1], weights,
                                        ok[i:i + 1], want, commit=True)
        check.equal("chain_select", f"E4 commit pod {i} selected", got["selected"].cpu().numpy(),
                    want["selected"].cpu().numpy())
    same_state("chain_select", "E4 commit", check, host_state(k_state), p_state)
    for name, want_c in p_carries.items():
        got_c = k_carries[name]
        for key in (want_c if isinstance(want_c, dict) else [None]):
            a = got_c if key is None else got_c[key]
            b = want_c if key is None else want_c[key]
            check.equal("chain_select", f"E4 commit carry {name} {key or ''}", a.cpu().numpy(), b.cpu().numpy())


def staged_legs(check: Check, card: str, feats, a_selected, a_ms: float, nodes, pods, log=print) -> dict:
    """Phase 11 (d) (i)-(iii): hooked profiles on the card, through kernel
    E's stages (the "staged" route).  (i) identity hooks on all six device
    fields of every default plugin, the main path's whole queue in
    selection mode, equal to kernel A's selections of phase 4; (ii) the
    hooked profile of tests/test_torch_hooks.py (test_torch_clusters.
    torch_hooks) through the scan on a full-record prefix, the sampled scan
    on it, a 2048-pod full-record batch chunk and the fused batch (final)
    over the whole queue, each against the same profile through kernel E's
    plain versions on the card, and each stage against its plain version
    on one block of pods; (iii) one SchedulerService pass with that profile
    equal to its CPU run.  It runs beside phase 12's commands (other
    processes: kernel E's counts are this process's launches alone) and
    writes its lines to ``log``.  Returns what ``staged_timings`` needs."""
    td = time.perf_counter()
    hooks = torch_hooks()
    plugins = default_plugins(feats)
    feats_pre = Featurizer().featurize(nodes, pods[:SAMPLES_PREFIX])
    feats_2k = Featurizer().featurize(nodes, pods[:PREFIX])
    profiles = {
        "ident": (feats, hooked_profile(plugins, identity_hooks(plugins))),
        "pre": (feats_pre, hooked_profile(default_plugins(feats_pre), hooks)),
        "2k": (feats_2k, hooked_profile(default_plugins(feats_2k), hooks)),
        "main": (feats, hooked_profile(plugins, hooks)),
    }
    legs = {  # name: (profile, record, sampling_k)
        "(i) identity-hooked whole queue, selection": ("ident", "selection", None),
        f"(ii) scan, {SAMPLES_PREFIX}-pod prefix, full": ("pre", "full", None),
        f"(ii) sampled scan k={SAMPLING_K}, {SAMPLES_PREFIX}-pod prefix, full": ("pre", "full", SAMPLING_K),
        f"(ii) evaluate_batch, {PREFIX}-pod chunk, full": ("2k", "full", None),
        "(ii) evaluate_batch_fused, whole queue, final": ("main", "final", None),
    }
    engines = {}
    for leg, (prof, record, k) in legs.items():
        f, pl = profiles[prof]
        engines[leg] = Engine(f, pl, record=record, exact=True, device=DEVICE, sampling_k=k)
        if engines[leg].route != "staged":
            raise AssertionError(f"{leg}: route {engines[leg].route!r} on the card, not 'staged'")

    def drive(leg, eng):
        if "evaluate_batch_fused" in leg:
            return eng.evaluate_batch_fused()
        if "evaluate_batch" in leg:
            return eng.evaluate_batch()
        return eng.schedule(sampling_start=0)[0]

    torch.cuda.synchronize()
    _zero_launches()
    chain_stages.reset_launches()
    results, walls = {}, {}
    for leg, eng in engines.items():
        t = time.perf_counter()
        results[leg] = drive(leg, eng)
        walls[leg] = time.perf_counter() - t
    launched = chain_stages.launches()
    fused = _launches()
    log(f"  staged route: kernel E launches {launched}; kernels A-D {fused} {card}")
    if any(fused.values()):
        raise AssertionError(f"a staged profile launched a fused kernel: {fused}")
    for name, stage in STAGE_KERNELS.items():
        if launched[stage] < 1:
            raise AssertionError(f"{name} (kernel E, {stage}) was not launched on the staged route")
    ident = "(i) identity-hooked whole queue, selection"
    check.equal("chain_select", "(i) identity-hooked whole queue selected vs kernel A", results[ident].selected,
                a_selected)
    n_pods = len(feats.pods.keys)
    staged_i = engines[ident]._staged
    log(f"  (i) identity hooks on all six fields of the 14 plugins: the whole queue ({n_pods} pods) through "
        f"kernel E equals kernel A's selections; {staged_i.launches_per_pod()} launches per pod; wall "
        f"{walls[ident]:.2f} s (beside phase 12's commands) against kernel A's {a_ms / 1e3:.3f} s {card}")
    for leg, eng in engines.items():
        if leg == ident:
            continue
        prof, record, k = legs[leg]
        f, pl = profiles[prof]
        plain = PlainEngine(f, pl, record=record, exact=True, device=DEVICE, sampling_k=k)
        staged_results(check, leg, results[leg], drive(leg, plain))
        log(f"  {leg}: equal to kernel E's plain versions ({walls[leg]:.2f} s)")
    # Stage by stage on the main path's first block of pods, hooked.
    staged_main = engines["(ii) evaluate_batch_fused, whole queue, final"]._staged
    e_main = engines["(ii) evaluate_batch_fused, whole queue, final"]
    state, batch, aux = e_main._node_state, e_main._pods.rows(0, STAGE_BLOCK), e_main._aux
    carries = e_main._prog.init_carries(aux)
    n_real = len(feats.nodes.names)
    stage_by_stage(check, staged_main, state, batch, aux, carries, n_real)
    log(f"  (ii) stage by stage on {STAGE_BLOCK} pods x {state.valid.shape[0]} nodes: E1-E4 equal their plain "
        f"versions (max |diff| {[check.max_err[k] for k in STAGE_KERNELS]})")

    # (iii) one SchedulerService pass with the hooked profile, card vs CPU.
    t3 = time.perf_counter()
    nodes_s, pods_s = random_cluster(2, *HOOK_SHAPE, bound_fraction=0.0)
    placed = {}
    for device in (DEVICE, "cpu"):
        store = ClusterStore()
        for obj in nodes_s:
            store.create("nodes", obj)
        for obj in pods_s:
            store.create("pods", obj)
        svc = SchedulerService(store, plugins_factory=lambda f: hooked_profile(default_plugins(f), hooks),
                               record="selection", device=device)
        t = time.perf_counter()
        placed[device] = (svc.schedule_pending(), time.perf_counter() - t)
    if placed[DEVICE][0] != placed["cpu"][0]:
        raise AssertionError("(iii) the hooked service pass on the card differs from its CPU run")
    n_bound = sum(v is not None for v in placed[DEVICE][0].values())
    log(f"  (iii) hooked SchedulerService pass, {HOOK_SHAPE[0]} nodes x {len(pods_s)} pods: {n_bound} bound, "
        f"equal to its CPU run; pass {placed[DEVICE][1]:.2f} s on the card, {placed['cpu'][1]:.2f} s on the CPU "
        f"({time.perf_counter() - t3:.1f} s) {card}")
    per_pod = {"(i) identity hooks": staged_i.launches_per_pod(),
               "(ii) hooked": engines[f"(ii) scan, {SAMPLES_PREFIX}-pod prefix, full"]._staged.launches_per_pod()}
    log(f"  (i)-(iii) took {time.perf_counter() - td:.1f} s beside phase 12's commands {card}")
    return {"e_main": e_main, "state": state, "aux": aux, "carries": carries, "n_real": n_real, "launched": launched,
            "walls": walls, "ident": ident, "n_pods": n_pods, "a_ms": a_ms, "per_pod": per_pod, "nodes": nodes,
            "pods": pods}


def cluster_holds(check: Check, subs, state, pods, aux: dict, carries: dict, weights, n_real: int) -> dict:
    """E1, E2, E3 and E4's selection against their plain versions on the
    pod rows of ``pods`` (a PodBatch), at the cluster size the launch picks
    for them (key 0) and on a forced cluster of one block (key 1); with
    one pod, the committing selection too, on a copy of the state and the
    carries, and E4's window from the rotating start n_real - 3 (on a
    cluster of one the walk crosses every tile and wraps).  ``subs`` are
    the filter, score and commit sub-profiles.  Returns what each launch
    ran."""
    fsub, ssub, csub = subs
    view = pods.view()
    B, N = view.index.shape[0], state.valid.shape[0]
    want_codes, want_ok = chain_stages.filter_stage_plain(fsub, state, view, aux, carries)
    want_raw = chain_stages.score_stage_plain(ssub, state, view, aux, carries, want_ok)
    want_norm = chain_stages.normalize_stage_plain(ssub, state, view, aux, carries, want_raw, want_ok)

    def outs():
        return {"selected": torch.empty(B, dtype=torch.int32, device=DEVICE),
                "total": torch.empty((B, N), dtype=torch.int32, device=DEVICE), "final": None}

    want_sel = outs()
    chain_stages.select_stage_plain(csub, state, pods, aux, carries, want_norm, weights, want_ok, want_sel)
    win_start = torch.tensor([n_real - 3], dtype=torch.int32, device=DEVICE)
    if B == 1:
        want_win = chain_stages.window_stage_plain(want_ok, win_start.clone(), pods.valid, n_real, SAMPLING_K)
    ran = {}
    for size in (0, 1):
        chain_stages.STAGE_CLUSTER = size
        try:
            codes, ok = chain_stages.filter_stage(fsub, state, view, aux, carries)
            raw = chain_stages.score_stage(ssub, state, view, aux, carries, ok)
            norm = chain_stages.normalize_stage(ssub, state, view, aux, carries, raw, ok)
            sel = outs()
            chain_stages.select_stage(csub, state, pods, aux, carries, norm, weights, ok, sel)
            ran[size] = {name: dict(getattr(chain_stages, f"{STAGE_KERNELS[name]}_stage").last)
                         for name in STAGE_KERNELS if name != "chain_window"}
            if B == 1:
                win = chain_stages.window_stage(ok, win_start.clone(), pods.valid, n_real, SAMPLING_K)
                ran[size]["chain_window"] = dict(chain_stages.window_stage.last)
                k_state, k_carries = chain.fresh_scan_state(csub, state, carries)
                p_state, p_carries = chain.fresh_scan_state(csub, state, carries)
                got_c, want_c = outs(), outs()
                chain_stages.select_stage(csub, k_state, pods, aux, k_carries, norm, weights, ok, got_c, commit=True)
                ran[size]["chain_select_commit"] = dict(chain_stages.select_stage.last)
                chain_stages.select_stage_plain(csub, p_state, pods, aux, p_carries, want_norm, weights, want_ok,
                                                want_c, commit=True)
        finally:
            chain_stages.STAGE_CLUSTER = 0
        at = {name: f"{B} pods, cluster of {last['cluster']}" for name, last in ran[size].items()}
        check.equal("chain_filter", f"E1 at {at['chain_filter']} codes", codes.cpu().numpy(), want_codes.cpu().numpy())
        check.equal("chain_filter", f"E1 at {at['chain_filter']} ok", ok.cpu().numpy(), want_ok.cpu().numpy())
        check.equal("chain_score", f"E2 at {at['chain_score']}", raw.cpu().numpy(), want_raw.cpu().numpy())
        check.equal("chain_normalize", f"E3 at {at['chain_normalize']}", norm.cpu().numpy(), want_norm.cpu().numpy())
        for key in ("selected", "total"):
            check.equal("chain_select", f"E4 select at {at['chain_select']} {key}", sel[key].cpu().numpy(),
                        want_sel[key].cpu().numpy())
        if B == 1:
            for part, a, b in zip(("sample", "visited", "next start"), win, want_win):
                check.equal("chain_window", f"E4 window at {at['chain_window']} {part}", a.cpu().numpy(),
                            b.cpu().numpy())
            what = f"E4 committing select at {at['chain_select_commit']}"
            for key in ("selected", "total"):
                check.equal("chain_select", f"{what} {key}", got_c[key].cpu().numpy(), want_c[key].cpu().numpy())
            same_state("chain_select", what, check, host_state(k_state), p_state)
            for name, want_carry in p_carries.items():
                got_carry = k_carries[name]
                for key in (want_carry if isinstance(want_carry, dict) else [None]):
                    a = got_carry if key is None else got_carry[key]
                    b = want_carry if key is None else want_carry[key]
                    check.equal("chain_select", f"{what} carry {name} {key or ''}", a.cpu().numpy(), b.cpu().numpy())
    if any(last["cluster"] != 1 for last in ran[1].values()):
        raise AssertionError(f"kernel E's cluster stages at a forced cluster of one ran {ran[1]}")
    # What ran is what kernels/chain.py's mirror of the launch says.
    stage_subs = {"chain_filter": fsub, "chain_score": ssub, "chain_normalize": ssub, "chain_select": csub,
                  "chain_select_commit": csub}
    window_prm = chain.ChainParams()
    window_prm.N = N
    for size in ran:
        for name, last in ran[size].items():
            prm = window_prm if name == "chain_window" else stage_subs[name].kernel_tables["stage_params"][1]
            stage = STAGE_KERNELS[name.removesuffix("_commit")]
            mirror = (chain.stage_threads(prm.N, last["cluster"]), chain.stage_smem_bytes(prm, last["cluster"], stage))
            if (last["threads"], last["smem_bytes"]) != mirror:
                raise AssertionError(f"{name} ran {last}; kernels/chain.py's mirror says {mirror}")
    return ran


def commit_bytes(sub, pods, aux: dict, sel: int) -> int:
    """The bytes the commit (plugin_chain.cuh commit_pod) of pod 0 of
    ``pods`` onto node ``sel`` moves beside the selection: the chosen
    node's rows of the node state and of each carry the sub-profile has,
    read and written, and the pod's rows; when the pod carries inter-pod
    terms, InterPodAffinity's domain table whole, the pod's term rows, the
    term totals read and written, and the three counts of every (node,
    term) in the chosen node's domain, read and written (this run's data).
    None when nothing was committed."""
    if sel < 0:
        return 0
    prm = sub.kernel_tables["stage_params"][1]
    j = int(pods.index[0])
    node_ints, pod_bytes = 2 * prm.R + 1, 2 * 4 * prm.R
    for ptr, ints, pod_b in ((prm.port_counts, prm.V, 4 * prm.V), (prm.sp_counts, prm.SS, prm.SS),
                             (prm.attached, prm.VV, prm.VV), (prm.rwop, prm.RW + 2 * prm.DD, prm.RW + 2 * prm.DD)):
        if ptr:
            node_ints += ints
            pod_bytes += pod_b
    n = 2 * 4 * node_ints + pod_bytes
    a = aux["interpod"]
    if prm.ipa_cnt and bool((a["pod_term_match"][j] | (a["pod_vw"][j] != 0) | (a["pod_eat"][j] != 0)).any()):
        dom = a["dom_t"]
        db = dom[sel]
        matches = int(((dom == db) & (db >= 0)).sum())
        n += tensor_bytes(dom) + 9 * prm.T2 + 2 * 4 * prm.T2 + 2 * 3 * 4 * matches
    return n


def ptxas_usage(source: str, kernel: str) -> dict:
    """The registers, stack (local memory) and spill bytes per thread of
    ``kernel`` from nvcc's -Xptxas -v lines of ``source``'s build in this
    process (None where it did not build here)."""
    lines = build.BUILD_LOG.get(source, {}).get("ptxas", [])
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and kernel in ln:
            text = " ".join(lines[i + 1:i + 3])
            regs = re.search(r"Used (\d+) registers", text)
            stack = re.search(r"(\d+) bytes cumulative stack size", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            return {"registers": int(regs.group(1)) if regs else None,
                    "stack_bytes": int(stack.group(1)) if stack else 0,
                    "spill_store_bytes": int(spill.group(1)) if spill else 0}
    return {"registers": None, "stack_bytes": None, "spill_store_bytes": None}


def hooked_trace(card: str, legs: dict) -> dict:
    """Phase 11 (d): (i)'s profile (identity hooks on all six fields of
    every default plugin) over the queue's first TRACE_PODS pods, once
    untimed, once timed and once traced by torch.profiler (the card's
    records alone): the card's busy ms (the union of its kernel, copy and
    memset records) and its idle share over the traced pass's wall,
    beside the wall per pod untraced.  Runs after (iv)'s CUPTI sessions."""
    from torch.profiler import ProfilerActivity, profile

    feats = Featurizer().featurize(legs["nodes"], legs["pods"][:TRACE_PODS])
    plugins = default_plugins(feats)
    eng = Engine(feats, hooked_profile(plugins, identity_hooks(plugins)), record="selection", exact=True,
                 device=DEVICE)
    n_pods = len(feats.pods.keys)
    eng.schedule(sampling_start=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = eng.schedule(sampling_start=0)[0].selected
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        got = eng.schedule(sampling_start=0)[0].selected
        torch.cuda.synchronize()
        traced = time.perf_counter() - t
    if not np.array_equal(got, want):
        raise AssertionError("(i)'s traced stretch selected other nodes than its untraced run")
    names = {"E1": "filter_stage_kernel", "E2": "score_stage_kernel", "E3": "normalize_stage_kernel",
             "E4 select": "select_stage_kernel"}
    with tempfile.TemporaryDirectory(prefix="ksim-hooked-trace-") as d:
        prof.export_chrome_trace(str(Path(d) / "hooked.pt.trace.json"))
        dev = trace_device(Path(d), names)
    if dev["launches"]["E1"] < n_pods:
        raise AssertionError(f"(i)'s trace holds {dev['launches']['E1']} E1 launches for {n_pods} pods")
    out = {"pods": n_pods, "wall_s": wall, "traced_wall_s": traced, "busy_ms": dev["busy_ms"],
           "kernel_ms": dev["kernel_ms"], "copy_ms": dev["copy_ms"], "idle_share": 1 - dev["busy_ms"] / (traced * 1e3),
           "named_ms": dev["named_ms"], "launches": dev["launches"]}
    print(f"  (i)'s first {n_pods} pods traced (torch.profiler, the card's records): wall {wall * 1e3 / n_pods:.3f} ms "
          f"a pod untraced, {traced * 1e3 / n_pods:.3f} traced; the card busy {dev['busy_ms']:.2f} ms of the traced "
          f"{traced * 1e3:.1f} ms (idle {out['idle_share']:.2%}; kernels {dev['kernel_ms']:.2f} ms, copies and sets "
          f"{dev['copy_ms']:.2f}); by stage {({k: round(v, 3) for k, v in dev['named_ms'].items()})} ms in "
          f"{dev['launches']} launches {card}", flush=True)
    return out


def staged_timings(check: Check, card: str, legs: dict) -> dict:
    """Phase 11 (d) (iv), on a card no other process uses: E1, E2, E3 and
    E4's selection held against their plain versions at one pod and at
    STAGE_BLOCK pods, at the cluster the launch picks and at a forced
    cluster of one block, and the committing selection and E4's window at
    one pod (``cluster_holds``); each of kernel E's stages at the scan's shape
    (one pod, the whole default profile in one launch), and the committing
    selection there on a copy of the state: its kernel time from CUPTI's
    records (the cluster stages' also at a forced cluster of one), its
    wrapper's host time, its plain version and its bound; the same at
    the chunk's shape (STAGE_BLOCK pods); the launches per pod and the
    staged pass's wall beside kernel A's; then (i)'s traced stretch
    (``hooked_trace``).  ``legs`` is ``staged_legs``' value.  Returns the
    kernels line's entries for E1-E4."""
    td = time.perf_counter()
    e_main, state, aux, carries, n_real = (legs[k] for k in ("e_main", "state", "aux", "carries", "n_real"))
    launched, walls, ident, n_pods, a_ms, per_pod = (
        legs[k] for k in ("launched", "walls", "ident", "n_pods", "a_ms", "per_pod"))
    unhooked = StagedProgram(sched_prog(e_main), chain_stages.STAGES)
    fsub, ssub, csub = unhooked.filter_groups[0].sub, unhooked.score_groups[0].sub, unhooked.commit_sub
    w = unhooked._weights_on(state.valid.device)
    ops = pair_ops(e_main)
    F, S = len(fsub.filters), len(ssub.scores)
    N = state.valid.shape[0]
    measured, ran, cs1_ms = {}, {}, {}
    for B in (1, STAGE_BLOCK):
        pods_b = e_main._pods.rows(0, B)
        view = pods_b.view()
        ran[B] = cluster_holds(check, (fsub, ssub, csub), state, pods_b, aux, carries, w, n_real)
        print(f"  (iv) E1, E2, E3 and E4 select{' (and its commit, and E4 window)' if B == 1 else ''} at {B} x {N} "
              f"equal their plain versions on the launch's clusters {ran[B][0]} and on forced clusters of one "
              f"{ran[B][1]} {card}", flush=True)
        ok, _ = unhooked.eval_filters(state, view, aux, carries)
        ok = ok.contiguous()
        raw = chain_stages.score_stage(ssub, state, view, aux, carries, ok)
        norm = chain_stages.normalize_stage(ssub, state, view, aux, carries, raw, ok)
        out = {"selected": torch.empty(B, dtype=torch.int32, device=DEVICE),
               "total": torch.empty((B, N), dtype=torch.int32, device=DEVICE), "final": None}
        chain_stages.select_stage(csub, state, pods_b, aux, carries, norm, w, ok, out)
        sel = int(out["selected"][0])
        start = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        calls = {
            "chain_filter": lambda st: st.filter(fsub, state, view, aux, carries),
            "chain_score": lambda st: st.score(ssub, state, view, aux, carries, ok),
            "chain_normalize": lambda st: st.normalize(ssub, state, view, aux, carries, raw, ok),
            "chain_select": lambda st: st.select(csub, state, pods_b, aux, carries, norm, w, ok, out),
        }
        if B == 1:
            calls["chain_window"] = lambda st: st.window(ok, start.clone(), pods_b.valid, n_real, SAMPLING_K)
            # The scan's committing selection, each call committing the pod
            # again into a copy of the state and carries of its own.
            copies = {st: chain.fresh_scan_state(csub, state, carries)
                      for st in (chain_stages.STAGES, chain_stages.PLAIN_STAGES)}
            calls["chain_select_commit"] = lambda st: st.select(csub, copies[st][0], pods_b, aux, copies[st][1], norm,
                                                                w, ok, out, commit=True)
        pairs = B * n_real
        work = {
            "chain_filter": (stage_bytes(fsub, "filter", state, view, aux, carries, ok) + 4 * B * F * N,
                             ops["filter"] * pairs),
            "chain_score": (stage_bytes(ssub, "score", state, view, aux, carries, ok) + 8 * B * S * N,
                            ops["score"] * pairs),
            "chain_normalize": (stage_bytes(ssub, "normalize", state, view, aux, carries, ok, raw) + 8 * B * S * N,
                                4 * S * pairs),
            "chain_select": (tensor_bytes([norm, ok, w]) + 4 * B * N + 4 * B, 3 * S * pairs),
            "chain_select_commit": (tensor_bytes([norm, ok, w]) + 4 * B * N + 4 * B
                                    + commit_bytes(csub, pods_b, aux, sel), 3 * S * pairs),
            "chain_window": (N + 2 * N + 4, ops["sample"] * n_real),
        }
        for name, call in calls.items():
            kernel = f"{STAGE_KERNELS[name.removesuffix('_commit')]}_stage_kernel"
            reps = STAGE_REPS if B == 1 else 5
            # The kernel's own time (CUPTI), the wrapper's host time per
            # call, and a call's time between CUDA events (the larger of
            # the two when calls run back to back).
            ms = cupti_ms(lambda: call(chain_stages.STAGES), reps, kernel)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                call(chain_stages.STAGES)
            host = (time.perf_counter() - t) / reps * 1e3
            call_ms = cuda_ms(lambda: call(chain_stages.STAGES), reps=reps)
            plain = cuda_ms(lambda: call(chain_stages.PLAIN_STAGES), reps=2 if B == 1 else 1)
            bound, by = bound_ms(*work[name])
            measured.setdefault(name, {})[B] = (ms, plain, bound, by, host, call_ms)
            print(f"  {name} at {B} x {N}: kernel {ms:.4f} ms (CUPTI); wrapper host {host:.4f} ms a call, "
                  f"{call_ms:.4f} ms a call between CUDA events; plain {plain:.3f} ms; bound {bound:.6f} ms by "
                  f"{by} ({work[name][0]} bytes) {card}", flush=True)
            if B == 1:
                chain_stages.STAGE_CLUSTER = 1
                try:
                    cs1_ms[name] = cupti_ms(lambda: call(chain_stages.STAGES), reps, kernel)
                finally:
                    chain_stages.STAGE_CLUSTER = 0
                print(f"  {name} at {B} x {N} on a forced cluster of one block of 256 threads: kernel "
                      f"{cs1_ms[name]:.4f} ms (CUPTI) {card}", flush=True)
    print(f"  (iv) launches per pod of the scan: {per_pod}; (i)'s wall {walls[ident]:.2f} s = "
          f"{walls[ident] / n_pods * 1e3:.3f} ms per pod, kernel A {a_ms:.3f} ms for the queue; (iv) took "
          f"{time.perf_counter() - td:.1f} s {card}", flush=True)
    trace = hooked_trace(card, legs)
    entries = {}
    for name, stage in STAGE_KERNELS.items():
        ms, plain, bound, by, host, call_ms = measured[name][1]
        note = {"launches": launched[stage], "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "ms_is": "CUPTI kernel records", "wrapper_host_ms": host, "call_ms": call_ms,
                "shape": f"1x{N} (one pod's visit window)" if name == "chain_window"
                else f"1x{N} (one pod of the scan, the default profile in one launch)",
                "stage": {"chain_filter": "E1", "chain_score": "E2", "chain_normalize": "E3"}.get(name, "E4")}
        note.update(ran[1][0][name], ms_cluster_1=cs1_ms[name], chunk_geometry=ran[STAGE_BLOCK][0].get(name),
                    **ptxas_usage("chain_stages", f"{stage}_stage_kernel"))
        if name == "chain_select":
            cms, cplain, cbound, cby, chost, ccall = measured["chain_select_commit"][1]
            note.update(commit_ms=cms, commit_plain_ms=cplain, commit_bound_ms=cbound, commit_bound_by=cby,
                        commit_wrapper_host_ms=chost, commit_call_ms=ccall,
                        commit_ms_cluster_1=cs1_ms["chain_select_commit"],
                        commit_geometry=ran[1][0]["chain_select_commit"], launches_per_pod=per_pod,
                        staged_wall_s=walls, a_queue_ms=a_ms, hooked_trace=trace)
        if STAGE_BLOCK in measured[name]:
            cms, cplain, cbound, cby, chost, ccall = measured[name][STAGE_BLOCK]
            note.update(chunk_ms=cms, chunk_plain_ms=cplain, chunk_bound_ms=cbound, chunk_bound_by=cby,
                        chunk_wrapper_host_ms=chost, chunk_call_ms=ccall, chunk_shape=f"{STAGE_BLOCK}x{N}")
        entries[name] = note
    return entries


def sched_prog(eng: Engine):
    """The engine's program without its hooks (the default profile)."""
    return type(eng._prog)(tuple(dataclasses.replace(sp, extender=None) for sp in eng._prog.plugins), "full",
                           eng._prog.exact)


def extension_phase(check: Check, card: str, smi: str, nodes, pods, default_ms: dict, seed: int) -> dict:
    """Phase 11: (a) the main path's pass with the samples through kernels
    A, C and B, each against its plain version, timed beside the default
    profile's times and the baseline's; (b) the 6k churn with NodeNumber
    through kernel D against the per-pass path, and an 8-lane fleet leg;
    (c) a webhook extender on 127.0.0.1 through the service (kernel B per
    pod) against the CPU run.  (d), hooked profiles through kernel E's
    stages, runs beside phase 12 (``staged_legs``) and after it
    (``staged_timings``), and (e), a profiled pass, after (d)
    (``profiler_leg``).  Returns each kernel's phase-11 notes."""
    t11 = time.perf_counter()
    notes: dict = {}

    # -- (a) the pass with the samples ------------------------------------
    provider = renewable_provider(seed)
    encoders = {"nodenumber": encode_node_number, "provider:Renewable": provider_encoder(provider)}
    t = time.perf_counter()
    feats = Featurizer(extra_encoders=encoders).featurize(nodes, pods)
    feats_pre = Featurizer(extra_encoders=encoders).featurize(nodes, pods[:SAMPLES_PREFIX])
    feats_2k = Featurizer(extra_encoders=encoders).featurize(nodes, pods[:PREFIX])
    plugins, plugins_pre, plugins_2k = (sample_profile(f, provider) for f in (feats, feats_pre, feats_2k))
    print(f"  featurized the samples' snapshots in {time.perf_counter() - t:.1f} s (NodeNumber weight 1, "
          f"Renewable weight 2, scores 0-100 from seed {seed})", flush=True)
    sched = Engine(feats, plugins, record="selection", exact=True, device=DEVICE)
    sampled = Engine(feats, plugins, record="selection", exact=True, device=DEVICE, sampling_k=SAMPLING_K)
    fused = Engine(feats, plugins, record="final", exact=True, device=DEVICE)
    chunk = Engine(feats_2k, plugins_2k, record="full", exact=True, device=DEVICE)
    full_pre = Engine(feats_pre, plugins_pre, record="full", exact=True, device=DEVICE)
    full_pre_s = Engine(feats_pre, plugins_pre, record="full", exact=True, device=DEVICE, sampling_k=SAMPLING_K)
    torch.cuda.synchronize()
    _zero_launches()
    res_a, _ = sched.schedule()
    res_c, _ = sampled.schedule(sampling_start=0)
    res_b = fused.evaluate_batch_fused()
    res_chunk = chunk.evaluate_batch()
    res_pre_a, _ = full_pre.schedule()
    res_pre_c, _ = full_pre_s.schedule(sampling_start=0)
    launched = _launches()
    print(f"  the samples' pass ran; launches {launched}", flush=True)
    for name in ("schedule_scan", "schedule_sampled", "batch_eval"):
        if launched[name] < 1:
            raise AssertionError(f"{name} was not launched on the samples' pass")
    n_pre = len(feats_pre.pods.keys)
    plain_pre = PlainEngine(feats_pre, plugins_pre, record="full", exact=True, device=DEVICE)
    want_a, _ = plain_pre.schedule()
    check.results("schedule_scan", f"samples: schedule full, {SAMPLES_PREFIX} pods", res_pre_a, want_a)
    check.equal("schedule_scan", f"samples: whole-queue selected, first {SAMPLES_PREFIX} pods",
                res_a.selected[:n_pre], want_a.selected[:n_pre])
    plain_pre_s = PlainEngine(feats_pre, plugins_pre, record="full", exact=True, device=DEVICE,
                              sampling_k=SAMPLING_K)
    want_c, _ = plain_pre_s.schedule(sampling_start=0)
    check.results("schedule_sampled", f"samples: sampled full, {SAMPLES_PREFIX} pods", res_pre_c, want_c)
    check.equal("schedule_sampled", f"samples: whole-queue sampled selected, first {SAMPLES_PREFIX} pods",
                res_c.selected[:n_pre], want_c.selected[:n_pre])
    plain_2k = PlainEngine(feats_2k, plugins_2k, record="full", exact=True, device=DEVICE)
    check.results("batch_eval", f"samples: evaluate_batch full, {PREFIX} pods", res_chunk, plain_2k.evaluate_batch())
    fprog = fused._prog
    fcarries = fprog.init_carries(fused._aux)
    plain_fused = batch_eval_plain(fprog, fused._node_state, fused._pods, fused._aux, fcarries)
    for key, name in (("selected", "selected"), ("total", "total"), ("final", "final_scores")):
        check.equal("batch_eval", f"samples: fused {key}", getattr(res_b, name), plain_fused[key].cpu().numpy())
    del plain_fused
    si = res_pre_a.plugin_names.index("NodeNumber")
    if set(np.unique(res_pre_a.scores[:n_pre, si])) != {0, 10}:
        raise AssertionError("NodeNumber scored no match, or only matches, on the prefix")
    print(f"  A (whole queue, {SAMPLES_PREFIX}-pod full prefix), C (likewise) and B (fused whole queue, "
          f"{PREFIX}-pod full chunk) equal their plain versions with the sample rows", flush=True)
    prog, state0, pods0, aux = sched._prog, sched._node_state, sched._pods, sched._aux
    carries0 = prog.init_carries(aux)
    sprog = sampled._prog
    start0 = torch.zeros((), dtype=torch.int32, device=DEVICE)
    n_real = len(feats.nodes.names)
    cprog = chunk._prog
    ccarries = cprog.init_carries(chunk._aux)
    ms = {
        "A": cuda_ms(lambda: schedule_scan(prog, state0, pods0, aux, carries0), reps=2),
        "C queue": cuda_ms(lambda: schedule_sampled(sprog, state0, pods0, aux, carries0, start0, n_real,
                                                    SAMPLING_K), reps=2),
        "B fused": cuda_ms(lambda: batch_eval(fprog, fused._node_state, fused._pods, fused._aux, fcarries),
                           reps=B_REPS),
        "B chunk": cuda_ms(lambda: batch_eval(cprog, chunk._node_state, chunk._pods, chunk._aux, ccarries),
                           reps=B_REPS),
    }
    for key, val in ms.items():
        print(f"  with the samples, {key}: {val:.3f} ms; the default profile {default_ms[key]:.3f} ms in this run; "
              f"baseline {BASELINE_MS[key]} ms {card}", flush=True)
    power = float(smi.rsplit(",", 1)[1].strip().split()[0])
    if abs(power - BASELINE_POWER_W) < 0.5:
        for key in ("A", "C queue", "B fused", "B chunk"):
            ratio = default_ms[key] / BASELINE_MS[key]
            print(f"  the default profile's {key}: {ratio:.4f} x the baseline")
            if ratio > 1 + BASELINE_TOLERANCE:
                raise AssertionError(f"the default profile's {key} took {default_ms[key]:.3f} ms, more than "
                                     f"{BASELINE_TOLERANCE:.0%} over the baseline's {BASELINE_MS[key]} ms")
    else:
        print(f"  the default profile's times not held against the baseline's: power limit {power} W, "
              f"the baseline ran at {BASELINE_POWER_W} W")
    notes["schedule_scan"] = {"launches": launched["schedule_scan"], "ms": ms["A"], "default_ms": default_ms["A"],
                              "shape": f"{pods0.valid.shape[0]}x{state0.valid.shape[0]} selection"}
    notes["schedule_sampled"] = {"launches": launched["schedule_sampled"], "queue_ms": ms["C queue"],
                                 "default_queue_ms": default_ms["C queue"],
                                 "shape": f"{pods0.valid.shape[0]}x{state0.valid.shape[0]} selection, k={SAMPLING_K}"}
    notes["batch_eval"] = {"launches": launched["batch_eval"], "ms": ms["B fused"], "chunk_ms": ms["B chunk"],
                           "default_ms": default_ms["B fused"], "default_chunk_ms": default_ms["B chunk"]}
    del sched, sampled, fused, chunk, full_pre, full_pre_s, plain_pre, plain_pre_s, plain_2k
    print(f"  (a) took {time.perf_counter() - t11:.1f} s", flush=True)

    # -- (b) the churn with NodeNumber ------------------------------------
    tb = time.perf_counter()
    cfg = {"profiles": [{
        "plugins": {"multiPoint": {"enabled": [{"name": "NodeNumber", "weight": 1}]}},
        "pluginConfig": [{"name": "NodeNumber", "args": {
            "builderImport": "ksim_tpu_torch.plugins.samples.nodenumber:NODE_NUMBER_PLUGIN"}}],
    }]}
    ops = list(churn_scenario(0, n_nodes=CHURN_NODES, n_events=6000, ops_per_step=100))
    kw = dict(max_pods_per_pass=1024, pod_bucket_min=128, exact=False, device=DEVICE, config=cfg)
    segments = []
    kernel = replay_mod.replay_segment

    def capture(st, prog_, const, ev, s0):
        held = {k: v.clone() for k, v in s0.items()}
        final, outs = kernel(st, prog_, const, ev, s0)
        segments.append((st, prog_, const, ev, held, final, outs))
        return final, outs

    replay_mod.replay_segment = capture
    try:
        _zero_launches()
        dev = ScenarioRunner(device_replay=True, device_segment_steps=SEGMENT_K, **kw)
        t = time.perf_counter()
        dev_res = dev.run(list(ops))
        dev_wall = time.perf_counter() - t
        d_launches = replay_segment.launches
    finally:
        replay_mod.replay_segment = kernel
    drv = dev.replay_driver
    if d_launches < 1 or drv.device_steps < MIN_DEVICE_STEPS:
        raise AssertionError(f"the NodeNumber churn: {d_launches} launches of kernel D, {drv.device_steps} steps "
                             f"on the card ({drv.unsupported})")
    per = ScenarioRunner(**kw)
    t = time.perf_counter()
    per_res = per.run(list(ops))
    per_wall = time.perf_counter() - t
    if step_triples(dev_res) != step_triples(per_res) or store_view(dev) != store_view(per):
        raise AssertionError("the NodeNumber churn: the device path differs from the per-pass path")
    attempts = [int((seg[6]["idx"] < seg[2]["pods"]["requests"].shape[0]).sum()) for seg in segments]
    st, prog_d, const, ev, s0, final, outs = segments[max(range(len(segments)), key=attempts.__getitem__)]
    ms_d = cuda_ms(lambda: kernel(st, prog_d, const, ev, s0), reps=3)
    small = min((i for i, a in enumerate(attempts) if a > 0), key=attempts.__getitem__)
    st2, prog2, const2, ev2, s02, final2, outs2 = segments[small]
    want_final, want_outs = replay_segment_plain(st2, prog2, const2, ev2, s02)
    tree_equal(check, "replay_segment", f"NodeNumber churn segment {small} outputs", outs2, want_outs)
    tree_equal(check, "replay_segment", f"NodeNumber churn segment {small} final state", final2, want_final)
    print(f"  6k churn with NodeNumber: {per_res.pods_scheduled} scheduled, {per_res.unschedulable_attempts} "
          f"unschedulable; the device path (kernel D, {d_launches} launches, {drv.device_steps} steps on the card, "
          f"{drv.fallback_steps} per-pass, {drv.unsupported or 'no fallback'}) equals the per-pass path step for "
          f"step (triples, store, nominations); walls {dev_wall:.2f} s device, {per_wall:.2f} s per-pass {card}",
          flush=True)
    print(f"  kernel D with NodeNumber, fullest segment ({max(attempts)} attempts): {ms_d:.3f} ms per launch "
          f"(the default profile: baseline {BASELINE_MS['D']} ms, this run {default_ms['D']:.3f} ms); "
          f"segment {small} ({attempts[small]} attempts) equals D's plain version {card}", flush=True)
    segments.clear()
    os.environ["KSIM_FLEET_VMAP"] = "1"
    try:
        replay_segment_fleet.launches = 0
        fleet = ScenarioRunner(device_replay=True, device_segment_steps=SEGMENT_K, fleet=FLEET_LANES, **kw)
        t = time.perf_counter()
        fleet.run(list(ops))
        fleet_wall = time.perf_counter() - t
        f_launches = replay_segment_fleet.launches
    finally:
        os.environ.pop("KSIM_FLEET_VMAP", None)
    if f_launches < 1 or fleet.fleet_driver.stats()["lanes_on_device"] != 1.0:
        raise AssertionError(f"the NodeNumber fleet: {f_launches} launches, {fleet.fleet_driver.stats()}")
    for ln in fleet.fleet_lanes:
        if step_triples(ln.result) != step_triples(dev_res) or store_view(ln.runner) != store_view(dev):
            raise AssertionError(f"the NodeNumber fleet: lane {ln.idx} differs from the solo run")
    print(f"  {FLEET_LANES}-lane fleet (vmap cohort) with NodeNumber: every lane equals the solo run; "
          f"{f_launches} launches; wall {fleet_wall:.2f} s {card}", flush=True)
    notes["replay_segment"] = {"launches": d_launches, "ms": ms_d, "default_ms": default_ms["D"], "attempts": max(attempts),
                               "device_wall_s": dev_wall, "per_pass_wall_s": per_wall}
    notes["replay_segment_fleet"] = {"launches": f_launches, "wall_s": fleet_wall}
    print(f"  (b) took {time.perf_counter() - tb:.1f} s", flush=True)

    # -- (c) a webhook extender ------------------------------------------
    tc = time.perf_counter()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), ParityExtender)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        ext_cfg = {"extenders": [{"urlPrefix": url, "filterVerb": "filter", "prioritizeVerb": "prioritize",
                                  "weight": 3, "ignorable": False, "nodeCacheCapable": True}]}
        nodes_e, pods_e = random_cluster(0, *EXT_SHAPE, bound_fraction=0.0)
        runs = {}
        for where in (DEVICE, "cpu"):
            store = ClusterStore()
            for n in nodes_e:
                store.create("nodes", json.loads(json.dumps(n)))
            for p in pods_e:
                store.create("pods", json.loads(json.dumps(p)))
            svc = SchedulerService(store, config=ext_cfg, device=where)
            _zero_launches()
            t = time.perf_counter()
            placed = svc.schedule_pending()
            wall = time.perf_counter() - t
            annos = {p["metadata"]["name"]: p["metadata"].get("annotations", {}) for p in store.list("pods")}
            runs[where] = (placed, annos, wall, svc.metrics.snapshot()["timings"], batch_eval.launches)
    finally:
        srv.shutdown()
        srv.server_close()
    (placed, annos, wall, timings, b_launches), (cpu_placed, cpu_annos, cpu_wall, _, _) = runs[DEVICE], runs["cpu"]
    n_e = len(pods_e)
    if placed != cpu_placed or annos != cpu_annos:
        raise AssertionError("the extender run on the card differs from the CPU run")
    if b_launches < n_e:
        raise AssertionError(f"the extender run launched kernel B {b_launches} times for {n_e} pods")
    bound = sum(v is not None for v in placed.values())
    # A pod no node fits never reaches the extender (nor its annotations).
    if not all(EXTENDER_FILTER_RESULT_KEY in annos[key.split("/", 1)[1]] for key, v in placed.items() if v):
        raise AssertionError("a bound pod lacks the extender filter-result annotation")
    if bound == 0 or any(v is not None and int(v[-1]) % 2 for v in placed.values()):
        raise AssertionError("the extender's filter was not honoured")
    split = {k: timings[k]["total_seconds"] / n_e * 1e3 for k in ("featurize", "engine", "extender_http")}
    split["bind and annotations"] = wall / n_e * 1e3 - sum(split.values())
    print(f"  extender (weight 3) on {EXT_SHAPE[0]} nodes x {n_e} pods: {bound} bound, placements and the four "
          f"extender annotations equal the CPU run; kernel B {b_launches} launches; per pod "
          f"{', '.join(f'{k} {v:.2f} ms' for k, v in split.items())}; wall {wall:.2f} s (CPU {cpu_wall:.2f} s) "
          f"{card}", flush=True)
    notes["batch_eval"]["extender"] = {"launches": b_launches, "per_pod_ms": split, "wall_s": wall}

    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s {card}", flush=True)
    return {"samples": notes}


def profiler_leg(card: str) -> None:
    """Phase 11 (e): the profiler, over a pass of a profile with the
    lifecycle samples (markers the kernels skip: the pass stays on kernel
    A).  It runs after (d)'s CUPTI timings: a torch.profiler session
    before them cost cupti_ms some of a session's kernel records."""
    nodes_p, pods_p = random_cluster(0, *PROFILED_SHAPE, bound_fraction=0.0)
    store = ClusterStore()
    for n in nodes_p:
        store.create("nodes", n)
    for p in pods_p:
        store.create("pods", p)
    store.create("pods", {**pods_p[0], "metadata": {**pods_p[0]["metadata"], "name": "hold-0"}})
    lifecycle = "ksim_tpu_torch.plugins.samples.lifecycle:"
    with tempfile.TemporaryDirectory() as log_dir:
        binds = Path(log_dir) / "binds.jsonl"
        cfg_e = {"profiles": [{
            "plugins": {"queueSort": {"enabled": [{"name": "FifoSort"}]},
                        "preEnqueue": {"enabled": [{"name": "NamePrefixGate"}]},
                        "postBind": {"enabled": [{"name": "PlacementExport"}]}},
            "pluginConfig": [
                {"name": "FifoSort", "args": {"builderImport": lifecycle + "FIFO_SORT_PLUGIN"}},
                {"name": "NamePrefixGate", "args": {"builderImport": lifecycle + "NAME_PREFIX_GATE_PLUGIN"}},
                {"name": "PlacementExport", "args": {"builderImport": lifecycle + "PLACEMENT_EXPORT_PLUGIN",
                                                     "sinkPath": str(binds)}},
            ],
        }]}
        svc = SchedulerService(store, config=cfg_e, record="selection", device=DEVICE)
        _zero_launches()
        svc.start_profiling(log_dir)
        placed_e = svc.schedule_pending()
        path = svc.stop_profiling()
        a_launches = schedule_scan.launches
        events = json.loads(Path(path).read_text())["traceEvents"]
        exported = binds.read_text().splitlines() if binds.exists() else []
    names = {str(e.get("name")) for e in events}
    if a_launches < 1 or "scheduling-pass" not in names or "ksim_schedule_scan" not in names:
        raise AssertionError(f"the profiler trace lacks kernel A's launch or the pass ({a_launches} launches)")
    n_bound = sum(v is not None for v in placed_e.values())
    if "default/hold-0" in placed_e or n_bound == 0 or len(exported) != n_bound:
        raise AssertionError(f"the lifecycle samples: {n_bound} bound, {len(exported)} exported, "
                             f"hold-0 {'queued' if 'default/hold-0' in placed_e else 'gated'}")
    cupti = sorted({e["name"] for e in events if e.get("cat") == "kernel" and "cluster_scan_kernel" in str(e.get("name"))})
    print(f"  profiler: one pass traced ({len(events)} events): 'scheduling-pass' and kernel A's launch "
          f"('ksim_schedule_scan', {a_launches} launches); the card's kernel records name "
          f"{cupti[:1] or 'no cluster_scan_kernel (CUPTI recorded no kernel)'}; the pass's profile holds FifoSort, "
          f"NamePrefixGate (hold-0 kept out) and PlacementExport ({len(exported)} binds exported) {card}", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, path: str, timeout: float = 120.0) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


class FrontProcess:
    """One of the port's commands as a child process: its output goes to
    a log file, and it is killed if it outlives ``FRONT_WAIT_S`` or the
    phase.  ``cores`` pins it (every thread it has and will start) to
    those CPU cores."""

    def __init__(self, label: str, args: list, work: Path, env: "dict | None" = None,
                 cores: "set[int] | None" = None) -> None:
        self.label = label
        self.log_path = work / f"{label}.log"
        self._log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", *args], stdout=self._log, stderr=subprocess.STDOUT,
                                     env={**os.environ, **(env or {})})
        if cores:
            # The child has just exec'd the interpreter: the threads it
            # starts later inherit its affinity.  One that has already
            # exited shows its code in ``wait``.
            try:
                for tid in os.listdir(f"/proc/{self.proc.pid}/task"):
                    os.sched_setaffinity(int(tid), cores)
            except (FileNotFoundError, ProcessLookupError):
                pass

    def wait(self, timeout: float = FRONT_WAIT_S) -> float:
        """Wait at most ``timeout`` more seconds for exit 0; returns the
        process's wall seconds."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"{self.label} outlived {timeout} s:\n{self.tail()}") from None
        finally:
            self._log.close()
        if rc != 0:
            raise AssertionError(f"{self.label} exited {rc}:\n{self.tail()}")
        return time.perf_counter() - self.t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._log.close()

    def tail(self, n: int = 30) -> str:
        return "\n".join(self.log_path.read_text(errors="replace").splitlines()[-n:])


def trace_device(prof_dir: Path, names: "dict[str, str]" = FRONT_KERNELS) -> dict:
    """The card's records in the torch.profiler traces a server wrote into
    ``prof_dir`` (CUPTI's kernel, copy and memset records of the whole
    process, every pass in it): the launches and milliseconds of A, C and
    B by kernel name, every kernel's and every copy's milliseconds, the
    card's busy milliseconds (the union of those records) and the traced
    window in seconds (the first complete event's start to the last's
    end)."""
    launches = dict.fromkeys(names, 0)
    named_ms = dict.fromkeys(names, 0.0)
    kernel_us = copy_us = 0.0
    busy, lo, hi = [], float("inf"), float("-inf")
    paths = sorted(prof_dir.glob("*.pt.trace.json"))
    if not paths:
        raise AssertionError(f"no torch.profiler trace in {prof_dir}")
    for path in paths:
        for e in json.loads(path.read_text())["traceEvents"]:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            lo, hi = min(lo, ts), max(hi, ts + dur)
            cat = e.get("cat")
            if cat == "kernel":
                kernel_us += dur
                for key, name in names.items():
                    if name in str(e.get("name")):
                        launches[key] += 1
                        named_ms[key] += dur / 1e3
            elif cat in ("gpu_memcpy", "gpu_memset"):
                copy_us += dur
            else:
                continue
            busy.append((ts, ts + dur))
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(busy):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return {"launches": launches, "named_ms": named_ms, "kernel_ms": kernel_us / 1e3, "copy_ms": copy_us / 1e3,
            "busy_ms": busy_us / 1e3, "window_s": (hi - lo) / 1e6}


def first_attempts(doc: dict) -> dict:
    """Pod -> (nodeName, the result annotations of its first attempt)."""
    out = {}
    for p in doc["pods"]:
        md = p["metadata"]
        history = json.loads((md.get("annotations") or {}).get(RESULT_HISTORY_KEY, "[]"))
        out[f"{md.get('namespace', 'default')}/{md['name']}"] = (p["spec"].get("nodeName"), history[:1])
    return out


def simulator_leg(label: str, work: Path, snap_path: Path, want, card: str, *, env: "dict | None" = None,
                  sched_config: "Path | None" = None, cores: "set[int] | None" = None) -> dict:
    """Phase 12 (b)-(d): the simulator on the card with ``snap_path``
    imported before its loop starts, its torch.profiler on; waits for the
    first pass over every pod, then checks the export against ``want()``
    (the one-pass run's first attempts, read once the server has started),
    the reset and the clean exit on SIGTERM, and reads the card's records
    in the server's trace."""
    port = _free_port()
    prof_dir = work / f"{label}-profile"
    cfg = {"port": port, "externalImportEnabled": True, "externalSnapshotPath": str(snap_path)}
    if sched_config is not None:
        cfg["kubeSchedulerConfigPath"] = str(sched_config)
    cfg_path = work / f"{label}-config.yaml"
    cfg_path.write_text(json.dumps(cfg))
    sim = FrontProcess(label, ["ksim_tpu_torch.cmd.simulator", "--config", str(cfg_path),
                               "--profile-dir", str(prof_dir)], work, env, cores)
    try:
        n_pods = FRONT_SHAPE[1]
        metrics = None
        while time.perf_counter() - sim.t0 < FRONT_WAIT_S:
            if sim.proc.poll() is not None:
                raise AssertionError(f"{label}: the simulator exited {sim.proc.returncode}:\n{sim.tail()}")
            try:
                status, body = _http(port, "GET", "/api/v1/metrics", timeout=30)
            except OSError:
                status = None
            if status == 200:
                metrics = json.loads(body)
                if metrics["counters"].get("scheduling_attempts", 0) >= n_pods:
                    break
            time.sleep(0.25)
        else:
            raise AssertionError(f"{label}: the first pass did not end in {FRONT_WAIT_S} s:\n{sim.tail()}")
        first_pass_s = time.perf_counter() - sim.t0
        t = time.perf_counter()
        status, body = _http(port, "GET", "/api/v1/export")
        export_s = time.perf_counter() - t
        if status != 200:
            raise AssertionError(f"{label}: export answered {status}")
        got = first_attempts(json.loads(body))
        want = want()
        if got.keys() != want.keys():
            raise AssertionError(f"{label}: exported pods differ from the one-pass run's")
        bad = [k for k in want if got[k] != want[k]]
        if bad:
            raise AssertionError(f"{label}: {len(bad)} pods differ from the one-pass run, e.g. {bad[:3]}")
        placed = sum(node is not None for node, _ in got.values())
        status, _ = _http(port, "PUT", "/api/v1/reset")
        _, after = _http(port, "GET", "/api/v1/export")
        after = json.loads(after)
        if status != 202 or after["pods"] or after["nodes"]:
            raise AssertionError(f"{label}: reset answered {status}; {len(after['pods'])} pods and "
                                 f"{len(after['nodes'])} nodes left (the boot state holds none)")
        sim.proc.send_signal(signal.SIGTERM)
        wall = sim.wait()
    except BaseException:
        sim.kill()
        raise
    dev = trace_device(prof_dir)
    timings = {k: (v.get("total_seconds"), v.get("count")) for k, v in metrics["timings"].items()}
    split = ", ".join(f"{k} {tot:.3f} s / {n}" for k, (tot, n) in sorted(timings.items()) if tot is not None)
    # The first pass's timed sections run one after another inside it, so
    # their sum is at most the pass's wall; the trace's busy time covers
    # every pass (the retries too), so it is at least the first pass's.
    timed_s = sum(tot for tot, _ in timings.values() if tot is not None)
    idle_window = 1 - dev["busy_ms"] / 1e3 / dev["window_s"]
    idle_pass_min = 1 - dev["busy_ms"] / 1e3 / timed_s
    print(f"  ({label}) simulator: first pass over {n_pods} pods done {first_pass_s:.1f} s after start "
          f"({placed} placed, each pod's node and first attempt equal to the one-pass run); export "
          f"{len(body)} bytes in {export_s:.2f} s; reset 202 and the boot state (no pods, no nodes) "
          f"re-exported; SIGTERM -> exit 0, {wall:.1f} s in all {card}\n"
          f"    the service's split at the first pass (seconds / calls; bind = the binds and the annotations "
          f"rendered and written): {split}\n"
          f"    the card in the server's torch.profiler trace (every pass): launches {dev['launches']}, "
          f"{ {k: round(v, 3) for k, v in dev['named_ms'].items()} } ms; all kernels {dev['kernel_ms']:.3f} ms, "
          f"copies and memsets {dev['copy_ms']:.3f} ms; busy {dev['busy_ms']:.3f} ms of the "
          f"{dev['window_s']:.2f} s traced window (idle {100 * idle_window:.2f}%); the first pass's timed "
          f"sections sum to {timed_s:.3f} s, so the card idled at least {100 * idle_pass_min:.2f}% of that "
          f"pass {card}", flush=True)
    return {"wall_s": wall, "first_pass_s": first_pass_s, "export_s": export_s, "export_bytes": len(body),
            "timings": timings, "trace_launches": dev["launches"], "device": dev, "idle_window": idle_window,
            "idle_first_pass_min": idle_pass_min, "placed": placed}


class FrontRefs:
    """Phase 12's inputs and its three --device cpu runs of cmd.scheduler,
    made and started as soon as the kernels are built: (a)'s, (c)'s (under
    KSIM_PNTS_EMULATION=1) and (d)'s (behind the webhook extender served
    here).  They run on the last two CPU cores beside phases 3-4, whose
    work is on the card, and are done when phase 12 reads them; ``close``
    (also at exit) stops them and the extender."""

    def __init__(self) -> None:
        self.work = Path(tempfile.mkdtemp(prefix="ksim-front-"))
        nodes, pods = random_cluster(0, *FRONT_SHAPE, bound_fraction=0.0)
        store = ClusterStore()
        for obj in nodes:
            store.create("nodes", obj)
        for obj in pods:
            store.create("pods", obj)
        self.snap_path = self.work / "snapshot.json"
        self.snap_path.write_text(SnapshotService(store).export_json())
        self.ext = ThreadingHTTPServer(("127.0.0.1", 0), ParityExtender)
        self.ext_thread = threading.Thread(target=self.ext.serve_forever, daemon=True)
        self.ext_thread.start()
        self.ext_cfg = self.work / "extender.yaml"
        self.ext_cfg.write_text(json.dumps({"extenders": [{
            "urlPrefix": f"http://127.0.0.1:{self.ext.server_address[1]}", "filterVerb": "filter",
            "prioritizeVerb": "prioritize", "weight": 3, "nodeCacheCapable": True}]}))
        self.sched = ["ksim_tpu_torch.cmd.scheduler", "--snapshot", str(self.snap_path)]
        cores = sorted(os.sched_getaffinity(0))
        self.ref_cores = set(cores[-2:]) if len(cores) >= 4 else None
        env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
        extra = {"a": ((), {}), "c": ((), FRONT_PNTS), "d": (("--config", str(self.ext_cfg)), {})}
        self.procs = {leg: FrontProcess(f"{leg}-cpu", self.sched + ["--out", str(self.out(leg)), "--device", "cpu",
                                                                     *args], self.work, {**env, **leg_env},
                                        self.ref_cores)
                      for leg, (args, leg_env) in extra.items()}
        atexit.register(self.close)

    def out(self, leg: str) -> Path:
        return self.work / f"{leg}-cpu.json"

    def read(self, leg: str) -> dict:
        """The first attempts of ``leg``'s CPU run, once it has ended."""
        self.procs[leg].wait()
        return first_attempts(json.loads(self.out(leg).read_text()))

    def close(self) -> None:
        for proc in self.procs.values():
            proc.kill()
        if self.ext is not None:
            self.ext.shutdown()
            self.ext.server_close()
            self.ext_thread.join(timeout=10)
            self.ext = None
        shutil.rmtree(self.work, ignore_errors=True)


def front_door_phase(card: str, refs: FrontRefs, beside) -> dict:
    """Phase 12: the port's front door on the card, each command as a
    process: (a) cmd.scheduler, byte-equal to its --device cpu run; (b)
    cmd.simulator with a one-shot import, its first attempts equal to (a);
    (c) (b) under KSIM_PNTS_EMULATION=1 (kernel C), against the CPU run
    under the same env; (d) (b) with a webhook extender (kernel B per
    pod), against the CPU run; (e) cmd.simulation on the 6k churn lock;
    (f) the launches of A, C and B in the servers' torch.profiler
    traces.  (a) and (e) run first, each the only command on the machine,
    with no profiler: their walls are what a user of the command waits
    for, beside phase 11 (d)'s legs in this process.  Then
    (b)-(d), profiled, run at once, each on its own CPU cores: their walls
    are a correctness run under load.  ``beside(cores)`` (phase 13) runs
    at the same time on cores of its own; its value is ``out["beside"]``.
    The whole phase runs beside phase 11 (d)'s legs (``staged_legs``, the
    main thread of this process)."""
    t12 = time.perf_counter()
    work = refs.work
    n_pods = FRONT_SHAPE[1]
    ops = list(churn_scenario(0, n_nodes=CHURN_NODES, n_events=6000, ops_per_step=100))
    doc_path = work / "churn-6k.json"
    doc_path.write_text(json.dumps({"kind": "SchedulerSimulation", "metadata": {"name": "churn-6k"}, "spec": {
        "simulator": {"maxPodsPerPass": 1024}, "scenario": {"kind": "Scenario", "spec": spec_from_operations(ops)}}}))
    out = {}
    # (a) and (e), each the only command: one pass on the card, and the
    # 6k churn.
    out["a_wall_s"] = FrontProcess("a-card", refs.sched + ["--out", str(work / "a-card.json")], work).wait()
    refs.procs["a"].wait()
    card_bytes = (work / "a-card.json").read_bytes()
    if card_bytes != refs.out("a").read_bytes():
        raise AssertionError("(a) cmd.scheduler on the card differs from its --device cpu run")
    want_a = first_attempts(json.loads(card_bytes))
    placed_a = sum(node is not None for node, _ in want_a.values())
    print(f"  (a) cmd.scheduler, the only command: {placed_a} of {n_pods} pods placed; {len(card_bytes)} bytes, "
          f"byte-equal to "
          f"--device cpu; process wall {out['a_wall_s']:.1f} s {card}", flush=True)
    del card_bytes
    sim = FrontProcess("e-card", ["ksim_tpu_torch.cmd.simulation", str(doc_path)], work)
    out["e_wall_s"] = sim.wait()
    # The status is the last JSON document of the output (indent=1: its
    # first line is a lone "{"); log lines come before it.
    text = sim.log_path.read_text()
    status = json.loads(text[[m.start() for m in re.finditer(r"(?m)^\{$", text)][-1]:])
    result = status.get("result", {})
    got = (result.get("eventsApplied"), result.get("podsScheduled"), result.get("unschedulableAttempts"))
    if status.get("phase") != "Succeeded" or got != CHURN_LOCKS[6000]:
        raise AssertionError(f"(e) cmd.simulation: {status.get('phase')} {got} against the lock {CHURN_LOCKS[6000]}")
    out["e_replay_s"] = result["wallSeconds"]
    print(f"  (e) cmd.simulation, the only command: 6k churn ({len(ops)} operations, {len(result['steps'])} steps, "
          f"per-pass): "
          f"Succeeded, {got} = the lock; replay {result['wallSeconds']} s, process wall {out['e_wall_s']:.1f} s "
          f"{card}", flush=True)
    # (b)-(d) at once: the simulator on the card, plain, sampled (C) and
    # behind the webhook (B pod by pod), and phase 13 beside them, each on
    # cores of its own.
    cores = sorted(os.sched_getaffinity(0))
    groups = ([set(cores[:2]), set(cores[2:4]), set(cores[4:6]), set(cores[6:])] if len(cores) >= 8
              else [None] * 4)
    legs = {"b": dict(want=lambda: want_a), "c": dict(want=lambda: refs.read("c"), env=FRONT_PNTS),
            "d": dict(want=lambda: refs.read("d"), sched_config=refs.ext_cfg)}
    with ThreadPoolExecutor(max_workers=len(legs) + 1) as pool:
        futures = {leg: pool.submit(simulator_leg, leg, work, refs.snap_path, card=card, cores=group, **kw)
                   for (leg, kw), group in zip(legs.items(), groups)}
        out["beside"] = pool.submit(beside, groups[3]).result()
    for leg, future in futures.items():
        out[leg] = future.result()
    # (f) each leg's kernel ran on the card.
    for leg, kernel in (("b", "A"), ("c", "C"), ("d", "B")):
        if out[leg]["trace_launches"][kernel] < 1:
            raise AssertionError(f"({leg}): kernel {kernel} launched no time in the server's trace: "
                                 f"{out[leg]['trace_launches']}")
    print(f"  (f) launches in the servers' traces: (b) A {out['b']['trace_launches']['A']}, (c) C "
          f"{out['c']['trace_launches']['C']}, (d) B {out['d']['trace_launches']['B']}", flush=True)
    refs.close()
    print(f"  phase 12 took {time.perf_counter() - t12:.1f} s {card}", flush=True)
    return out


def _post_json(port: int, path: str, doc: dict, timeout: float = 120.0) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(doc), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def follow_sse(port: int, jid: str, timeout: float = JOB_WAIT_S) -> list:
    """A job's SSE stream, read to its end (the terminal state event)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", f"/api/v1/jobs/{jid}/events")
        r = conn.getresponse()
        if r.status != 200:
            raise AssertionError(f"SSE of {jid} answered {r.status}")
        events = []
        while line := r.readline():
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
        return events
    finally:
        conn.close()


class JobServer(FrontProcess):
    """The simulator with the job plane on (phase 13): ``env`` on top of
    the phase's, ``--profile-dir`` when ``profile``; ready once its job
    routes answer."""

    def __init__(self, label: str, work: Path, env: dict, profile: bool, cores: "set[int] | None") -> None:
        self.port = _free_port()
        cfg_path = work / f"{label}-config.yaml"
        cfg_path.write_text(json.dumps({"port": self.port}))
        self.prof_dir = work / f"{label}-profile" if profile else None
        args = ["ksim_tpu_torch.cmd.simulator", "--config", str(cfg_path)]
        if profile:
            args += ["--profile-dir", str(self.prof_dir)]
        super().__init__(label, args, work, env, cores)
        while time.perf_counter() - self.t0 < JOB_WAIT_S:
            if self.proc.poll() is not None:
                raise AssertionError(f"{label}: the simulator exited {self.proc.returncode}:\n{self.tail()}")
            try:
                if _http(self.port, "GET", "/api/v1/jobs", timeout=10)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        else:
            raise AssertionError(f"{label}: no answer in {JOB_WAIT_S} s:\n{self.tail()}")
        self.ready_s = time.perf_counter() - self.t0

    def run_job(self, doc: dict) -> tuple[str, dict, float, list]:
        """POST ``doc``, follow its SSE stream to the end, GET its result:
        (job id, result document, seconds from the POST to the terminal
        state, the SSE events)."""
        t = time.perf_counter()
        status, body = _post_json(self.port, "/api/v1/jobs", doc)
        if status != 202:
            raise AssertionError(f"{self.label}: POST /api/v1/jobs answered {status}: {body}")
        events = follow_sse(self.port, body["id"])
        wall = time.perf_counter() - t
        return body["id"], self.result(body["id"]), wall, events

    def result(self, jid: str) -> dict:
        status, raw = _http(self.port, "GET", f"/api/v1/jobs/{jid}/result")
        if status != 200:
            raise AssertionError(f"{self.label}: GET the result of {jid} answered {status}")
        doc = json.loads(raw)
        doc["_raw"] = raw
        return doc

    def stop(self) -> dict:
        """SIGTERM -> exit 0; the card's records in its trace."""
        self.proc.send_signal(signal.SIGTERM)
        self.wait()
        return trace_device(self.prof_dir, JOB_KERNELS) if self.prof_dir else {}


def lock_of(doc: dict) -> tuple:
    res = doc.get("result") or {}
    return (res.get("eventsApplied"), res.get("podsScheduled"), res.get("unschedulableAttempts"))


def wait_for_checkpoint(path: Path, jid: str, proc: subprocess.Popen, timeout: float = JOB_WAIT_S) -> float:
    """Read the journal as it grows until it holds ``jid``'s first
    checkpoint record (a whole line); returns the seconds waited."""
    t0 = time.perf_counter()
    needle, offset, buf = f'"id":"{jid}"'.encode(), 0, b""
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            raise AssertionError(f"the server exited {proc.returncode} before {jid}'s first checkpoint")
        try:
            size = path.stat().st_size
        except FileNotFoundError:
            size = 0
        if size < offset:  # compacted: read it again from the start
            offset, buf = 0, b""
        if size > offset:
            with open(path, "rb") as f:
                f.seek(offset)
                buf += f.read(size - offset)
            offset = size
            *lines, buf = buf.split(b"\n")
            if any(b'"t":"checkpoint"' in line and needle in line for line in lines):
                return time.perf_counter() - t0
        time.sleep(0.02)
    raise AssertionError(f"no checkpoint record of {jid} in {timeout} s")


def job_plane_phase(card: str, cores: "set[int] | None" = None, log=print) -> dict:
    """Phase 13: the tenant job plane in the simulator on the card, three
    server processes over one KSIM_JOBS_DIR (module docstring, item 13),
    pinned to ``cores``; its lines go to ``log``."""
    t13 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="ksim-jobs-"))
    jobs_dir = work / "jobs"
    jobs_dir.mkdir()
    journal = jobs_dir / "jobs.journal.jsonl"
    env = {"KSIM_JOBS_DIR": str(jobs_dir), "KSIM_JOBS_CHECKPOINT_EVERY": "1", "KSIM_FLEET_VMAP": "1"}
    ops = list(churn_scenario(0, n_nodes=CHURN_NODES, n_events=6000, ops_per_step=100))
    sim = {"deviceReplay": True, "maxPodsPerPass": 1024, "podBucketMin": 128}
    doc = {"spec": {"simulator": sim, "scenario": spec_from_operations(ops)}}
    lane_doc = {"spec": {"simulator": {**sim, "fleet": 2}, "scenario": doc["spec"]["scenario"]}}
    want = CHURN_LOCKS[6000]
    out: dict = {}
    servers: list = []
    try:
        # (a) and (b): one profiled server, one job after the other.
        srv = JobServer("jobs-1", work, env, profile=True, cores=cores)
        servers.append(srv)
        out["start_s"] = srv.ready_s
        jid_a, res_a, wall_a, sse_a = srv.run_job(doc)
        if res_a.get("phase") != "Succeeded" or lock_of(res_a) != want:
            raise AssertionError(f"(a) solo job: {res_a.get('state')} {res_a.get('message')} {lock_of(res_a)} "
                                 f"against the lock {want}")
        rep_a = res_a["replay"]
        if rep_a["device_steps"] < MIN_DEVICE_STEPS or rep_a["unsupported"]:
            raise AssertionError(f"(a) left the device path: {rep_a['device_steps']} device steps, "
                                 f"{rep_a['unsupported']}")
        progress = [e["steps_done"] for e in sse_a if e.get("event") == "progress"]
        states = [e["state"] for e in sse_a if e.get("event") == "state"]
        if states[-1] != "succeeded" or progress != sorted(progress) or progress[-1] != res_a["result"]["steps"]:
            raise AssertionError(f"(a) SSE: states {states}, progress {progress}")
        log(f"  (a) solo job (deviceReplay, {len(ops)} operations): Succeeded, {lock_of(res_a)} = the lock; "
              f"submit to terminal {wall_a:.2f} s, replay wallSeconds {res_a['result']['wallSeconds']}; "
              f"{rep_a['device_steps']} device steps in {rep_a['device_round_trips']} launches; SSE "
              f"{len(sse_a)} events, states {states} {card}")
        jid_b, res_b, wall_b, _ = srv.run_job(lane_doc)
        lanes = res_b.get("lanes")
        if res_b.get("phase") != "Succeeded" or lanes != [list(want[1:])] * 2:
            raise AssertionError(f"(b) lane job: {res_b.get('state')} {res_b.get('message')} lanes {lanes}")
        log(f"  (b) lane job (fleet: 2, KSIM_FLEET_VMAP=1): Succeeded, lanes {lanes}; submit to terminal "
              f"{wall_b:.2f} s, replay wallSeconds {res_b['result']['wallSeconds']} {card}")
        body_a1 = res_a["_raw"]
        dev = srv.stop()
        for key, leg in (("D", "a"), ("D lanes", "b")):
            if dev["launches"][key] < 1:
                raise AssertionError(f"({leg}): {JOB_KERNELS[key]} launched no time in the server's trace: "
                                     f"{dev['launches']}")
        log(f"    the card in the server's torch.profiler trace ((a) and (b)): launches {dev['launches']}, "
              f"{ {k: round(v, 3) for k, v in dev['named_ms'].items()} } ms; all kernels {dev['kernel_ms']:.3f} ms, "
              f"copies and memsets {dev['copy_ms']:.3f} ms; busy {dev['busy_ms']:.3f} ms of the "
              f"{dev['window_s']:.2f} s traced window (idle {100 * (1 - dev['busy_ms'] / 1e3 / dev['window_s']):.2f}%); "
              f"server ready {out['start_s']:.1f} s after its start {card}")
        out.update(a={"wall_s": wall_a, "replay_s": res_a["result"]["wallSeconds"]},
                   b={"wall_s": wall_b, "replay_s": res_b["result"]["wallSeconds"]}, device=dev)
        # (c) SIGKILL after the first checkpoint record, then resume.
        srv = JobServer("jobs-2", work, {**env, "KSIM_JOBS_FAULTS": "2:replay.dispatch=hang:3:2"}, profile=False,
                        cores=cores)
        servers.append(srv)
        body_a2 = srv.result(jid_a)["_raw"]
        t = time.perf_counter()
        status, body = _post_json(srv.port, "/api/v1/jobs", doc)
        if status != 202:
            raise AssertionError(f"(c): POST answered {status}: {body}")
        jid_c = body["id"]
        waited = wait_for_checkpoint(journal, jid_c, srv.proc)
        srv.kill()
        killed_s = time.perf_counter() - t
        # Unprofiled: the resumed job runs as the server starts, before a
        # profiler would (the service starts it after the container).
        srv = JobServer("jobs-3", work, {**env, "KSIM_JOBS_RESUME": "1"}, profile=False, cores=cores)
        servers.append(srv)
        events = follow_sse(srv.port, jid_c)
        res_c = srv.result(jid_c)
        wall_c = time.perf_counter() - srv.t0
        resume = res_c.get("resume") or {}
        if res_c.get("phase") != "Succeeded" or lock_of(res_c) != want:
            raise AssertionError(f"(c) resumed job: {res_c.get('state')} {res_c.get('message')} {lock_of(res_c)}")
        if resume.get("fromSegment", 0) < 1 or not resume.get("eventsReplayed", want[0]) < want[0]:
            raise AssertionError(f"(c) did not resume from a checkpoint: {resume}")
        rep_c = res_c["replay"]
        if rep_c["device_steps"] < 1 or rep_c["unsupported"]:
            raise AssertionError(f"(c) the suffix left the device path: {rep_c['device_steps']} device steps, "
                                 f"{rep_c['unsupported']}")
        body_a3 = srv.result(jid_a)["_raw"]
        canonical = [json.dumps(json.loads(b), sort_keys=True) for b in (body_a1, body_a3)]
        if canonical[0] != canonical[1] or body_a2 != body_a3:
            raise AssertionError("(c): (a)'s result document changed across the restarts")
        srv.stop()
        log(f"  (c) the (a) document again: its first checkpoint record {waited:.2f} s after the POST, the "
              f"server SIGKILLed and gone {killed_s:.2f} s after the POST; the restarted server (KSIM_JOBS_RESUME=1, ready {srv.ready_s:.1f} s "
              f"after its start) resumed it from segment {resume['fromSegment']} (cursor {resume['cursor']}, "
              f"{resume['eventsReplayed']} of {want[0]} events replayed): Succeeded, {lock_of(res_c)} = the lock; "
              f"start to terminal {wall_c:.2f} s, suffix replay wallSeconds {res_c['result']['wallSeconds']}; "
              f"SSE {len(events)} events; (a)'s result served equal ({len(body_a3)} bytes, byte for byte as the "
              f"second server served it); the suffix: {rep_c['device_steps']} device steps in "
              f"{rep_c['device_round_trips']} launches of replay_segment, {rep_c['kernel_ms']:.1f} ms by CUDA "
              f"events {card}")
        out["c"] = {"wall_s": wall_c, "replay_s": res_c["result"]["wallSeconds"], "resume": resume,
                    "checkpoint_wait_s": waited, "device_steps": rep_c["device_steps"],
                    "launches": rep_c["device_round_trips"], "kernel_ms": rep_c["kernel_ms"]}
    finally:
        for proc in servers:
            proc.kill()
    shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t13
    log(f"  phase 13 took {out['phase_s']:.1f} s {card}")
    return out


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="the seed of phase 11's provided scores")
    parser.add_argument("--plain-queue", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.plain_queue:
        return plain_queue_child(args.plain_queue)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    check = Check()

    phase("1 environment")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device {kind!r} count {count}; nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    phase("2 build")
    t_build = t0 = time.perf_counter()
    # Kernel D's source builds longest and is first used in phase 6: its
    # nvcc runs beside phases 3-5 (joined before phase 6).
    late = LateBuild(("replay_segment",))
    early = tuple(name for name in build.SOURCES if name not in late.names)
    build.build(early)
    print(f"built {', '.join(early)} in {time.perf_counter() - t0:.1f}s; "
          f"{', '.join(late.names)} building beside phases 3-5")
    print_build_log(early)
    # Phase 12's CPU runs go beside phases 3-4 on two cores of their own.
    front_refs = FrontRefs()
    print(f"  phase 12's --device cpu runs of cmd.scheduler started on cores {sorted(front_refs.ref_cores or ())}")
    # Kernel A's whole-queue plain scan on phase 4's inputs runs on the CPU
    # beside phases 3-9 on two more cores; its result is read at the end.
    cores = sorted(os.sched_getaffinity(0))
    plain_queue = PlainQueue(set(cores[-4:-2]) if len(cores) >= 8 else None)
    print(f"  phase 4's whole-queue plain scan of kernel A started on the CPU, cores {cores[-4:-2]}")

    phase(f"3 kernel vs plain ({SMALL[0]} nodes x {SMALL[1]} pods)")
    n_small, p_small = SMALL
    clusters = {
        f"random_cluster(0, {n_small}, {p_small})": (*random_cluster(0, n_small, p_small), {}),
        f"images_ports_cluster(3, {n_small}, {p_small})": (
            *images_ports_cluster(3, n_nodes=n_small, n_pods=p_small), {}),
        f"spread_affinity_cluster(7, {n_small}, {p_small})": spread_affinity_cluster(
            7, n_nodes=n_small, n_pods=p_small),
        f"volume_cluster(9, {n_small}, {p_small})": volume_cluster(9, n_nodes=n_small, n_pods=p_small),
    }
    t3 = time.perf_counter()
    tenth = max(1, n_small // 10)
    for ci, (label, (nodes, pods, kw)) in enumerate(clusters.items()):
        feats = Featurizer().featurize(nodes, pods, **kw)
        plugins = default_plugins(feats)
        # Kernel C: a few (k, start) on the random cluster, one on the
        # spread cluster.
        c_cases = {0: ((5, 0), (tenth, n_small * 3 // 4), (n_small, 17)), 2: ((tenth, 3),)}.get(ci, ())
        for exact in (True, False):
            # The plain versions, once, record="full".
            plain = PlainEngine(feats, plugins, record="full", exact=exact, device=DEVICE)
            want, want_state = plain.schedule()
            want_b = plain.evaluate_batch(chunk=96)
            want_c = {}
            for k, start in c_cases:
                plain_c = PlainEngine(feats, plugins, record="full", exact=exact, device=DEVICE, sampling_k=k)
                want_c[k, start] = plain_c.schedule(sampling_start=start, chunk=100)
            for record in RECORDED:
                what = f"{label} record={record} exact={exact}"
                kernel = Engine(feats, plugins, record=record, exact=exact, device=DEVICE)
                got, got_state = kernel.schedule()
                check.results("schedule_scan", f"schedule {what}", got, want, record)
                same_state("schedule_scan", what, check, got_state, want_state)
                if record == "full":
                    got_b = kernel.evaluate_batch(chunk=96)
                else:
                    got_b = kernel.evaluate_batch_fused()
                check.results("batch_eval", f"batch {what}", got_b, want_b, record)
                placed = int((got.selected >= 0).sum())
                print(f"  {what}: A, B equal ({placed} placed)", flush=True)
                for (k, start), (want_r, want_s) in want_c.items():
                    ks = Engine(feats, plugins, record=record, exact=exact, device=DEVICE, sampling_k=k)
                    got_c, got_c_state = ks.schedule(sampling_start=start, chunk=100)
                    what_c = f"sampled k={k} start={start} {what}"
                    check.results("schedule_sampled", what_c, got_c, want_r, record)
                    same_state("schedule_sampled", what_c, check, got_c_state, want_s)
                    print(f"    C k={k} start={start}: equal (next start {got_c.sampling_next_start})")
    print(f"  phase 3 took {time.perf_counter() - t3:.1f}s")

    n_nodes_main, n_pods_main = MAIN
    phase(f"4 main path: random_cluster(0, {n_nodes_main}, {n_pods_main}, bound_fraction=0.0)")
    t0 = time.perf_counter()
    nodes, pods, feats, plugins, sched = main_path_inputs(DEVICE)
    feats_2k = Featurizer().featurize(nodes, pods[:PREFIX])
    print(f"  featurized {feats.pods.valid.shape[0]} x {feats.nodes.valid.shape[0]} "
          f"(padded) in {time.perf_counter() - t0:.1f}s")
    plugins_2k = default_plugins(feats_2k)
    fused = Engine(feats, plugins, record="final", exact=True, device=DEVICE)
    full_2k = Engine(feats_2k, plugins_2k, record="full", exact=True, device=DEVICE)
    sampled = Engine(feats, plugins, record="selection", exact=True, device=DEVICE, sampling_k=SAMPLING_K)
    sampled_2k = Engine(feats_2k, plugins_2k, record="full", exact=True, device=DEVICE,
                        sampling_k=SAMPLING_K)
    torch.cuda.synchronize()

    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    wall = {}  # host seconds per entry point, results on the host included

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        wall[name] = time.perf_counter() - t
        return out

    res, state = timed("schedule(selection)", sched.schedule)
    res_fused = timed("evaluate_batch_fused(final)", fused.evaluate_batch_fused)
    res_full_2k = timed(f"evaluate_batch(full, {PREFIX} pods)", full_2k.evaluate_batch)
    res_sched_2k, _ = timed(f"schedule(full, {PREFIX} pods)", full_2k.schedule)
    ctx = RenderCtx(feats_2k, plugins_2k)
    annotations = timed("annotations(3 pods)", lambda: [
        render_pod_results(feats_2k, plugins_2k, res_sched_2k, pi, ctx=ctx) for pi in range(3)
    ])
    res_samp, state_samp = timed(f"schedule(selection, sampling_k={SAMPLING_K})",
                                 lambda: sampled.schedule(sampling_start=0))
    res_samp_2k, _ = timed(f"schedule(full, sampling_k={SAMPLING_K}, {PREFIX} pods)",
                           lambda: sampled_2k.schedule(sampling_start=0))
    sampled_annotations = [
        render_pod_results(feats_2k, plugins_2k, res_samp_2k, pi, ctx=ctx, visited=res_samp_2k.visited[pi])
        for pi in range(3)
    ]
    launches = {name: w.launches for name, w in WRAPPERS.items()}
    clusters = {name: {k: WRAPPERS[name].last[k] for k in ("cluster", "threads", "smem_bytes")}
                for name in ("schedule_scan", "schedule_sampled")}
    print(f"  main path ran; launches {launches}; clusters {clusters}")
    for name, got in clusters.items():
        if got["cluster"] < 8:
            raise AssertionError(f"{name} ran on a cluster of {got['cluster']} blocks on the main path")
    for name, sec in wall.items():
        print(f"    {name}: {sec:.3f} s host wall {card}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    n_pods = len(feats.pods.keys)
    n_real = len(feats.nodes.names)
    placed = commit_invariant(feats, res, state, "schedule")
    print(f"  schedule: {placed} of {n_pods} pods placed; commit invariant holds")
    placed_s = commit_invariant(feats, res_samp, state_samp, "sampled schedule")
    if not 0 <= res_samp.sampling_next_start < n_real:
        raise AssertionError(f"sampled next start {res_samp.sampling_next_start} outside [0, {n_real})")
    visited = res_samp_2k.visited[: len(feats_2k.pods.keys), :n_real].sum(axis=1)
    if (visited < SAMPLING_K).any() or (res_samp_2k.visited[:, n_real:]).any():
        raise AssertionError("a sampled pod visited fewer than k nodes, or a padding node")
    print(f"  sampled schedule: {placed_s} of {n_pods} pods placed; next start "
          f"{res_samp.sampling_next_start}; {PREFIX}-pod pass visits {int(visited.min())}-"
          f"{int(visited.max())} nodes per pod")
    for pi, ann in enumerate(annotations + sampled_annotations):
        res_pi = res_sched_2k if pi < len(annotations) else res_samp_2k
        keys = set(ann)
        want_keys = set(ALL_RESULT_KEYS) if res_pi.selected[pi % 3] >= 0 else set(ALL_RESULT_KEYS[:-1])
        if keys != want_keys:
            raise AssertionError(f"pod {pi % 3}: annotation keys {sorted(keys)}")
        json.loads(ann[ALL_RESULT_KEYS[2]])  # filter-result parses
    n_filtered = len(json.loads(sampled_annotations[0][ALL_RESULT_KEYS[2]]))
    if n_filtered != int(res_samp_2k.visited[0].sum()):
        raise AssertionError("sampled filter-result does not cover exactly the visited nodes")
    print(f"  rendered the {len(ALL_RESULT_KEYS)} annotations of {len(annotations)} pods, "
          f"and of {len(sampled_annotations)} sampled pods")

    # The plain versions on the main path's inputs, each timed once.
    prog, state0, pods0, aux = sched._prog, sched._node_state, sched._pods, sched._aux
    carries0 = prog.init_carries(aux)
    main_digest = tensor_digest((state0, pods0, aux, carries0))
    start0 = torch.zeros((), dtype=torch.int32, device=DEVICE)
    plain_ms = {}

    def plain_timed(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        plain_ms[name] = start.elapsed_time(end)
        return out

    fprog, fcarries = fused._prog, fused._prog.init_carries(fused._aux)
    batch_eval_plain(fprog, fused._node_state, fused._pods.rows(0, 16), fused._aux, fcarries)
    with PairCount(fprog, n_pods) as count_b:
        plain_fused = plain_timed(
            "batch_eval", lambda: batch_eval_plain(fprog, fused._node_state, fused._pods, fused._aux, fcarries)
        )
    for key, name in (("selected", "selected"), ("total", "total"), ("final", "final_scores")):
        check.equal("batch_eval", f"main-path fused {key}", getattr(res_fused, name),
                    plain_fused[key].cpu().numpy())
    del plain_fused
    # Kernel C against the plain sampled scan on the first PLAIN_PREFIX
    # pods of the 2048-pod full-record pass (its own program and inputs),
    # and the whole-queue pass on them.
    s2prog, s2state, s2pods, s2aux = sampled_2k._prog, sampled_2k._node_state, sampled_2k._pods, sampled_2k._aux
    s2carries = s2prog.init_carries(s2aux)
    schedule_sampled_plain(s2prog, s2state, s2pods.rows(0, 16), s2aux, s2carries, start0, n_real, SAMPLING_K)
    _, _, _, plain_samp = plain_timed(
        "schedule_sampled",
        lambda: schedule_sampled_plain(s2prog, s2state, s2pods.rows(0, PLAIN_PREFIX), s2aux, s2carries, start0,
                                       n_real, SAMPLING_K),
    )
    want_s2k = sampled_2k._to_result({key: v.cpu().numpy() for key, v in plain_samp.items()})
    del plain_samp
    check.results("schedule_sampled", f"main-path sampled full {PREFIX}, first {PLAIN_PREFIX} pods", res_samp_2k,
                  want_s2k, rows=PLAIN_PREFIX)
    check.equal("schedule_sampled", f"main-path sampled selected, first {PLAIN_PREFIX} pods of the whole queue",
                res_samp.selected[:PLAIN_PREFIX], want_s2k.selected)
    plain_2k = PlainEngine(feats_2k, plugins_2k, record="full", exact=True, device=DEVICE)
    check.results("batch_eval", f"main-path evaluate_batch full {PREFIX}", res_full_2k, plain_2k.evaluate_batch())
    # Kernel A's plain version on the card, timed: the first PLAIN_PREFIX
    # pods of the 2048-pod pass, record="full" (a sequential commit's first
    # selections depend on nothing after them, so they are also the whole
    # queue's first ones).  The whole queue is held against the plain
    # version on the CPU at the end (PlainQueue).
    cprog0 = full_2k._prog
    _, _, plain_sched = plain_timed("schedule_scan", lambda: schedule_scan_plain(
        cprog0, full_2k._node_state, full_2k._pods.rows(0, PLAIN_PREFIX), full_2k._aux,
        cprog0.init_carries(full_2k._aux)))
    want_sched_2k = full_2k._to_result({key: v.cpu().numpy() for key, v in plain_sched.items()})
    del plain_sched
    check.results("schedule_scan", f"main-path schedule full {PREFIX}, first {PLAIN_PREFIX} pods", res_sched_2k,
                  want_sched_2k, rows=PLAIN_PREFIX)
    check.equal("schedule_scan", f"main-path selected, first {PLAIN_PREFIX} pods of the whole queue",
                res.selected[:PLAIN_PREFIX], want_sched_2k.selected)
    del want_sched_2k
    print("  kernels equal the plain versions on the main path")

    phase("5 timings (CUDA events)")
    sprog = sampled._prog
    P, N = pods0.valid.shape[0], state0.valid.shape[0]

    def run_a():
        return schedule_scan(prog, state0, pods0, aux, carries0)

    def run_c_queue():
        return schedule_sampled(sprog, state0, pods0, aux, carries0, start0, n_real, SAMPLING_K)

    def run_c():
        return schedule_sampled(s2prog, s2state, s2pods, s2aux, s2carries, start0, n_real, SAMPLING_K)

    def stats(wrapper) -> tuple[int, int, dict]:
        """The last launch's cluster barriers, pods evaluated, and block
        0's share of the cycles in each phase of a pod."""
        counts = [int(x) for x in wrapper.last["stats"].cpu()]
        cycles = counts[2:]
        share = {name: c / max(sum(cycles), 1) for name, c in zip(chain.CLUSTER_PHASES, cycles)}
        return counts[0], counts[1], share

    # Kernels A and C at each cluster size: held equal to the plain
    # versions, then timed.
    by_cluster = {}
    for cs in CLUSTER_SIZES:
        chain.CLUSTER_SIZE = cs
        st_a, _, out_a = run_a()
        what = f"cluster of {cs}"
        # Against the main path's launch, which the end holds against the
        # plain version over the whole queue.
        check.equal("schedule_scan", f"{what}: selected, whole queue", out_a["selected"].cpu().numpy(), res.selected)
        same_state("schedule_scan", f"{what}: whole queue", check, host_state(st_a), state)
        bar_a, ev_a, share_a = stats(schedule_scan)
        shape_a = {k: schedule_scan.last[k] for k in ("threads", "smem_bytes")}
        _, _, nxt_q, out_q = run_c_queue()
        sel_q = out_q["selected"].cpu().numpy()
        check.equal("schedule_sampled", f"{what}: whole-queue selected, first {PLAIN_PREFIX} pods",
                    sel_q[:PLAIN_PREFIX], want_s2k.selected)
        check.equal("schedule_sampled", f"{what}: whole-queue selected", sel_q, res_samp.selected)
        if int(nxt_q) != res_samp.sampling_next_start:
            raise AssertionError(f"{what}: whole-queue next start {int(nxt_q)} vs {res_samp.sampling_next_start}")
        bar_q, ev_q, share_q = stats(schedule_sampled)
        _, _, nxt_2k, out_2k = run_c()
        got_2k = sampled_2k._to_result({key: v.cpu().numpy() for key, v in out_2k.items()})
        got_2k.sampling_next_start = int(nxt_2k)
        check.results("schedule_sampled", f"{what}: sampled full {PREFIX}, first {PLAIN_PREFIX} pods", got_2k,
                      want_s2k, rows=PLAIN_PREFIX)
        # The rest of the pass against the main path's launch.
        check.results("schedule_sampled", f"{what}: sampled full {PREFIX}", got_2k, res_samp_2k)
        del out_a, st_a, out_q, out_2k, got_2k
        run = {
            "a_ms": cuda_ms(run_a, reps=3), "c_queue_ms": cuda_ms(run_c_queue, reps=3), "c_ms": cuda_ms(run_c, reps=3),
            "a_barriers_per_pod": bar_a / max(ev_a, 1), "a_evaluated": ev_a, **shape_a,
            "c_queue_barriers_per_pod": bar_q / max(ev_q, 1),
            "a_phase_share": share_a, "c_queue_phase_share": share_q,
        }
        run["a_us_per_real_pod"] = run["a_ms"] * 1e3 / n_pods
        run["c_queue_us_per_real_pod"] = run["c_queue_ms"] * 1e3 / n_pods
        by_cluster[cs] = run
        print(f"  cluster of {cs} blocks ({run['threads']} threads, {run['smem_bytes']} B shared memory each): "
              f"A {run['a_ms']:.3f} ms per whole-queue pass, {run['a_us_per_real_pod']:.2f} us per real pod, "
              f"{run['a_barriers_per_pod']:.2f} cluster barriers per evaluated pod ({ev_a} evaluated); "
              f"C whole queue {run['c_queue_ms']:.3f} ms ({run['c_queue_us_per_real_pod']:.2f} us per real pod, "
              f"{run['c_queue_barriers_per_pod']:.2f} barriers per pod), C {PREFIX} full {run['c_ms']:.3f} ms; "
              f"equal to the plain versions {card}", flush=True)
        print(f"    A, block 0's cycles by phase: {shares(share_a)}")
        print(f"    C whole queue, block 0's cycles by phase: {shares(share_q)}", flush=True)
    chain.CLUSTER_SIZE = 0
    auto_cs = clusters["schedule_scan"]["cluster"]
    ms_a = by_cluster[auto_cs]["a_ms"]
    ms_c_queue = by_cluster[auto_cs]["c_queue_ms"]
    ms_c = by_cluster[auto_cs]["c_ms"]
    ms_b = cuda_ms(lambda: batch_eval(fprog, fused._node_state, fused._pods, fused._aux, fcarries), reps=B_REPS)
    inputs = tensor_bytes(state0) + tensor_bytes(pods0) + tensor_bytes(aux)
    carry_out = tensor_bytes([state0.requested, state0.nonzero_requested, state0.pod_count, carries0])
    a_bytes = inputs + P * 4 + carry_out
    S = len(fprog.scores)
    b_bytes = inputs + P * 4 + P * N * 4 + P * S * N * 2
    ops_a, ops_b, ops_c = pair_ops(sched), pair_ops(fused), pair_ops(sampled_2k)
    # The work the functions need: the real pods against the valid nodes;
    # a selection scores only the feasible pairs, while B's final record
    # holds every real pair's scores.
    b_ops = (ops_b["filter"] + ops_b["score"]) * count_b.pairs
    b_bound, b_by = bound_ms(b_bytes, b_ops)
    # Kernel C filters only the nodes its window visits and scores only
    # the sampled feasible ones.
    P2 = s2pods.valid.shape[0]
    n_pods_2k = len(feats_2k.pods.keys)
    visited_2k = res_samp_2k.visited[:n_pods_2k]
    feasible_2k = (res_samp_2k.reason_bits[:n_pods_2k] == 0).all(axis=1)
    visit_pairs = int(visited_2k.sum())
    sample_pairs = int((feasible_2k & visited_2k).sum())
    _, c_carries_out, _, c_out = schedule_sampled(s2prog, s2state, s2pods, s2aux, s2carries, start0, n_real,
                                                  SAMPLING_K)
    c_bytes = (tensor_bytes(s2state) + tensor_bytes(s2pods) + tensor_bytes(s2aux) + tensor_bytes(c_out)
               + tensor_bytes([s2state.requested, s2state.nonzero_requested, s2state.pod_count, c_carries_out]) + 4)
    del c_out, c_carries_out
    c_ops = ((ops_c["sample"] + ops_c["commit"]) * n_pods_2k * n_real + ops_c["filter"] * visit_pairs
             + ops_c["score"] * sample_pairs)
    c_bound, c_by = bound_ms(c_bytes, c_ops)
    cq_bound, cq_by, cq_note = sampled_queue_bound(sprog, state0, pods0, aux, carries0, start0, n_real, res_samp,
                                                   pair_ops(sampled), n_pods)
    pairs = n_pods * n_real
    print(f"  schedule_scan (kernel A), {P} x {N} selection: {ms_a:.3f} ms per pass, "
          f"{pairs / (ms_a / 1e3):.4g} real pod-node pairs/s {card}")
    print(f"  schedule_scan plain, first {PLAIN_PREFIX} pods, record=full: {plain_ms['schedule_scan']:.1f} ms {card}")
    print(f"  batch_eval (kernel B), {P} x {N} final, one launch: {ms_b:.3f} ms, "
          f"{pairs / (ms_b / 1e3):.4g} real pairs/s {card}")
    print(f"  batch_eval plain: {plain_ms['batch_eval']:.1f} ms {card}")
    print(f"  batch_eval bound: {b_bound:.4f} ms by {b_by} ({b_bytes} bytes; "
          f"{ops_b['filter'] + ops_b['score']:.1f} ops on each of {count_b.pairs} real pairs)")
    print(f"  schedule_sampled (kernel C), {P2} x {N} full, k={SAMPLING_K}: {ms_c:.3f} ms per pass {card}")
    print(f"  schedule_sampled (kernel C), {P} x {N} selection (whole queue), k={SAMPLING_K}: "
          f"{ms_c_queue:.3f} ms per pass, cluster of {auto_cs} {card}")
    print(f"  schedule_sampled plain, first {PLAIN_PREFIX} of {P2} pods x {N}, full: "
          f"{plain_ms['schedule_sampled']:.1f} ms {card}")
    print(f"  schedule_sampled whole-queue bound: {cq_bound:.4f} ms by {cq_by} ({cq_note})")
    print(f"  schedule_sampled bound: {c_bound:.4f} ms by {c_by} ({c_bytes} bytes; "
          f"{ops_c['sample'] + ops_c['commit']:.1f} ops per real pair, {ops_c['filter']:.1f} per pair "
          f"on {visit_pairs} visited pairs, {ops_c['score']:.1f} per scored pair on {sample_pairs} "
          f"sampled feasible pairs)")

    # Kernel B at evaluate_batch's per-chunk launch: 2048 pods, full record.
    cprog, cstate, cpods, caux = full_2k._prog, full_2k._node_state, full_2k._pods, full_2k._aux
    ccarries = cprog.init_carries(caux)
    ms_bc = cuda_ms(lambda: batch_eval(cprog, cstate, cpods, caux, ccarries), reps=B_REPS)
    plain_bc = cuda_ms(lambda: batch_eval_plain(cprog, cstate, cpods, caux, ccarries), reps=1)
    Pc = cpods.valid.shape[0]
    bc_out = tensor_bytes(batch_eval(cprog, cstate, cpods, caux, ccarries))
    bc_bytes = tensor_bytes(cstate) + tensor_bytes(cpods) + tensor_bytes(caux) + bc_out
    ops_bc = pair_ops(full_2k)
    bc_bound, bc_by = bound_ms(bc_bytes, (ops_bc["filter"] + ops_bc["score"]) * n_pods_2k * n_real)
    print(f"  batch_eval (kernel B), {Pc} x {N} full, one chunk: {ms_bc:.3f} ms; plain "
          f"{plain_bc:.1f} ms; bound {bc_bound:.4f} ms by {bc_by} ({bc_bytes} bytes) {card}")
    b_notes = batch_shape(lambda: batch_eval(fprog, fused._node_state, fused._pods, fused._aux, fcarries), card)
    b_notes.update(chunk_ms=ms_bc, chunk_plain_ms=plain_bc, chunk_bound_ms=bc_bound, chunk_bound_by=bc_by,
                   chunk_shape=f"{Pc}x{N} full")
    ns = prepass_phase(check, (fprog, fused._node_state, fused._aux, fcarries), card)

    t_wait = time.perf_counter()
    late.wait()
    print(f"  {', '.join(late.names)} built; waited {time.perf_counter() - t_wait:.1f} s for it, "
          f"{time.perf_counter() - t_build:.1f} s after the build began")
    print_build_log(late.names)
    phase("6 churn replay (kernel D)")
    churn = churn_phase(check, card)
    launches.update(churn["launches"])
    plain_ms["replay_segment"], plain_ms["derive_interpod"] = (churn[k][1] for k in ("replay_segment", "derive_interpod"))

    phase(f"7 fleet replay ({FLEET_LANES} lanes, rows 10-11)")
    fleet = fleet_phase(check, card, churn["solo_steps"])
    launches["replay_segment_fleet"] = fleet["launches"]
    plain_ms["replay_segment_fleet"] = fleet["plain_ms"]

    phase("8 kernel D completed: the victim search and record=full")
    completed = completed_d_phase(check, card)

    phase("9 the chain past its old caps (kernels A-D), and kernel B past the old node bound")
    wide_phase(check, card)

    phase("10 the replay executor (reuse, watchdog, breaker) and streaming trace ingest")
    executor = executor_phase(check, card)

    phase("11 the extension surface: the samples in kernels A-D, a webhook extender; hooked profiles on "
          "kernel E (d) beside phase 12, and the profiler (e), after it")
    default_ms = {"A": ms_a, "C queue": ms_c_queue, "B fused": ms_b, "B chunk": ms_bc, "D": churn["replay_segment"][0]}
    ext = extension_phase(check, card, smi, nodes, pods, default_ms, args.seed)

    phase("12 the front door: the port's commands as processes on the card (11 (d) beside it, 13 beside (b)-(d))")
    # Phase 12 runs on a thread of its own and phase 11 (d)'s legs on
    # this one; phase 13 runs beside phase 12's (b)-(d) on cores of its
    # own.  (d)'s and 13's lines print after phase 12's.
    job_lines: list = []
    staged_lines: list = []
    with ThreadPoolExecutor(max_workers=1) as front_pool:
        front_run = front_pool.submit(front_door_phase, card, front_refs,
                                      beside=lambda cores: job_plane_phase(card, cores, job_lines.append))
        legs = staged_legs(check, card, feats, res.selected, ms_a, nodes, pods, staged_lines.append)
        front = front_run.result()
    phase("11 (d) hooked profiles on kernel E: (i)-(iii) ran beside phase 12, (iv) now; (e) the profiler")
    print("\n".join(staged_lines), flush=True)
    staged = staged_timings(check, card, legs)
    profiler_leg(card)
    phase("13 the job plane: jobs on kernel D through the server, journaled, resumed after SIGKILL "
          "(ran beside phase 12's (b)-(d))")
    print("\n".join(job_lines), flush=True)
    jobs = front["beside"]

    # Kernel A's whole queue against its plain version on the CPU (started
    # after phase 2), and the bound from the pairs that run counted.
    pq = plain_queue.result()
    if str(pq["digest"]) != main_digest:
        raise AssertionError("the CPU plain scan's inputs differ from the main path's")
    check.equal("schedule_scan", "main-path selected, whole queue (plain version on the CPU)", res.selected,
                pq["selected"])
    same_state("schedule_scan", "main-path schedule, whole queue (plain version on the CPU)", check, state,
               state._replace(**{f: pq[f"state_{f}"] for f in state._fields}))
    a_pairs, a_feasible = int(pq["pairs"]), int(pq["feasible"])
    a_ops = (ops_a["filter"] + ops_a["commit"]) * a_pairs + ops_a["score"] * a_feasible
    a_bound, a_by = bound_ms(a_bytes, a_ops)
    print(f"  schedule_scan (kernel A) whole queue ({P} x {N} selection) equals its plain version on the CPU "
          f"(selections and final node state; the plain scan took {float(pq['wall_s']):.1f} s there, in a "
          f"process started after phase 2); bound {a_bound:.4f} ms by {a_by} ({a_bytes} bytes; "
          f"{ops_a['filter'] + ops_a['commit']:.1f} ops on each of {a_pairs} real pairs, "
          f"{ops_a['score']:.1f} more on each of {a_feasible} feasible ones)", flush=True)
    plain_ms["node_summary"] = ns["plain_ms"]
    measured = {
        "schedule_scan": (ms_a, a_bound, a_by, f"{P}x{N} selection"),
        "batch_eval": (ms_b, b_bound, b_by, f"{P}x{N} final"),
        "node_summary": (ns["ms"], ns["bound_ms"], ns["bound_by"], f"{N} nodes (the fused launch's state)"),
        "schedule_sampled": (ms_c, c_bound, c_by, f"{P2}x{N} full"),
        **{k: (churn[k][0], churn[k][2], churn[k][3], churn[k][4]) for k in ("replay_segment", "derive_interpod")},
        "replay_segment_fleet": fleet["measured"],
    }
    # Kernel E (phase 11 (d)): its launches on the staged legs, its times at
    # one pod of the scan.
    for name, e in staged.items():
        launches[name] = e.pop("launches")
        plain_ms[name] = e.pop("plain_ms")
        measured[name] = (e.pop("ms"), e.pop("bound_ms"), e.pop("bound_by"), e.pop("shape"))
    # Row 6 runs inside kernel D: its "launches" are its runs there, as
    # the kernel counted them; its standalone entry ran no time on the path.
    cluster_keys = ("threads", "smem_bytes")
    notes = {"schedule_scan": {"cluster": auto_cs, **{k: by_cluster[auto_cs][k] for k in cluster_keys},
                               "plain_shape": f"the first {PLAIN_PREFIX} pods of the queue, record=full, on the "
                                              f"card; the whole queue is held against the plain version on the CPU",
                               "plain_cpu_whole_queue_s": float(pq["wall_s"]),
                               "us_per_real_pod": by_cluster[auto_cs]["a_us_per_real_pod"],
                               "barriers_per_pod": by_cluster[auto_cs]["a_barriers_per_pod"],
                               "phase_share": by_cluster[auto_cs]["a_phase_share"],
                               "ms_by_cluster": {cs: r["a_ms"] for cs, r in by_cluster.items()}},
             "schedule_sampled": {"cluster": auto_cs, "plain_shape": f"the first {PLAIN_PREFIX} pods of the "
                                                                     f"{P2}-pod full-record pass, on the card",
                                  "queue_ms": ms_c_queue, "queue_bound_ms": cq_bound,
                                  "queue_bound_by": cq_by,
                                  "queue_shape": f"{P}x{N} selection, k={SAMPLING_K}",
                                  "queue_us_per_real_pod": by_cluster[auto_cs]["c_queue_us_per_real_pod"],
                                  "queue_barriers_per_pod": by_cluster[auto_cs]["c_queue_barriers_per_pod"],
                                  "queue_phase_share": by_cluster[auto_cs]["c_queue_phase_share"],
                                  "ms_by_cluster": {cs: r["c_ms"] for cs, r in by_cluster.items()},
                                  "queue_ms_by_cluster": {cs: r["c_queue_ms"] for cs, r in by_cluster.items()}},
             "batch_eval": b_notes,
             "node_summary": {"launches_are": "pre-passes on the main path, one per kernel B launch",
                              "wrapper_ms": ns["wrapper_ms"]},
             "derive_interpod": {"launches_are": "runs inside replay_segment, counted on the card",
                                 "standalone_launches": 0},
             "replay_segment": {**churn["d_ran"], "kernel_ms": churn["kernel_ms"],
                                "fullest_50k": churn["fullest_50k"], "widest_light_50k": churn["widest_light_50k"],
                                **completed,
                                "executor": {**churn["executor"], **executor}},
             "replay_segment_fleet": {"launches_are": "launches on the vmap leg of phase 7", **fleet["extra"]}}
    for name, note in ext["samples"].items():
        notes.setdefault(name, {})["phase_11"] = note
    for name, note in staged.items():
        notes[name] = note
    # Phase 12's launches ran in the servers' processes: their count is
    # the card's kernel records in each server's torch.profiler trace.
    for name, leg, key in (("schedule_scan", "b", "A"), ("schedule_sampled", "c", "C"), ("batch_eval", "d", "B")):
        notes.setdefault(name, {})["phase_12"] = {"leg": leg, "trace_launches": front[leg]["trace_launches"][key],
                                                  "trace_ms": front[leg]["device"]["named_ms"][key],
                                                  "leg_wall_s": front[leg]["wall_s"]}
    # Phase 13's launches ran in the servers' processes too: (a)'s and
    # (b)'s server's trace.
    for name, key, leg in (("replay_segment", "D", "a"), ("replay_segment_fleet", "D lanes", "b")):
        notes.setdefault(name, {})["phase_13"] = {
            "leg": leg, "trace_launches": jobs["device"]["launches"][key],
            "trace_ms": jobs["device"]["named_ms"][key], "job_wall_s": jobs[leg]["wall_s"],
            "replay_wall_s": jobs[leg]["replay_s"]}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": check.max_err[name],
            "ms": measured[name][0],
            "plain_ms": plain_ms[name],
            "bound_ms": measured[name][1],
            "bound_by": measured[name][2],
            "library_ms": None,
            "shape": measured[name][3],
            "rows": list(rows),
            **notes.get(name, {}),
        }
        for name, (source, replaces, rows) in KERNELS.items()
    ]
    print(f"chip_smoke took {time.perf_counter() - T0:.1f} s, build included [{smi}]")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
