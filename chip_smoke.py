#!/usr/bin/env python3
"""Drive ksim_tpu_torch's scheduling path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name, count and power limit;
2. build: nvcc builds every kernel from ksim_tpu_torch/csrc, one process
   per source, all at once (seconds and ptxas register / shared-memory
   lines); kernel D's, the longest, is waited for only before phase 6;
3. kernel vs plain: on random_cluster(0, 512 nodes, 256 pods), a cluster
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
   and the commit invariant: kernel A's whole-queue pass against the
   plain scan over the whole queue, kernel C's against the plain sampled
   scan over the first 2048 pods (a sequential scan's prefix is the
   whole run's prefix; the plain sampled scan over the whole queue would
   take a third of the run's time limit).  Kernels A and C run on one
   thread-block cluster whose size the launch picks (16 blocks where the
   card has room, else 8); the main path must get at least 8;
5. timings with CUDA events, beside each kernel's bound.  Kernels A and C
   at clusters of 8 and of 16 blocks, each size held equal to the plain
   versions again (A's whole queue, C's 2048-pod full-record pass and its
   whole queue's prefix) and timed, with the microseconds per real pod,
   the cluster barriers per evaluated pod and block 0's cycles by phase
   of a pod (counted by the kernel).  Each kernel's ms, plain_ms and
   bound_ms are taken on one shape: A over the whole queue (selection),
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
   plain version on every segment of the f32 run (every output and the
   final state) and on the first segment of the exact run, and row 6's
   standalone entry (derive_interpod) equals its plain version on the
   first segment's state; then the 50k flagship (52781 / 42829) through
   kernel D, its host and kernel time apart, and D on that run's fullest
   segment against its plain version, timed beside its bound.  D's and derive_interpod's
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
   lane, the solo kernel-D launch on the same inputs, and a 2-lane fleet
   launch of that segment equals replay_segment_fleet_plain.  Rows
   10-11's ms and bound are the 8-lane launch's, its plain ms the 2-lane
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
   nodes (tests/test_torch_gpu_replay.py preemption_churn_stream) on the
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
   every other window), and with every dispatch failing (the breaker
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
   service, equal to the CPU run, with the per-pod split; (d) a hooked
   profile (a PluginExtender device hook) refused on the card with no
   launch, the same profile without hooks on kernel A; (e) a profiled pass
   whose trace names the pass and kernel A's launch, its profile holding
   the lifecycle samples (FifoSort, NamePrefixGate, PlacementExport).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors, times and bounds (each with
its phase-11 numbers, all measured in this run, under "phase_11").
"""

from __future__ import annotations

import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

import ksim_tpu_torch.engine.replay as replay_mod
import ksim_tpu_torch.kernels.replay_segment as segment_mod
from ksim_tpu_torch.engine.annotations import ALL_RESULT_KEYS, RenderCtx, render_pod_results
from ksim_tpu_torch.engine.core import Engine, PluginExtender, ScoredPlugin
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.kernels import build, chain
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
from ksim_tpu_torch.plugins.base import FilterOutput
from ksim_tpu_torch.plugins.samples import (
    data_provider_builder,
    encode_node_number,
    node_number_builder,
    provider_encoder,
)
from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scenario.runner import Operation, ScenarioRunner
from ksim_tpu_torch.scheduler.extender import EXTENDER_FILTER_RESULT_KEY
from ksim_tpu_torch.scheduler.service import SchedulerService
from ksim_tpu_torch.state.cluster import ClusterStore
from ksim_tpu_torch.state.featurizer import Featurizer
from ksim_tpu_torch.traces import stream_trace_operations, trace_operations

# The cluster builders live in tests/ (stdlib only).  They are imported
# from that directory, not as the package ``tests``: an installed package
# of that name can shadow it.
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from fixtures.preemption_victims import CASES as PREEMPTION_CASES  # noqa: E402
from helpers import random_cluster  # noqa: E402
from test_torch_clusters import (  # noqa: E402
    images_ports_cluster,
    spread_affinity_cluster,
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
SMALL = (512, 256)
MAIN = (5000, 10000)
PREFIX = 2048
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
# Phase 7: the fleet's lanes, and the lanes of the plain comparison.
FLEET_LANES = 8
FLEET_PLAIN_LANES = 2
# Phase 8: the preemption-heavy churn's node count.
PREEMPT_NODES = 2000

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
}
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
# on this full-record prefix of the queue (B on PREFIX); the extender run
# (2000 nodes, 64 pending pods), the hooked profile (2000 x 512) and the
# profiled pass (500 nodes, 64 pods).
SAMPLES_PREFIX = 512
# Launches per CUDA-event timing of kernel B (2-10 ms per launch): the
# host's first launch after the start event (building its params) is
# then a small share of the mean, where 3 launches left it at several
# percent.
B_REPS = 20
EXT_SHAPE = (2000, 64)
HOOK_SHAPE = (2000, 512)
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


class PlainEngine(Engine):
    """The same engine running the kernels' plain versions."""

    _scan_fn = staticmethod(schedule_scan_plain)
    _sampled_fn = staticmethod(schedule_sampled_plain)
    _batch_fn = staticmethod(batch_eval_plain)


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

    def results(self, kernel: str, what: str, got, want, record: str = "full") -> None:
        """``got`` (kernel, record mode ``record``) against ``want`` (plain,
        record="full" or the same mode), on the fields ``record`` keeps."""
        for name in RESULT_FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            if name not in RECORDED[record]:
                if a is not None:
                    raise AssertionError(f"{what}.{name}: recorded outside record={record}")
                continue
            if (a is None) != (b is None):
                raise AssertionError(f"{what}.{name}: recorded by one side only")
            if a is not None:
                self.equal(kernel, f"{what}.{name}", a, b)
        if got.sampling_next_start != want.sampling_next_start:
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
    print(f"== {name}", flush=True)


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
    t = time.perf_counter()
    plain_seg_ms, seg_pairs = [], []
    for i, (st, prog, const, ev, state0, final, outs) in enumerate(segments + runs[True][0][:1]):
        mode = "f32" if i < len(segments) else "exact"
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with PairCount(prog, const["pods"]["requests"].shape[0]) as count:
            start.record()
            want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
            end.record()
            torch.cuda.synchronize()
        plain_seg_ms.append(start.elapsed_time(end))
        seg_pairs.append((count.pairs, count.feasible))
        tree_equal(check, "replay_segment", f"6k {mode} segment {i} outputs", outs, want_outs)
        tree_equal(check, "replay_segment", f"6k {mode} segment {i} final state", final, want_final)
    print(f"  kernel D equals its plain version on the {len(segments)} segments of the f32 run and the "
          f"first of the exact run ({time.perf_counter() - t:.1f} s)", flush=True)
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
    # The 50k run's fullest segment: D's time there beside its bound.
    st, prog, const, ev, state0, final, outs = max(
        segments50, key=lambda seg: int((seg[6]["idx"] < seg[2]["pods"]["requests"].shape[0]).sum()))
    ms50 = cuda_ms(lambda: kernel(st, prog, const, ev, state0), reps=3)
    with PairCount(prog, const["pods"]["requests"].shape[0]) as count:
        want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
    tree_equal(check, "replay_segment", "50k fullest segment outputs", outs, want_outs)
    tree_equal(check, "replay_segment", "50k fullest segment final state", final, want_final)
    bytes50, ops50 = segment_work(st, prog, const, ev, state0, outs, final, (count.pairs, count.feasible))
    bound50, by50 = bound_ms(bytes50, ops50)
    att50 = int((outs["idx"] < const["pods"]["requests"].shape[0]).sum())
    shape50 = (f"K={st.k} x Q={st.q} x {const['node']['allocatable'].shape[0]} nodes x "
               f"{const['pods']['requests'].shape[0]} pod rows, {att50} attempts")
    segments50.clear()
    print(f"  the 50k run's fullest segment ({shape50}): {ms50:.3f} ms per launch; bound {bound50:.4f} ms by {by50} "
          f"({bytes50} bytes; {count.pairs} attempted pod x valid node pairs, {count.feasible} feasible); equal to "
          f"D's plain version {card}", flush=True)

    # Timings on one segment of the 6k f32 run: the fullest one.
    pick = max(range(len(segments)), key=lambda i: int((segments[i][6]["idx"] < segments[i][2]["pods"]["requests"].shape[0]).sum()))
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
        "fullest_50k": {"ms": ms50, "bound_ms": bound50, "bound_by": by50, "shape": shape50},
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
    # then a 2-lane launch against the plain fleet version.
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
    for i, (st, prog, const, ev, state0, final, outs) in enumerate(segments):
        want_final, want_outs = replay_segment_plain(st, prog, const, ev, state0)
        tree_equal(check, "replay_segment", f"watchdog leg segment {i} outputs", outs, want_outs)
        tree_equal(check, "replay_segment", f"watchdog leg segment {i} final state", final, want_final)
    print(f"  {what}, {WATCHDOG_S} s watchdog, first dispatch hung {HANG_S} s: the lock; 1 timeout, "
          f"{drv.fallback_steps} step per-pass, {drv.device_steps} on the card; kernel D equal to its plain version "
          f"on all {len(segments)} launches (the abandoned worker's included); wall {wall:.2f} s {card}", flush=True)
    out["watchdog"] = {"timeouts": drv.watchdog_timeouts, "fallback_steps": drv.fallback_steps,
                       "device_steps": drv.device_steps, "launches_checked": len(segments), "wall_s": wall}
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
            res = runner.run(preemption_churn_stream(n_nodes=PREEMPT_NODES))
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


def extension_phase(check: Check, card: str, smi: str, nodes, pods, default_ms: dict, seed: int) -> dict:
    """Phase 11: (a) the main path's pass with the samples through kernels
    A, C and B, each against its plain version, timed beside the default
    profile's times and the baseline's; (b) the 6k churn with NodeNumber
    through kernel D against the per-pass path, and an 8-lane fleet leg;
    (c) a webhook extender on 127.0.0.1 through the service (kernel B per
    pod) against the CPU run; (d) a hooked profile refused on the card;
    (e) a profiled pass.  Returns each kernel's phase-11 notes."""
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

    # -- (d) a hooked profile: no kernel runs a Python hook, so the card
    #    refuses it when its Engine is built ---------------------------------
    td = time.perf_counter()
    feats_h = Featurizer().featurize(*random_cluster(2, *HOOK_SHAPE))

    def veto(state, pods_, aux_, out):
        first = torch.arange(out.ok.shape[-1], device=out.ok.device) == 0
        return FilterOutput(ok=out.ok & ~first, reason_bits=torch.where(first, 1, out.reason_bits).to(torch.int32))

    hook = PluginExtender(after_filter=veto, after_score=lambda state, pods_, aux_, scores: scores + 7)
    hooked = tuple(
        ScoredPlugin(sp.plugin, sp.weight, sp.filter_enabled, sp.score_enabled,
                     extender=hook if sp.plugin.name == "NodeResourcesFit" else None)
        for sp in default_plugins(feats_h)
    )
    _zero_launches()
    try:
        Engine(feats_h, hooked, record="full", exact=True, device=DEVICE)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError("the hooked profile was not refused on the card")
    if any(_launches().values()):
        raise AssertionError(f"the refused profile launched a kernel: {_launches()}")
    unhooked = Engine(feats_h, default_plugins(feats_h), record="selection", device=DEVICE)
    unhooked.schedule()
    if schedule_scan.launches < 1:
        raise AssertionError("the profile without hooks did not run on kernel A")
    print(f"  hooked profile ({HOOK_SHAPE[0]} nodes x {len(feats_h.pods.keys)} pods, after_filter veto of node 0 and "
          f"after_score +7 on NodeResourcesFit): refused on the card ({refusal!r}), no launch; the same profile "
          f"without hooks ran on kernel A ({schedule_scan.launches} launches); (d) took "
          f"{time.perf_counter() - td:.1f} s {card}", flush=True)

    # -- (e) the profiler, over a pass of a profile with the lifecycle
    #    samples (markers the kernels skip: the pass stays on kernel A) --
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
    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s {card}", flush=True)
    return {"samples": notes}


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="the seed of phase 11's provided scores")
    args = parser.parse_args()
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
    t0 = time.perf_counter()
    # Kernel D's source builds longest and is first used in phase 6: its
    # nvcc runs beside phases 3-5 (joined before phase 6).
    late = LateBuild(("replay_segment",))
    early = tuple(name for name in build.SOURCES if name not in late.names)
    build.build(early)
    print(f"built {', '.join(early)} in {time.perf_counter() - t0:.1f}s; "
          f"{', '.join(late.names)} building beside phases 3-5")
    print_build_log(early)

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
    nodes, pods = random_cluster(0, n_nodes_main, n_pods_main, bound_fraction=0.0)
    feats = Featurizer().featurize(nodes, pods)
    feats_2k = Featurizer().featurize(nodes, pods[:PREFIX])
    print(f"  featurized {feats.pods.valid.shape[0]} x {feats.nodes.valid.shape[0]} "
          f"(padded) in {time.perf_counter() - t0:.1f}s")
    plugins = default_plugins(feats)
    plugins_2k = default_plugins(feats_2k)
    sched = Engine(feats, plugins, record="selection", exact=True, device=DEVICE)
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

    schedule_scan_plain(prog, state0, pods0.rows(0, 16), aux, carries0)  # warm-up
    with PairCount(prog, n_pods) as count_a:
        plain_state, _, plain_out = plain_timed(
            "schedule_scan", lambda: schedule_scan_plain(prog, state0, pods0, aux, carries0)
        )
    plain_sel_a = plain_out["selected"].cpu().numpy()
    check.equal("schedule_scan", "main-path selected, whole queue", res.selected, plain_sel_a)
    same_state("schedule_scan", "main-path schedule", check, state, plain_state)
    del plain_out
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
    # Kernel C against the plain sampled scan on the 2048-pod full-record
    # pass, and the whole-queue pass on its first 2048 pods.
    s2prog, s2state, s2pods, s2aux = sampled_2k._prog, sampled_2k._node_state, sampled_2k._pods, sampled_2k._aux
    s2carries = s2prog.init_carries(s2aux)
    schedule_sampled_plain(s2prog, s2state, s2pods.rows(0, 16), s2aux, s2carries, start0, n_real, SAMPLING_K)
    _, _, plain_next, plain_samp = plain_timed(
        "schedule_sampled",
        lambda: schedule_sampled_plain(s2prog, s2state, s2pods, s2aux, s2carries, start0, n_real, SAMPLING_K),
    )
    want_s2k = sampled_2k._to_result({key: v.cpu().numpy() for key, v in plain_samp.items()})
    want_s2k.sampling_next_start = int(plain_next)
    del plain_samp
    check.results("schedule_sampled", f"main-path sampled full {PREFIX}", res_samp_2k, want_s2k)
    check.equal("schedule_sampled", f"main-path sampled selected, first {PREFIX} pods of the whole queue",
                res_samp.selected[:PREFIX], want_s2k.selected[:PREFIX])
    plain_2k = PlainEngine(feats_2k, plugins_2k, record="full", exact=True, device=DEVICE)
    check.results("batch_eval", f"main-path evaluate_batch full {PREFIX}", res_full_2k, plain_2k.evaluate_batch())
    check.results("schedule_scan", f"main-path schedule full {PREFIX}", res_sched_2k, plain_2k.schedule()[0])
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
        check.equal("schedule_scan", f"{what}: selected, whole queue", out_a["selected"].cpu().numpy(), plain_sel_a)
        same_state("schedule_scan", f"{what}: whole queue", check, host_state(st_a), plain_state)
        bar_a, ev_a, share_a = stats(schedule_scan)
        shape_a = {k: schedule_scan.last[k] for k in ("threads", "smem_bytes")}
        _, _, nxt_q, out_q = run_c_queue()
        sel_q = out_q["selected"].cpu().numpy()
        check.equal("schedule_sampled", f"{what}: whole-queue selected, first {PREFIX} pods", sel_q[:PREFIX],
                    want_s2k.selected[:PREFIX])
        check.equal("schedule_sampled", f"{what}: whole-queue selected", sel_q, res_samp.selected)
        if int(nxt_q) != res_samp.sampling_next_start:
            raise AssertionError(f"{what}: whole-queue next start {int(nxt_q)} vs {res_samp.sampling_next_start}")
        bar_q, ev_q, share_q = stats(schedule_sampled)
        _, _, nxt_2k, out_2k = run_c()
        got_2k = sampled_2k._to_result({key: v.cpu().numpy() for key, v in out_2k.items()})
        got_2k.sampling_next_start = int(nxt_2k)
        check.results("schedule_sampled", f"{what}: sampled full {PREFIX}", got_2k, want_s2k)
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
    a_ops = (ops_a["filter"] + ops_a["commit"]) * count_a.pairs + ops_a["score"] * count_a.feasible
    b_ops = (ops_b["filter"] + ops_b["score"]) * count_b.pairs
    a_bound, a_by = bound_ms(a_bytes, a_ops)
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
    print(f"  schedule_scan plain, whole queue: {plain_ms['schedule_scan']:.1f} ms {card}")
    print(f"  schedule_scan bound: {a_bound:.4f} ms by {a_by} ({a_bytes} bytes; "
          f"{ops_a['filter'] + ops_a['commit']:.1f} ops on each of {count_a.pairs} real pairs, "
          f"{ops_a['score']:.1f} more on each of {count_a.feasible} feasible ones)")
    print(f"  batch_eval (kernel B), {P} x {N} final, one launch: {ms_b:.3f} ms, "
          f"{pairs / (ms_b / 1e3):.4g} real pairs/s {card}")
    print(f"  batch_eval plain: {plain_ms['batch_eval']:.1f} ms {card}")
    print(f"  batch_eval bound: {b_bound:.4f} ms by {b_by} ({b_bytes} bytes; "
          f"{ops_b['filter'] + ops_b['score']:.1f} ops on each of {count_b.pairs} real pairs)")
    print(f"  schedule_sampled (kernel C), {P2} x {N} full, k={SAMPLING_K}: {ms_c:.3f} ms per pass {card}")
    print(f"  schedule_sampled (kernel C), {P} x {N} selection (whole queue), k={SAMPLING_K}: "
          f"{ms_c_queue:.3f} ms per pass, cluster of {auto_cs} {card}")
    print(f"  schedule_sampled plain, {P2} x {N} full: {plain_ms['schedule_sampled']:.1f} ms {card}")
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

    late.wait()
    print(f"  {', '.join(late.names)} built, {time.perf_counter() - t0:.1f}s after the build began")
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

    phase("11 the extension surface: the samples in kernels A-D, a webhook extender, hooks, the profiler")
    default_ms = {"A": ms_a, "C queue": ms_c_queue, "B fused": ms_b, "B chunk": ms_bc, "D": churn["replay_segment"][0]}
    ext = extension_phase(check, card, smi, nodes, pods, default_ms, args.seed)

    plain_ms["node_summary"] = ns["plain_ms"]
    measured = {
        "schedule_scan": (ms_a, a_bound, a_by, f"{P}x{N} selection"),
        "batch_eval": (ms_b, b_bound, b_by, f"{P}x{N} final"),
        "node_summary": (ns["ms"], ns["bound_ms"], ns["bound_by"], f"{N} nodes (the fused launch's state)"),
        "schedule_sampled": (ms_c, c_bound, c_by, f"{P2}x{N} full"),
        **{k: (churn[k][0], churn[k][2], churn[k][3], churn[k][4]) for k in ("replay_segment", "derive_interpod")},
        "replay_segment_fleet": fleet["measured"],
    }
    # Row 6 runs inside kernel D: its "launches" are its runs there, as
    # the kernel counted them; its standalone entry ran no time on the path.
    cluster_keys = ("threads", "smem_bytes")
    notes = {"schedule_scan": {"cluster": auto_cs, **{k: by_cluster[auto_cs][k] for k in cluster_keys},
                               "us_per_real_pod": by_cluster[auto_cs]["a_us_per_real_pod"],
                               "barriers_per_pod": by_cluster[auto_cs]["a_barriers_per_pod"],
                               "phase_share": by_cluster[auto_cs]["a_phase_share"],
                               "ms_by_cluster": {cs: r["a_ms"] for cs, r in by_cluster.items()}},
             "schedule_sampled": {"cluster": auto_cs, "queue_ms": ms_c_queue, "queue_bound_ms": cq_bound,
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
                                "fullest_50k": churn["fullest_50k"], **completed,
                                "executor": {**churn["executor"], **executor}},
             "replay_segment_fleet": {"launches_are": "launches on the vmap leg of phase 7", **fleet["extra"]}}
    for name, note in ext["samples"].items():
        notes.setdefault(name, {})["phase_11"] = note
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
