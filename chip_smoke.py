#!/usr/bin/env python3
"""Drive ksim_tpu_torch's scheduling path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name, count and power limit;
2. build: nvcc builds every kernel from ksim_tpu_torch/csrc, one process
   per source, all at once (seconds and ptxas register / shared-memory
   lines);
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
   take a third of the run's time limit);
5. timings with CUDA events, beside each kernel's bound.  Each kernel's
   ms, plain_ms and bound_ms are taken on one shape: A over the whole
   queue (selection), B fused over the whole queue (final), C on the
   2048-pod full-record pass; C's whole-queue time is printed beside it;
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
   kernel D, its host and kernel time apart.  D's and derive_interpod's
   ms, plain ms and bound are taken on one segment of the 6k f32 run.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launches, errors, times and bounds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import ksim_tpu_torch.engine.replay as replay_mod
import ksim_tpu_torch.kernels.replay_segment as segment_mod
from ksim_tpu_torch.engine.annotations import ALL_RESULT_KEYS, RenderCtx, render_pod_results
from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.kernels import build
from ksim_tpu_torch.kernels.batch_eval import batch_eval, batch_eval_plain
from ksim_tpu_torch.kernels.replay_segment import (
    derive_interpod,
    derive_interpod_plain,
    derive_layout,
    derive_runs,
    replay_segment,
    replay_segment_plain,
    reset_derive_runs,
)
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled, schedule_sampled_plain
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan, schedule_scan_plain
from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scenario.runner import ScenarioRunner
from ksim_tpu_torch.state.featurizer import Featurizer

# The cluster builders live in tests/ (stdlib only).  They are imported
# from that directory, not as the package ``tests``: an installed package
# of that name can shadow it.
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from helpers import random_cluster  # noqa: E402
from test_torch_clusters import (  # noqa: E402
    images_ports_cluster,
    spread_affinity_cluster,
    volume_cluster,
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
# The churn replay: the behavior locks (seed 0, 2000 nodes, 100 ops per
# step), events -> (events applied, scheduled, unschedulable).
CHURN_NODES = 2000
CHURN_LOCKS = {6000: (6430, 2524, 471), 50_000: (None, 52781, 42829)}
SEGMENT_K = 16
# ksim_tpu's own device lock asks the kernel to carry at least this many
# of the 6k run's 41 steps (tests/test_replay_device.py).
MIN_DEVICE_STEPS = 32

KERNELS = {
    "schedule_scan": ("ksim_tpu_torch/csrc/schedule_scan.cu", "ksim_tpu/engine/core.py:790"),
    "batch_eval": ("ksim_tpu_torch/csrc/batch_eval.cu", "ksim_tpu/engine/core.py:670"),
    "schedule_sampled": ("ksim_tpu_torch/csrc/schedule_sampled.cu", "ksim_tpu/engine/core.py:750"),
    "replay_segment": ("ksim_tpu_torch/csrc/replay_segment.cu", "ksim_tpu/engine/replay.py:492"),
    "derive_interpod": ("ksim_tpu_torch/csrc/derive_interpod.cuh", "ksim_tpu/engine/replay.py:459"),
}
WRAPPERS = {"schedule_scan": schedule_scan, "batch_eval": batch_eval, "schedule_sampled": schedule_sampled}


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


def churn_run(n_events: int, *, device_replay: bool, exact: bool):
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
        if drv.device_steps < MIN_DEVICE_STEPS:
            raise AssertionError(f"{what}: the kernel carried {drv.device_steps} steps, "
                                 f"fewer than {MIN_DEVICE_STEPS}")
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
    runs = {}
    try:
        for exact in (False, True):
            segments.clear()
            replay_segment.launches = 0
            reset_derive_runs()
            derive_interpod.launches = 0
            res, drv, wall, what = churn_run(6000, device_replay=True, exact=exact)
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
            runs[exact] = (list(segments), launches, drv.kernel_ms)
    finally:
        replay_mod.replay_segment = kernel

    segments, launches, kernel_ms_6k = runs[False]
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

    res50, drv50, wall50, what50 = churn_run(50_000, device_replay=True, exact=False)
    host50 = {k: v for k, v in res50.phase_seconds.items() if k.startswith("replay.") or k == "runner.step"}
    print(f"  {what50}: {res50.pods_scheduled} scheduled, {res50.unschedulable_attempts} unschedulable (the "
          f"lock); {drv50.device_steps} steps on the card in {drv50.device_round_trips} launches, "
          f"{drv50.fallback_steps} per-pass; wall {wall50:.2f} s, kernel {drv50.kernel_ms:.1f} ms, "
          f"host phases {host50} {card}", flush=True)

    # Timings on one segment of the 6k f32 run: the fullest one.
    pick = max(range(len(segments)), key=lambda i: int((segments[i][6]["idx"] < segments[i][2]["pods"]["requests"].shape[0]).sum()))
    st, prog, const, ev, state0, final, outs = segments[pick]
    P = const["pods"]["requests"].shape[0]
    N = const["node"]["allocatable"].shape[0]
    idx = outs["idx"]
    attempted = idx[idx < P].long()
    n_att = int(attempted.numel())
    ms_d = cuda_ms(lambda: kernel(st, prog, const, ev, state0), reps=3)
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
    }


def main() -> int:
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
    build.build()
    print(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f}s")
    for name, log in build.BUILD_LOG.items():
        print(f"  {name}: nvcc {log['seconds']:.1f}s")
        for line in log["ptxas"]:
            print(f"    {line.strip()}")

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
    print(f"  main path ran; launches {launches}")
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
    check.equal("schedule_scan", "main-path selected, whole queue", res.selected,
                plain_out["selected"].cpu().numpy())
    same_state("schedule_scan", "main-path schedule", check, state, plain_state)
    del plain_state, plain_out
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
    ms_a = cuda_ms(lambda: schedule_scan(prog, state0, pods0, aux, carries0), reps=3)
    ms_b = cuda_ms(lambda: batch_eval(fprog, fused._node_state, fused._pods, fused._aux, fcarries), reps=3)
    sprog = sampled._prog
    ms_c_queue = cuda_ms(
        lambda: schedule_sampled(sprog, state0, pods0, aux, carries0, start0, n_real, SAMPLING_K), reps=3
    )
    ms_c = cuda_ms(
        lambda: schedule_sampled(s2prog, s2state, s2pods, s2aux, s2carries, start0, n_real, SAMPLING_K), reps=3
    )
    P, N = pods0.valid.shape[0], state0.valid.shape[0]
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
    print(f"  schedule_sampled (kernel C), {P2} x {N} full, k={SAMPLING_K}: {ms_c:.3f} ms; "
          f"{P} x {N} selection (whole queue): {ms_c_queue:.3f} ms per pass {card}")
    print(f"  schedule_sampled plain, {P2} x {N} full: {plain_ms['schedule_sampled']:.1f} ms {card}")
    print(f"  schedule_sampled bound: {c_bound:.4f} ms by {c_by} ({c_bytes} bytes; "
          f"{ops_c['sample'] + ops_c['commit']:.1f} ops per real pair, {ops_c['filter']:.1f} per pair "
          f"on {visit_pairs} visited pairs, {ops_c['score']:.1f} per scored pair on {sample_pairs} "
          f"sampled feasible pairs)")

    # Kernel B at evaluate_batch's per-chunk launch: 2048 pods, full record.
    cprog, cstate, cpods, caux = full_2k._prog, full_2k._node_state, full_2k._pods, full_2k._aux
    ccarries = cprog.init_carries(caux)
    ms_bc = cuda_ms(lambda: batch_eval(cprog, cstate, cpods, caux, ccarries), reps=3)
    plain_bc = cuda_ms(lambda: batch_eval_plain(cprog, cstate, cpods, caux, ccarries), reps=1)
    Pc = cpods.valid.shape[0]
    bc_out = tensor_bytes(batch_eval(cprog, cstate, cpods, caux, ccarries))
    bc_bytes = tensor_bytes(cstate) + tensor_bytes(cpods) + tensor_bytes(caux) + bc_out
    ops_bc = pair_ops(full_2k)
    bc_bound, bc_by = bound_ms(bc_bytes, (ops_bc["filter"] + ops_bc["score"]) * n_pods_2k * n_real)
    print(f"  batch_eval (kernel B), {Pc} x {N} full, one chunk: {ms_bc:.3f} ms; plain "
          f"{plain_bc:.1f} ms; bound {bc_bound:.4f} ms by {bc_by} ({bc_bytes} bytes) {card}")

    phase("6 churn replay (kernel D)")
    churn = churn_phase(check, card)
    launches.update(churn["launches"])
    plain_ms["replay_segment"], plain_ms["derive_interpod"] = (churn[k][1] for k in ("replay_segment", "derive_interpod"))

    measured = {
        "schedule_scan": (ms_a, a_bound, a_by, f"{P}x{N} selection"),
        "batch_eval": (ms_b, b_bound, b_by, f"{P}x{N} final"),
        "schedule_sampled": (ms_c, c_bound, c_by, f"{P2}x{N} full"),
        **{k: (v[0], v[2], v[3], v[4]) for k, v in churn.items() if k != "launches"},
    }
    # Row 6 runs inside kernel D: its "launches" are its runs there, as
    # the kernel counted them; its standalone entry ran no time on the path.
    notes = {"derive_interpod": {"launches_are": "runs inside replay_segment, counted on the card",
                                 "standalone_launches": 0}}
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
            **notes.get(name, {}),
        }
        for name, (source, replaces) in KERNELS.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
