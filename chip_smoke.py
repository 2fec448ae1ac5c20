#!/usr/bin/env python3
"""Drive ksim_tpu_torch's scheduling path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name, count and power limit;
2. build: nvcc builds every kernel from ksim_tpu_torch/csrc (seconds and
   ptxas register / shared-memory lines);
3. kernel vs plain: on random_cluster(0, 512 nodes, 256 pods) and on a
   cluster with images and host ports, each kernel equals its plain
   PyTorch version element for element (record modes full, final,
   selection; exact and f32 modes);
4. main path at full width: random_cluster(0, 5000 nodes, 10000 pods,
   bound_fraction=0), padded by the featurizer to 12288 x 6144, with
   the eight-plugin profile: featurize -> Engine(record="selection")
   .schedule() on the card, evaluate_batch_fused(record="final"),
   evaluate_batch(record="full") and a record="full" schedule on the
   first 2048 pods, and the 13 annotations of a few pods.  The kernels'
   launch counts are read around exactly that; then the results are held
   against the plain versions and the commit invariant;
5. timings with CUDA events, beside each kernel's bound.

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

from ksim_tpu_torch.engine.annotations import ALL_RESULT_KEYS, RenderCtx, render_pod_results
from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import UNPORTED, default_plugins
from ksim_tpu_torch.kernels import build
from ksim_tpu_torch.kernels.batch_eval import batch_eval, batch_eval_plain
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan, schedule_scan_plain
from ksim_tpu_torch.state.featurizer import Featurizer

# The cluster builders live in tests/ (stdlib only).  They are imported
# from that directory, not as the package ``tests``: an installed package
# of that name can shadow it.
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from helpers import random_cluster  # noqa: E402
from test_torch_clusters import images_ports_cluster  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM
# bandwidth, and the float32 rate outside the tensor cores, which this
# script charges every scalar integer or float operation against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

RESULT_FIELDS = ("selected", "total", "final_scores", "reason_bits", "scores")
DEVICE = "cuda"


class PlainEngine(Engine):
    """The same engine running the kernels' plain versions."""

    _scan_fn = staticmethod(schedule_scan_plain)
    _batch_fn = staticmethod(batch_eval_plain)


class Check:
    """Exact comparisons of kernel results with plain results; records
    the largest absolute difference seen per kernel."""

    def __init__(self) -> None:
        self.max_err = {"schedule_scan": 0, "batch_eval": 0}

    def equal(self, kernel: str, what: str, got: np.ndarray, want: np.ndarray) -> None:
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{what}: {got.dtype}{got.shape} vs {want.dtype}{want.shape}")
        err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(initial=0))
        self.max_err[kernel] = max(self.max_err[kernel], err)
        if err:
            raise AssertionError(f"{what}: kernel differs from plain (max |diff| {err})")

    def results(self, kernel: str, what: str, got, want) -> None:
        for name in RESULT_FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            if (a is None) != (b is None):
                raise AssertionError(f"{what}.{name}: recorded by one side only")
            if a is not None:
                self.equal(kernel, f"{what}.{name}", a, b)


def engines(feats, record: str, exact: bool):
    plugins = default_plugins(feats, disabled=UNPORTED)
    kw = dict(record=record, exact=exact, device=DEVICE)
    return Engine(feats, plugins, **kw), PlainEngine(feats, plugins, **kw)


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


def pair_ops(eng: Engine) -> float:
    """Scalar operations per pod-node pair of the eight-plugin chain, from
    the kernel's arithmetic with this run's vocab sizes; the data-
    dependent required-term loop is counted for the pods that have one."""
    aux = eng._aux
    W = aux["taints"]["forbidding"].shape[0]
    T = aux["affinity"]["term_size"].shape[0]
    V = aux["nodeports"]["pod_wants"].shape[1]
    I = aux["imagelocality"]["image_size"].shape[0]
    R = eng._node_state.allocatable.shape[1]
    req_share = float(aux["affinity"]["has_required"].float().mean())
    ops = 2 + 2  # NodeUnschedulable, NodeName
    ops += 4 * W + 3 * W  # taint filter scan, prefer-taint count
    ops += 3 + 2 * T * req_share + 2 * T  # affinity filter, preferred sum
    ops += 2 * V  # port conflicts
    ops += 2 + 4 * R  # Fit filter
    ops += 2 * 8 + 2  # Fit LeastAllocated score over cpu, memory
    ops += 14  # BalancedAllocation (exact, int64)
    ops += I + 12  # ImageLocality sum and clamp
    ops += 2 * 4 + 6  # two normalizes, total, selection key
    return ops


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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

    phase("3 kernel vs plain (512 nodes x 256 pods)")
    clusters = {
        "random_cluster(0, 512, 256)": random_cluster(0, 512, 256),
        "images_ports_cluster(3, 512, 256)": images_ports_cluster(3, n_nodes=512, n_pods=256),
    }
    for label, (nodes, pods) in clusters.items():
        feats = Featurizer().featurize(nodes, pods)
        for exact in (True, False):
            for record in ("full", "final", "selection"):
                what = f"{label} record={record} exact={exact}"
                kernel, plain = engines(feats, record, exact)
                got, got_state = kernel.schedule()
                want, want_state = plain.schedule()
                check.results("schedule_scan", f"schedule {what}", got, want)
                for field in got_state._fields:
                    check.equal("schedule_scan", f"state.{field} {what}",
                                getattr(got_state, field), getattr(want_state, field))
                if record == "full":
                    got_b, want_b = kernel.evaluate_batch(chunk=96), plain.evaluate_batch(chunk=96)
                else:
                    got_b, want_b = kernel.evaluate_batch_fused(), plain.evaluate_batch_fused()
                check.results("batch_eval", f"batch {what}", got_b, want_b)
                placed = int((got.selected >= 0).sum())
                print(f"  {what}: equal ({placed} placed)")

    phase("4 main path: random_cluster(0, 5000, 10000, bound_fraction=0.0)")
    t0 = time.perf_counter()
    nodes, pods = random_cluster(0, 5000, 10000, bound_fraction=0.0)
    feats = Featurizer().featurize(nodes, pods)
    feats_2k = Featurizer().featurize(nodes, pods[:2048])
    print(f"  featurized {feats.pods.valid.shape[0]} x {feats.nodes.valid.shape[0]} "
          f"(padded) in {time.perf_counter() - t0:.1f}s")
    plugins = default_plugins(feats, disabled=UNPORTED)
    plugins_2k = default_plugins(feats_2k, disabled=UNPORTED)
    sched = Engine(feats, plugins, record="selection", exact=True, device=DEVICE)
    fused = Engine(feats, plugins, record="final", exact=True, device=DEVICE)
    full_2k = Engine(feats_2k, plugins_2k, record="full", exact=True, device=DEVICE)
    torch.cuda.synchronize()

    schedule_scan.launches = 0
    batch_eval.launches = 0
    wall = {}  # host seconds per entry point, results on the host included

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        wall[name] = time.perf_counter() - t
        return out

    res, state = timed("schedule(selection)", sched.schedule)
    res_fused = timed("evaluate_batch_fused(final)", fused.evaluate_batch_fused)
    res_full_2k = timed("evaluate_batch(full, 2048 pods)", full_2k.evaluate_batch)
    res_sched_2k, _ = timed("schedule(full, 2048 pods)", full_2k.schedule)
    ctx = RenderCtx(feats_2k, plugins_2k)
    annotations = timed("annotations(3 pods)", lambda: [
        render_pod_results(feats_2k, plugins_2k, res_sched_2k, pi, ctx=ctx) for pi in range(3)
    ])
    launches = {"schedule_scan": schedule_scan.launches, "batch_eval": batch_eval.launches}
    print(f"  main path ran; launches {launches}")
    for name, sec in wall.items():
        print(f"    {name}: {sec:.3f} s host wall {card}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    n_pods, n_nodes = len(feats.pods.keys), len(feats.nodes.names)
    sel = res.selected
    placed = sel[sel >= 0]
    if (sel[n_pods:] != -1).any():
        raise AssertionError("a padding pod was placed")
    per_node = np.bincount(placed, minlength=feats.nodes.valid.shape[0])
    if not np.array_equal(state.pod_count - feats.nodes.pod_count, per_node):
        raise AssertionError("committed pod_count differs from the placements")
    want_req = feats.nodes.requested.astype(np.int64)
    np.add.at(want_req, placed, feats.pods.requests[sel >= 0])
    if not np.array_equal(state.requested, want_req):
        raise AssertionError("committed requests differ from the placed pods' requests")
    if (placed >= n_nodes).any():
        raise AssertionError("a pod was placed on a padding node")
    print(f"  schedule: {len(placed)} of {n_pods} pods placed; commit invariant holds")
    for pi, ann in enumerate(annotations):
        keys = set(ann)
        want_keys = set(ALL_RESULT_KEYS) if res_sched_2k.selected[pi] >= 0 else set(ALL_RESULT_KEYS[:-1])
        if keys != want_keys:
            raise AssertionError(f"pod {pi}: annotation keys {sorted(keys)}")
        json.loads(ann[ALL_RESULT_KEYS[2]])  # filter-result parses
    print(f"  rendered the {len(ALL_RESULT_KEYS)} annotations of {len(annotations)} pods")

    # Plain versions on the same inputs (timed once, below).
    prog, state0, pods0, aux = sched._prog, sched._node_state, sched._pods, sched._aux
    carries0 = prog.init_carries(aux)
    torch.cuda.synchronize()
    plain_ms = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    schedule_scan_plain(prog, state0, pods0.rows(0, 16), aux, carries0)  # warm-up
    start.record()
    _, _, plain_out = schedule_scan_plain(prog, state0, pods0, aux, carries0)
    end.record()
    torch.cuda.synchronize()
    plain_ms["schedule_scan"] = start.elapsed_time(end)
    check.equal("schedule_scan", "main-path selected", sel, plain_out["selected"].cpu().numpy())
    fprog, fcarries = fused._prog, fused._prog.init_carries(fused._aux)
    batch_eval_plain(fprog, fused._node_state, fused._pods.rows(0, 16), fused._aux, fcarries)
    start.record()
    plain_fused = batch_eval_plain(fprog, fused._node_state, fused._pods, fused._aux, fcarries)
    end.record()
    torch.cuda.synchronize()
    plain_ms["batch_eval"] = start.elapsed_time(end)
    for key, name in (("selected", "selected"), ("total", "total"), ("final", "final_scores")):
        check.equal("batch_eval", f"main-path fused {key}", getattr(res_fused, name),
                    plain_fused[key].cpu().numpy())
    del plain_fused
    plain_2k = PlainEngine(feats_2k, plugins_2k, record="full", exact=True, device=DEVICE)
    check.results("batch_eval", "main-path evaluate_batch full 2048", res_full_2k, plain_2k.evaluate_batch())
    check.results("schedule_scan", "main-path schedule full 2048", res_sched_2k, plain_2k.schedule()[0])
    print("  kernels equal the plain versions on the main path")

    phase("5 timings (CUDA events)")
    ms_a = cuda_ms(lambda: schedule_scan(prog, state0, pods0, aux, carries0), reps=3)
    ms_b = cuda_ms(lambda: batch_eval(fprog, fused._node_state, fused._pods, fused._aux, fcarries), reps=3)
    P, N = pods0.valid.shape[0], state0.valid.shape[0]
    ops = pair_ops(sched) * P * N
    inputs = tensor_bytes(state0) + tensor_bytes(pods0) + tensor_bytes(aux)
    carry_out = tensor_bytes([state0.requested, state0.nonzero_requested, state0.pod_count, carries0["NodePorts"]])
    a_bytes = inputs + P * 4 + carry_out
    S = len(fprog.scores)
    b_bytes = inputs + P * 4 + P * N * 4 + P * S * N * 2
    a_bound, a_by = bound_ms(a_bytes, ops)
    b_bound, b_by = bound_ms(b_bytes, ops)
    pairs = n_pods * n_nodes
    print(f"  schedule_scan (kernel A), {P} x {N} selection: {ms_a:.3f} ms per pass, "
          f"{pairs / (ms_a / 1e3):.4g} real pod-node pairs/s {card}")
    print(f"  schedule_scan plain: {plain_ms['schedule_scan']:.1f} ms {card}")
    print(f"  schedule_scan bound: {a_bound:.4f} ms by {a_by} ({a_bytes} bytes, {ops:.4g} ops)")
    print(f"  batch_eval (kernel B), {P} x {N} final, one launch: {ms_b:.3f} ms, "
          f"{pairs / (ms_b / 1e3):.4g} real pairs/s {card}")
    print(f"  batch_eval plain: {plain_ms['batch_eval']:.1f} ms {card}")
    print(f"  batch_eval bound: {b_bound:.4f} ms by {b_by} ({b_bytes} bytes, {ops:.4g} ops)")

    # Kernel B at evaluate_batch's per-chunk launch: 2048 pods, full record.
    cprog, cstate, cpods, caux = full_2k._prog, full_2k._node_state, full_2k._pods, full_2k._aux
    ccarries = cprog.init_carries(caux)
    ms_c = cuda_ms(lambda: batch_eval(cprog, cstate, cpods, caux, ccarries), reps=3)
    plain_c = cuda_ms(lambda: batch_eval_plain(cprog, cstate, cpods, caux, ccarries), reps=1)
    Pc, F = cpods.valid.shape[0], len(cprog.filters)
    c_out = Pc * 4 + Pc * N * 4 + Pc * S * N * (2 + 8) + Pc * F * N  # selected total final raw bits
    c_bytes = tensor_bytes(cstate) + tensor_bytes(cpods) + tensor_bytes(caux) + c_out
    c_bound, c_by = bound_ms(c_bytes, pair_ops(full_2k) * Pc * N)
    print(f"  batch_eval (kernel B), {Pc} x {N} full, one chunk: {ms_c:.3f} ms; plain "
          f"{plain_c:.1f} ms; bound {c_bound:.4f} ms by {c_by} ({c_bytes} bytes) {card}")

    kernels = [
        {
            "name": "schedule_scan",
            "route": "cuda",
            "source": "ksim_tpu_torch/csrc/schedule_scan.cu",
            "replaces": "ksim_tpu/engine/core.py:790",
            "launches": launches["schedule_scan"],
            "max_abs_err": check.max_err["schedule_scan"],
            "ms": ms_a,
            "plain_ms": plain_ms["schedule_scan"],
            "bound_ms": a_bound,
            "bound_by": a_by,
            "library_ms": None,
        },
        {
            "name": "batch_eval",
            "route": "cuda",
            "source": "ksim_tpu_torch/csrc/batch_eval.cu",
            "replaces": "ksim_tpu/engine/core.py:670",
            "launches": launches["batch_eval"],
            "max_abs_err": check.max_err["batch_eval"],
            "ms": ms_b,
            "plain_ms": plain_ms["batch_eval"],
            "bound_ms": b_bound,
            "bound_by": b_by,
            "library_ms": None,
        },
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
