"""The port's device-resident churn replay against ksim_tpu's, on the CPU.

- ``derive_interpod_plain`` against ``_derive_interpod`` on lowered
  windows of the churn scenario;
- ``replay_segment_plain`` (kernel D's plain version) against
  ``_segment_fn`` on one window lowered by ksim_tpu and fed to both
  through ``segment_from_arrays`` — every output and the whole final
  state — after checking that the port lowers the same window to the
  same arrays;
- the port's ``ScenarioRunner(device_replay=True)`` against ksim_tpu's,
  step by step;
- the unsupported-window fallbacks, each under its named reason;
- row 6's key layout (``derive_layout``), the kernel's view of the
  lowered node domains.

Tolerance 0 everywhere: every output is an integer or a bool.  ksim_tpu
runs with x64 on for exact mode and off for f32 mode."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest
import torch

from ksim_tpu.engine.replay import ReplayDriver as JaxReplayDriver
from ksim_tpu.engine.replay import _derive_interpod as jax_derive_interpod
from ksim_tpu.engine.replay import _pack_plan_buffers, _segment_fn
from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu.scenario import churn_scenario as jax_churn
from ksim_tpu_torch.engine.replay import FALLBACK_REASONS, ReplayDriver, segment_from_arrays
from ksim_tpu_torch.kernels import chain
from ksim_tpu_torch.kernels.replay_segment import (
    derive_interpod,
    derive_interpod_plain,
    derive_layout,
    replay_segment,
    replay_segment_plain,
)
from ksim_tpu_torch.scenario.generate import churn_scenario, make_node, make_pod
from ksim_tpu_torch.scenario.runner import Operation, ScenarioResult, ScenarioRunner

CHURN = dict(n_nodes=200, n_events=800, ops_per_step=50)
RUNNER = dict(max_pods_per_pass=1024, pod_bucket_min=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensor ops: one intra-op thread does
    them as fast as many, and keeps the suite's parallel workers from
    oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def x64(enabled: bool):
    before = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def _steps(res) -> list[tuple[int, int, int]]:
    return [(s.step, s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


def _lowered_pair(exact: bool, head_steps: int, k: int = 8):
    """Both packages advanced per-pass through the churn's first
    ``head_steps`` steps, then the next window lowered by each driver:
    (ksim_tpu plan, port plan).  Build under ``x64(exact)``."""
    jr = JaxRunner(**RUNNER)
    tr = ScenarioRunner(**RUNNER, exact=exact, device="cpu")
    jby, jkeys = jr._group_by_step(list(jax_churn(0, **CHURN)))
    tby, tkeys = tr._group_by_step(list(churn_scenario(0, **CHURN)))
    for s in jkeys[:head_steps]:
        jr._run_step(s, jby[s], ScenarioResult())
    for s in tkeys[:head_steps]:
        tr._run_step(s, tby[s], ScenarioResult())
    jplan = JaxReplayDriver(jr.store, jr.service, k=k).prepare_segment(
        [jby[s] for s in jkeys[head_steps : head_steps + k]]
    )
    tplan = ReplayDriver(tr.store, tr.service, k=k).prepare_segment(
        [tby[s] for s in tkeys[head_steps : head_steps + k]]
    )
    assert jplan is not None and tplan is not None
    return jplan, tplan


def _reference_segment(plan):
    """ksim_tpu's segment program on its own lowered plan: (final state,
    outputs) as numpy."""
    const_dev, (ev_dev, state_dev) = _pack_plan_buffers(plan, (plan.ev, plan.state0))
    final, outs = _segment_fn(plan.statics, plan.prog, const_dev, ev_dev, state_dev)
    return (
        {k: np.asarray(v) for k, v in final.items()},
        {k: np.asarray(v) for k, v in outs.items()},
    )


def _assert_equal(ref: np.ndarray, got: torch.Tensor, what: str) -> None:
    ref = np.asarray(ref)
    got = got.numpy()
    if what.endswith("pass_count"):
        # ksim_tpu's transfer packing carries the 0-d counter as [1].
        ref, got = ref.reshape(-1, *ref.shape[2:]), got.reshape(-1)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_port_lowers_the_window_as_the_reference_does(exact):
    with x64(exact):
        jplan, tplan = _lowered_pair(exact, head_steps=3)
    js, ts = jplan.statics, tplan.statics
    assert (ts.k, ts.q, ts.cap, ts.n_tk, ts.n_dom) == (js.k, js.q, js.cap, js.n_tk, js.n_dom)
    assert tplan.universe_keys == jplan.universe_keys
    assert tplan.node_names == jplan.node_names
    for tree in ("ev", "state0"):
        ref, got = getattr(jplan, tree), getattr(tplan, tree)
        for key in got:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=f"{tree}.{key}")
    for part in ("node", "pods"):
        for key, arr in tplan.const[part].items():
            np.testing.assert_array_equal(arr, jplan.const[part][key], err_msg=f"const.{part}.{key}")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_replay_segment_plain_equals_segment_body(exact):
    with x64(exact):
        jplan, tplan = _lowered_pair(exact, head_steps=3)
        ref_state, ref_outs = _reference_segment(jplan)
    const, ev, state0 = segment_from_arrays(dict(jplan.const, aux=jplan.aux), jplan.ev, jplan.state0)
    before = replay_segment.launches
    final, outs = replay_segment(tplan.statics, tplan.prog, const, ev, state0)
    assert replay_segment.launches == before  # CPU tensors: the plain version
    assert set(outs) == {k for k in ref_outs}
    for key in outs:
        _assert_equal(ref_outs[key], outs[key], f"outs.{key}")
    assert set(final) == set(ref_state)
    for key in final:
        _assert_equal(ref_state[key], final[key], f"state.{key}")
    # The window did real work.
    assert int(outs["scheduled"].sum()) > 0 and int(outs["unschedulable"].sum()) > 0


@pytest.mark.parametrize("head_steps", [2, 6, 11])
def test_derive_interpod_plain_equals_reference(head_steps):
    with x64(True):
        jplan, _ = _lowered_pair(True, head_steps=head_steps)
        ipa = {k: getattr(jplan.aux["interpod"], k) for k in ("node_dom", "term_tk", "dom_t")}
        loc = {k: jplan.state0["ip_" + k] for k in ("cnt", "eat", "vw")}
        ref = jax_derive_interpod(loc, ipa, jplan.statics)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    got = derive_interpod_plain(
        {k: torch.from_numpy(np.array(v)) for k, v in loc.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in ipa.items()},
        jplan.statics.n_tk,
        jplan.statics.n_dom,
    )
    assert set(got) == set(ref)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    assert int(ref["total"].sum()) > 0  # bound pods carry inter-pod terms
    # The wrapper takes the plain version for CPU tensors.
    before = derive_interpod.launches
    again = derive_interpod(
        {k: torch.from_numpy(np.array(v)) for k, v in loc.items()},
        {k: torch.from_numpy(np.array(v)) for k, v in ipa.items()},
        jplan.statics.n_tk,
        jplan.statics.n_dom,
    )
    assert derive_interpod.launches == before
    assert all(torch.equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("head_steps", [2, 11])
def test_derive_layout_indexes_the_lowered_domains(head_steps):
    with x64(True):
        jplan, _ = _lowered_pair(True, head_steps=head_steps)
        zone = np.array(jplan.aux["interpod"].node_dom)
    # The churn's one inter-pod key is the zone; a hostname-like key (one
    # node per domain, the live nodes only) is added beside it.
    host = np.where(zone[:, 0] >= 0, np.arange(zone.shape[0]), -1).astype(np.int32)
    node_dom = np.column_stack([zone, host])
    layout = derive_layout(torch.from_numpy(node_dom))
    ldom = layout.ldom.numpy()
    assert ldom.shape == node_dom.shape and len(layout.singleton) == node_dom.shape[1]
    for k, single in enumerate(layout.singleton):
        keyed = node_dom[:, k] >= 0
        ids = node_dom[keyed, k]
        assert single == (len(np.unique(ids)) == len(ids))
        if single:
            assert (ldom[:, k] == -1).all()
            continue
        assert (ldom[~keyed, k] == -1).all()
        local = ldom[keyed, k]
        assert 0 <= local.min() and local.max() < layout.dk
        # Two nodes share a compact index exactly when they share a domain.
        assert (np.equal.outer(local, local) == np.equal.outer(ids, ids)).all()
    assert layout.singleton == (False, True)


def test_device_replay_runner_equals_reference_per_step():
    with x64(False):
        jrun = JaxRunner(**RUNNER, device_replay=True, device_segment_steps=8)
        ref = jrun.run(list(jax_churn(0, **CHURN)))
    trun = ScenarioRunner(**RUNNER, device_replay=True, device_segment_steps=8, exact=False, device="cpu")
    got = trun.run(list(churn_scenario(0, **CHURN)))
    assert _steps(got) == _steps(ref)
    assert (got.events_applied, got.pods_scheduled, got.unschedulable_attempts) == (
        ref.events_applied, ref.pods_scheduled, ref.unschedulable_attempts,
    )
    drv = trun.replay_driver
    assert drv.device_steps >= 8
    assert drv.device_steps + drv.fallback_steps == len(got.steps)
    assert drv.device_steps == jrun.replay_driver.device_steps
    assert set(drv.unsupported) <= FALLBACK_REASONS


def _patch_stream() -> list[Operation]:
    ops = list(churn_scenario(0, n_nodes=40, n_events=400, ops_per_step=40))
    # A node label patch mid-stream: outside the replay's op vocabulary.
    ops.append(Operation(step=0, op="create", kind="nodes", obj=make_node("extra", cpu="8")))
    ops.append(Operation(step=4, op="patch", kind="nodes", name="extra",
                         obj={"metadata": {"labels": {"disktype": "nvme"}}}))
    return sorted(ops, key=lambda op: op.step)


def _priority_stream() -> list[Operation]:
    """Low-priority pods fill the nodes, then high-priority ones arrive:
    DefaultPreemption's victim search runs."""
    ops = [Operation(step=0, op="create", kind="nodes", obj=make_node(f"n{i}", cpu="2", memory="4Gi"))
           for i in range(4)]
    ops += [Operation(step=1, op="create", kind="pods", obj=make_pod(f"low-{i}", cpu="1", priority=1))
            for i in range(8)]
    ops += [Operation(step=2, op="create", kind="pods", obj=make_pod(f"high-{i}", cpu="1", priority=100))
            for i in range(3)]
    ops += [Operation(step=3, op="delete", kind="pods", name="low-0", namespace="default")]
    ops += [Operation(step=4, op="create", kind="pods", obj=make_pod("late", cpu="500m", priority=50))]
    return ops


@pytest.mark.parametrize(
    "case, reason",
    [("patch", "op:patch/nodes"), ("record_full", "record_full"), ("preemption", "preemption")],
)
def test_unsupported_windows_fall_back_with_their_reason(case, reason):
    kw = dict(RUNNER, exact=True, device="cpu")
    if case == "patch":
        ops = _patch_stream()
    elif case == "record_full":
        ops = list(churn_scenario(1, n_nodes=30, n_events=150, ops_per_step=30))
        kw["record"] = "full"
    else:
        ops = _priority_stream()
        kw["preemption"] = True
    per_pass = ScenarioRunner(**kw).run(list(ops))
    runner = ScenarioRunner(**kw, device_replay=True, device_segment_steps=4)
    got = runner.run(list(ops))
    assert _steps(got) == _steps(per_pass)
    assert got.events_applied == per_pass.events_applied
    drv = runner.replay_driver
    assert drv.unsupported.get(reason, 0) >= 1, drv.unsupported
    assert drv.device_steps + drv.fallback_steps == len(got.steps)
    if case == "patch":
        assert drv.device_steps > 0  # only the patched step's window fell back
    if case == "preemption":
        assert runner.store.list("pods")  # the victims were evicted, the rest stayed
        assert got.pods_scheduled > 0


def test_node_axis_over_the_shared_memory_bound_raises_before_launch():
    """A padded node axis past the shared-memory layout's bound is refused
    with a ValueError naming the bound and the node count (no launch)."""
    prm = chain.ChainParams()
    prm.N, prm.I, prm.MC, prm.DMAX, prm.sp_smem = 16384, 8, 2, 3, 1
    chain.check_smem(prm)  # 16384 padded nodes fit
    assert chain.smem_bytes(prm) == 13 * 16384 + 8 * 8 + 3688 + 4 * 4 * 2 * 3
    prm.N = 32768
    fixed = 8 * 8 + 3688 + 4 * 4 * 2 * 3  # image weights, reductions, spread domains
    bound = (chain.MAX_SMEM_BYTES - fixed) // 13
    assert 17500 < bound < 17600
    with pytest.raises(ValueError, match=rf"N=32768.*232448.*at most {bound} padded nodes"):
        chain.check_smem(prm)
    prm.N = 16384
    with pytest.raises(ValueError, match="N=16384"):
        chain.check_smem(prm, extra=32768)  # kernel D's domain scratch on top
