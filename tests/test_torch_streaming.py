"""Trace replay on the port, streamed and materialized (CPU, plain kernel D).

The borg_mini lock — tests/fixtures/traces/borg_mini.jsonl compiled onto
24 nodes, 2 operations per step: 126 events, 56 scheduled, 19
unschedulable — holds through the port's per-pass path and its device
path, fed the materialized operation list and the windowed producer
stream (ScenarioRunner's streaming loop, its ingest drained while each
dispatch is in flight), with every step on the device and the per-step
triples equal to ksim_tpu's on the same stream.  The streaming loop
evicts the batches it has committed.  Every comparison is exact.
"""

from __future__ import annotations

import contextlib

import jax
import pytest
import torch

from ksim_tpu.scenario import ScenarioRunner as JaxRunner
from ksim_tpu.traces import trace_operations as jax_trace
from ksim_tpu_torch.scenario.runner import ScenarioRunner, _StreamFeeder
from ksim_tpu_torch.traces import stream_trace_operations, trace_operations

BORG_MINI = "tests/fixtures/traces/borg_mini.jsonl"
TRACE_LOCK = (126, 56, 19)
KW = dict(nodes=24, ops_per_step=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _steps(res) -> list[tuple]:
    return [(s.step, s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


@pytest.fixture(scope="module")
def reference_steps() -> list[tuple]:
    """ksim_tpu's per-pass run of the same stream, in f32 (the lock's mode)."""
    with x64(False):
        res = JaxRunner(pod_bucket_min=64).run(list(jax_trace(BORG_MINI, "borg", **KW)))
    assert (res.events_applied, res.pods_scheduled, res.unschedulable_attempts) == TRACE_LOCK
    return _steps(res)


@pytest.mark.parametrize("streamed", [False, True], ids=["materialized", "streamed"])
@pytest.mark.parametrize("device_replay", [False, True], ids=["per_pass", "device"])
def test_borg_mini_lock_on_the_port(device_replay, streamed, reference_steps):
    ops = (stream_trace_operations(BORG_MINI, "borg", window=8, queue_windows=2, **KW) if streamed
           else list(trace_operations(BORG_MINI, "borg", **KW)))
    runner = ScenarioRunner(pod_bucket_min=64, device_replay=device_replay, exact=False, device="cpu")
    res = runner.run(ops)
    assert (res.events_applied, res.pods_scheduled, res.unschedulable_attempts) == TRACE_LOCK
    assert _steps(res) == reference_steps
    if device_replay:
        drv = runner.replay_driver
        assert drv.fallback_steps == 0, drv.unsupported
        assert drv.device_steps == len(res.steps)
        assert drv.prelower_consumed > 0
        if streamed:
            assert drv.ingest_prefetches > 0
        else:
            assert drv.ingest_prefetches == 0


def test_streaming_releases_committed_batches():
    """The feeder groups the stream into the materialized run's step
    batches, keeps each batch's identity while it is resident, and
    evicts what the cursor has passed."""
    ops = list(trace_operations(BORG_MINI, "borg", **KW))
    stream = stream_trace_operations(BORG_MINI, "borg", window=8, queue_windows=2, **KW)
    feeder = _StreamFeeder(stream)
    try:
        feeder.ensure(5)
        assert len(feeder.keys) >= 5
        first = feeder.by_step[feeder.keys[0]]
        feeder.prefetch(10)
        assert feeder.by_step[feeder.keys[0]] is first
        feeder.release(3)
        assert all(k not in feeder.by_step for k in feeder.keys[:3])
        feeder.ensure(10 ** 6)
        want = {}
        for op in ops:
            want.setdefault(op.step, []).append(op)
        assert feeder.keys == sorted(want)
        for k in feeder.keys[3:]:
            assert feeder.by_step[k] == want[k]
    finally:
        stream.close()


def test_materialized_feeder_groups_like_ksim_tpu():
    """A materialized run takes the same windowed loop as a stream: its
    feeder arrives grouped as ksim_tpu's ``_group_by_step`` groups the
    same operations, already at EOF (nothing to pull), and evicts what
    the cursor has passed."""
    ops = list(trace_operations(BORG_MINI, "borg", **KW))
    want_by_step, want_keys = JaxRunner._group_by_step(list(jax_trace(BORG_MINI, "borg", **KW)))
    feeder = _StreamFeeder.materialized(ops)
    assert feeder.keys == want_keys
    assert {k: [(o.step, o.op, o.kind, o.obj, o.name, o.namespace) for o in v] for k, v in feeder.by_step.items()} == {
        k: [(o.step, o.op, o.kind, o.obj, o.name, o.namespace) for o in v] for k, v in want_by_step.items()
    }
    first = feeder.by_step[feeder.keys[0]]
    feeder.ensure(10 ** 6)
    assert feeder.prefetch(10 ** 6) == 0
    assert feeder.by_step[feeder.keys[0]] is first
    feeder.release(2)
    assert all(k not in feeder.by_step for k in feeder.keys[:2])
    assert len(feeder.by_step) == len(want_keys) - 2


def test_fleet_refuses_a_streaming_source():
    stream = stream_trace_operations(BORG_MINI, "borg", **KW)
    try:
        with pytest.raises(ValueError, match="solo-run path"):
            ScenarioRunner(device_replay=True, fleet=2, device="cpu").run(stream)
        with pytest.raises(ValueError, match="materialized"):
            ScenarioRunner(device_replay=True, fleet=2, device="cpu").run([], lane_ops={0: stream})
    finally:
        stream.close()
