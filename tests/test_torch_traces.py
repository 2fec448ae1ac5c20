"""The port's trace plane (ksim_tpu_torch/traces/) against ksim_tpu's.

The same trace through both packages gives the same ``Operation``
sequence, field by field (step, op, kind, object, name, namespace):
materialized (``trace_operations``) and windowed through the producer
thread (``stream_trace_operations``), on the two bundled fixtures and on
a seeded synthetic Borg trace of a few thousand records.  The producer's
fault fallback, the early bound refusals and the stream object's
contract mirror tests/test_traces_stream.py on the port.  Every
comparison is exact.
"""

from __future__ import annotations

import json
import random

import pytest

from ksim_tpu.traces import stream_trace_operations as jax_stream
from ksim_tpu.traces import trace_operations as jax_trace
from ksim_tpu_torch.traces import (
    TraceBoundExceeded,
    TraceOperationStream,
    stream_trace_operations,
    trace_operations,
)

FIXTURES = "tests/fixtures/traces"


def _fields(ops) -> list[tuple]:
    return [(op.step, op.op, op.kind, op.obj, op.name, op.namespace) for op in ops]


def synthetic_borg_lines(records: int, seed: int) -> list[str]:
    """A synthetic Borg trace: SUBMIT/FINISH pairs, short lifetimes so
    deletes interleave with arrivals (bench.py ``child_churn_stream``'s
    generator)."""
    rng = random.Random(seed)
    lines, t_us = [], 0
    for i in range(records):
        t_us += rng.randrange(1_000, 50_000)
        life_us = rng.randrange(500_000, 60_000_000)
        req = {"cpus": rng.choice((0.01, 0.025, 0.05, 0.1)), "memory": rng.choice((0.005, 0.01, 0.02, 0.05))}
        lines.append(json.dumps({
            "time": t_us, "type": "SUBMIT", "collection_id": i, "instance_index": 0,
            "priority": rng.choice((0, 103, 117, 200, 360)), "resource_request": req,
        }))
        lines.append(json.dumps({"time": t_us + life_us, "type": "FINISH", "collection_id": i, "instance_index": 0}))
    return lines


SOURCES = {
    "borg_mini": (f"{FIXTURES}/borg_mini.jsonl", "borg", dict(nodes=24, ops_per_step=2)),
    "alibaba_mini": (f"{FIXTURES}/alibaba_batch_mini.csv", "alibaba", dict(nodes=6, ops_per_step=3, max_events=30)),
    "synthetic_borg": (
        synthetic_borg_lines(3000, seed=0), "borg", dict(nodes=200, ops_per_step=100, max_events=4000, seed=0),
    ),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_materialized_operations_equal_ksim_tpu(source):
    path, fmt, kw = SOURCES[source]
    got = _fields(trace_operations(path, fmt, **kw))
    assert got and got == _fields(jax_trace(path, fmt, **kw))


@pytest.mark.parametrize("window", [1, 64])
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_streamed_operations_equal_ksim_tpu(source, window):
    path, fmt, kw = SOURCES[source]
    stream = stream_trace_operations(path, fmt, window=window, queue_windows=2, **kw)
    ref = jax_stream(path, fmt, window=window, queue_windows=2, **kw)
    got, want = _fields(stream), _fields(ref)
    assert got and got == want
    assert got == _fields(trace_operations(path, fmt, **kw))
    stats, ref_stats = stream.stats(), ref.stats()
    assert stats["fallback"] == 0 and stats["ops"] == len(got)
    assert stats["windows"] == ref_stats["windows"] == -(-len(got) // window)


def test_producer_fault_degrades_to_materialized_path():
    """An armed ``traces.stream`` fault fails the streaming ingest; the
    producer falls back to the materialized path, counts it (stats and
    the ``traces.ingest_fallback`` event), and the sequence is unchanged."""
    from ksim_tpu_torch.faults import FAULTS
    from ksim_tpu_torch.obs import TRACE

    path, fmt, kw = f"{FIXTURES}/borg_mini.jsonl", "borg", dict(nodes=6, ops_per_step=3, seed=0)
    mat = _fields(trace_operations(path, fmt, **kw))
    active, ring = TRACE._active, TRACE._ring_on
    FAULTS.reset()
    TRACE.reset()
    TRACE.enable(ring=True)
    try:
        FAULTS.arm("traces.stream", "always")
        stream = stream_trace_operations(path, fmt, window=4, queue_windows=2, **kw)
        assert _fields(stream) == mat
        assert stream.stats()["fallback"] == 1
        assert "traces.ingest_fallback" in [r["name"] for r in TRACE.ring_records()]
    finally:
        FAULTS.reset()
        TRACE.reset()
        TRACE._active, TRACE._ring_on = active, ring


def test_event_bound_refusal_stops_reading_the_source():
    """The event bound trips mid-read: the refusal comes before the
    producer has read half the source."""
    lines = synthetic_borg_lines(200, seed=1)
    consumed = []

    def counting():
        for line in lines:
            consumed.append(1)
            yield line

    stream = TraceOperationStream(counting(), "borg", nodes=4, ops_per_step=2, event_bound=20)
    with pytest.raises(TraceBoundExceeded, match="at least"):
        list(stream)
    assert 0 < len(consumed) < len(lines) // 2


def test_node_and_event_bounds_refuse_before_reading():
    consumed = []

    def counting():
        for line in synthetic_borg_lines(5, seed=1):
            consumed.append(1)
            yield line

    with pytest.raises(TraceBoundExceeded, match="events"):
        TraceOperationStream(counting(), "borg", nodes=30, ops_per_step=2, event_bound=20)
    assert consumed == []
    with pytest.raises(TraceBoundExceeded, match="nodes"):
        TraceOperationStream(synthetic_borg_lines(5, seed=1), "borg", nodes=8, ops_per_step=2, node_bound=4)


def test_stream_close_is_idempotent_and_early():
    stream = stream_trace_operations(f"{FIXTURES}/borg_mini.jsonl", "borg", nodes=6, ops_per_step=3,
                                     window=1, queue_windows=1)
    first = next(iter(stream))
    assert first.kind == "nodes"
    stream.close()
    stream.close()
