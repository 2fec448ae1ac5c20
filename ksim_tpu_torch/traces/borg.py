"""Google ClusterData (Borg) instance-events parser — documented subset.

The 2019 "ClusterData v3" collection publishes per-cluster tables as
JSON Lines (one event object per line, gzipped); this parser consumes
the **instance_events** table's documented subset:

========================  ==================================================
field                     use
========================  ==================================================
``time``                  event time in MICROSECONDS since trace start
                          (int, or a numeric string — BigQuery exports
                          stringify int64)
``type``                  event type: the v3 enum number or its name
                          (``SUBMIT``/``QUEUE``/``ENABLE``/``SCHEDULE``/
                          ``EVICT``/``FAIL``/``FINISH``/``KILL``/``LOST``/
                          ``UPDATE_PENDING``/``UPDATE_RUNNING``)
``collection_id``         the owning job/alloc-set id
``instance_index``        the task's index inside its collection
``priority``              Borg priority (0..450; higher preempts lower)
``resource_request``      ``{"cpus": f, "memory": f}`` — fractions of the
                          largest cell machine, both optional
========================  ==================================================

One ``TraceRecord`` is emitted per (collection_id, instance_index)
lifetime: it opens at ``SUBMIT`` and closes at the first terminal event
(``EVICT``/``FAIL``/``FINISH``/``KILL``/``LOST``), whose distance is the
record's ``lifetime_s``; an instance still live at end-of-file yields
``lifetime_s=0`` (the compiler emits no delete).  A ``SUBMIT`` for an
already-closed identity opens a NEW record (Borg resubmits evicted
work); duplicate submits of a live identity and non-terminal lifecycle
events (``QUEUE``/``SCHEDULE``/``UPDATE_*`` — and any type outside the
enum) are ignored.

Normalization (docs/scenario.md "Trace ingestion"):

- resources denormalize against a 16-core / 64-GiB reference machine:
  ``cpu_milli = round(cpus * 16000)``, ``mem_mib = round(memory *
  65536)`` — Kubernetes-exact units by construction;
- the 0..450 priority space maps onto tiers by the published bands:
  <=99 free -> 0, 100..115 best-effort batch -> 1, 116..119 mid -> 2,
  120..359 production -> 3, >=360 monitoring -> 4; tiers >=3 are
  ``kind="service"``, the rest ``"batch"``.

Strict parsing: a line that is not valid JSON, or lacks
``time``/``type``/``collection_id``/``instance_index``, raises
``TraceParseError`` with its line number (see schema.py for why
skip-and-continue is the wrong call here).  Streaming: memory is
bounded by LIVE instances, never by file size.

Stdlib-only at import time (machine-checked).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator

from ksim_tpu_torch.traces.registry import open_trace_lines
from ksim_tpu_torch.traces.schema import TraceParseError, TraceRecord

__all__ = ["parse_borg"]

#: Reference machine the normalized [0,1] requests denormalize against.
REF_CPU_MILLI = 16_000
REF_MEM_MIB = 65_536

_SUBMIT = 0
#: v3 enum names -> numbers (the documented subset).
EVENT_TYPES = {
    "SUBMIT": 0, "QUEUE": 1, "ENABLE": 2, "SCHEDULE": 3, "EVICT": 4,
    "FAIL": 5, "FINISH": 6, "KILL": 7, "LOST": 8,
    "UPDATE_PENDING": 9, "UPDATE_RUNNING": 10,
}
_TERMINAL = frozenset({4, 5, 6, 7, 8})  # EVICT FAIL FINISH KILL LOST


def _tier(priority: int) -> int:
    if priority <= 99:
        return 0
    if priority <= 115:
        return 1
    if priority <= 119:
        return 2
    if priority <= 359:
        return 3
    return 4


def _int_field(obj: dict, key: str, lineno: int) -> int:
    try:
        return int(obj[key])
    except (KeyError, TypeError, ValueError):
        raise TraceParseError(lineno, f"missing or non-integer {key!r}") from None


class _Open:
    """One live instance: the pending half of its record."""

    __slots__ = ("arrival_s", "cpu_milli", "mem_mib", "tier", "priority", "seq")

    def __init__(self, arrival_s, cpu_milli, mem_mib, tier, priority, seq):
        self.arrival_s = arrival_s
        self.cpu_milli = cpu_milli
        self.mem_mib = mem_mib
        self.tier = tier
        self.priority = priority
        self.seq = seq  # per-identity lifetime ordinal (resubmits)


def parse_borg(
    source: "str | os.PathLike | Iterable[str]",
) -> Iterator[TraceRecord]:
    """Stream ``TraceRecord``s from a ClusterData instance_events table
    (path — gz-transparent — or an iterable of lines).  Yield order is
    NOT arrival order (records close at their terminal event);
    ``resample``/``compile`` sort."""
    live: dict[tuple[int, int], _Open] = {}
    lifetimes: dict[tuple[int, int], int] = {}  # identity -> lifetimes seen

    def _close(key: tuple[int, int], rec: _Open, end_s: float) -> TraceRecord:
        name = f"c{key[0]}-i{key[1]}"
        if rec.seq:
            name = f"{name}-r{rec.seq}"  # resubmit: a distinct workload item
        return TraceRecord(
            name=name,
            arrival_s=rec.arrival_s,
            cpu_milli=rec.cpu_milli,
            mem_mib=rec.mem_mib,
            lifetime_s=max(end_s - rec.arrival_s, 0.0),
            tier=rec.tier,
            priority=rec.priority,
            kind="service" if rec.tier >= 3 else "batch",
        )

    for lineno, line in enumerate(open_trace_lines(source), start=1):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            raise TraceParseError(lineno, "not valid JSON") from None
        if not isinstance(obj, dict):
            raise TraceParseError(lineno, "event must be a JSON object")
        raw_type = obj.get("type")
        if isinstance(raw_type, str) and not raw_type.isdigit():
            etype = EVENT_TYPES.get(raw_type)
            if etype is None and raw_type == "":
                raise TraceParseError(lineno, "missing or non-integer 'type'")
        else:
            etype = _int_field(obj, "type", lineno)
        time_us = _int_field(obj, "time", lineno)
        key = (
            _int_field(obj, "collection_id", lineno),
            _int_field(obj, "instance_index", lineno),
        )
        t_s = time_us / 1e6
        if etype == _SUBMIT:
            if key in live:
                continue  # duplicate submit of a live instance
            # Strict-with-line-number applies to these fields too: a bare
            # ValueError/AttributeError would escape the TraceError ->
            # ScenarioSpecError (HTTP 400) mapping at the spec surface.
            req = obj.get("resource_request") or {}
            if not isinstance(req, dict):
                raise TraceParseError(lineno, "resource_request must be an object")
            try:
                priority = int(obj.get("priority") or 0)
                cpus = float(req.get("cpus") or 0.0)
                memory = float(req.get("memory") or 0.0)
            except (TypeError, ValueError):
                raise TraceParseError(
                    lineno, "non-numeric priority/resource_request"
                ) from None
            live[key] = _Open(
                arrival_s=t_s,
                cpu_milli=round(cpus * REF_CPU_MILLI),
                mem_mib=round(memory * REF_MEM_MIB),
                tier=_tier(priority),
                priority=priority,
                seq=lifetimes.get(key, 0),
            )
        elif etype in _TERMINAL:
            rec = live.pop(key, None)
            if rec is None:
                continue  # terminal for an identity we never saw open
            lifetimes[key] = rec.seq + 1
            yield _close(key, rec, t_s)
        # else: lifecycle noise (QUEUE/SCHEDULE/UPDATE_* or unknown) — ignored

    # Instances still live at EOF: unknown lifetime, no delete.
    for key, rec in live.items():
        yield _close(key, rec, rec.arrival_s)
