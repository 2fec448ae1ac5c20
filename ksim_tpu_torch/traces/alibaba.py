"""Alibaba cluster-trace parser (v2018 tables) — documented subset.

The Alibaba cluster-trace-v2018 publishes headerless CSV tables; this
parser consumes the two workload tables, auto-detected by column count
(the files are homogeneous, so the first data row decides):

**batch_task** (9 columns) — one record per task row:

    task_name, instance_num, job_name, task_type, status,
    start_time, end_time, plan_cpu, plan_mem

- ``name`` = ``<job_name>-<task_name>``, ``arrival_s`` = ``start_time``
  (seconds), ``lifetime_s`` = ``end_time - start_time`` when the end is
  known and later, else 0;
- ``plan_cpu`` is in centi-cores (100 = 1 core): ``cpu_milli =
  round(plan_cpu * 10)``; ``plan_mem`` is a percentage of machine
  memory, denormalized against the same 64-GiB reference machine the
  Borg parser uses: ``mem_mib = round(plan_mem / 100 * 65536)``;
- tier 1 (best-effort batch), ``kind="batch"``; ``task_type`` is kept
  as the native ``priority`` when numeric.

**container_meta** (8 columns) — one record per container (the FIRST
row of each ``container_id``; later rows are lifecycle updates):

    container_id, machine_id, time_stamp, app_du, status,
    cpu_request, cpu_limit, mem_size

- ``name`` = ``container_id``, ``arrival_s`` = ``time_stamp``;
  containers are long-running: ``lifetime_s = 0`` (no delete);
- ``cpu_request`` is in centi-cores, ``mem_size`` a percentage of
  machine memory (denormalized as above);
- tier 3 (production), ``kind="service"``.

Strict parsing: a row with the wrong column count or a non-numeric
required field raises ``TraceParseError`` with its line number; empty
``plan_cpu``/``plan_mem``/``cpu_request``/``mem_size`` cells parse as 0
(the traces genuinely carry blanks there).  Streaming: batch rows yield
as read; container dedup keeps one id-set in memory.

Stdlib-only at import time (machine-checked).
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, Iterator

from ksim_tpu_torch.traces.registry import open_trace_lines
from ksim_tpu_torch.traces.schema import TraceParseError, TraceRecord

__all__ = ["parse_alibaba"]

#: Reference machine memory (MiB) the normalized percentages map onto.
REF_MEM_MIB = 65_536

_BATCH_COLS = 9
_CONTAINER_COLS = 8


def _num(row: list[str], idx: int, lineno: int, *, required: bool) -> float:
    cell = row[idx].strip() if idx < len(row) else ""
    if not cell:
        if required:
            raise TraceParseError(lineno, f"empty required column {idx}")
        return 0.0
    try:
        return float(cell)
    except ValueError:
        raise TraceParseError(
            lineno, f"non-numeric value {cell!r} in column {idx}"
        ) from None


def parse_alibaba(
    source: "str | os.PathLike | Iterable[str]",
) -> Iterator[TraceRecord]:
    """Stream ``TraceRecord``s from an Alibaba v2018 workload table
    (path — gz-transparent — or an iterable of CSV lines); the table
    kind is detected from the first data row's column count."""
    reader = csv.reader(open_trace_lines(source))
    ncols: "int | None" = None
    seen_containers: set[str] = set()
    for lineno, row in enumerate(reader, start=1):
        if not row or (len(row) == 1 and not row[0].strip()):
            continue
        if ncols is None:
            if len(row) not in (_BATCH_COLS, _CONTAINER_COLS):
                raise TraceParseError(
                    lineno,
                    f"unrecognized table shape ({len(row)} columns; "
                    f"batch_task has {_BATCH_COLS}, container_meta "
                    f"{_CONTAINER_COLS})",
                )
            ncols = len(row)
        if len(row) != ncols:
            raise TraceParseError(
                lineno, f"expected {ncols} columns, found {len(row)}"
            )
        if ncols == _BATCH_COLS:
            task_name, _inst, job_name, task_type = (
                row[0].strip(), row[1], row[2].strip(), row[3].strip(),
            )
            if not task_name or not job_name:
                raise TraceParseError(lineno, "empty task_name/job_name")
            start = _num(row, 5, lineno, required=True)
            end = _num(row, 6, lineno, required=False)
            yield TraceRecord(
                name=f"{job_name}-{task_name}",
                arrival_s=start,
                cpu_milli=round(_num(row, 7, lineno, required=False) * 10),
                mem_mib=round(_num(row, 8, lineno, required=False) / 100 * REF_MEM_MIB),
                lifetime_s=max(end - start, 0.0) if end else 0.0,
                tier=1,
                priority=int(task_type) if task_type.isdigit() else 0,
                kind="batch",
            )
        else:
            cid = row[0].strip()
            if not cid:
                raise TraceParseError(lineno, "empty container_id")
            if cid in seen_containers:
                continue  # lifecycle update rows for a known container
            seen_containers.add(cid)
            yield TraceRecord(
                name=cid,
                arrival_s=_num(row, 2, lineno, required=True),
                cpu_milli=round(_num(row, 5, lineno, required=False) * 10),
                mem_mib=round(_num(row, 7, lineno, required=False) / 100 * REF_MEM_MIB),
                lifetime_s=0.0,
                tier=3,
                priority=0,
                kind="service",
            )
