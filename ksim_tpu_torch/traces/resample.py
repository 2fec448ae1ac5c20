"""Seed-deterministic trace resampling: node-count rescale + event budget.

Public traces cover thousands of machines and tens of millions of
events; the simulator wants a stream sized to a TARGET node universe
and an event budget, with the empirical arrival / priority / size
distributions intact.  Two independent, composable reductions:

- **Node-count rescale** — with both ``target_nodes`` and
  ``source_nodes`` given (the trace's machine count, per its own
  documentation), every record survives independently with probability
  ``target_nodes / source_nodes``, so the per-node arrival intensity of
  the source cluster carries over to the smaller universe.
- **Event budget** — with ``max_events`` given, a uniform
  pseudo-random subset of records is kept whose compiled pod-event
  estimate (one create, plus one delete when a lifetime is known) fits
  the budget.

Both decisions are **order-independent**: each record's fate is a pure
function of ``(seed, record)``, via a keyed ``blake2b`` rank (8-byte
digest, domain-separated through the ``person`` parameter, independent
of ``PYTHONHASHSEED``).  The rescale coin is
``rank / 2**64 < target/source`` per record; the budget keeps the
greedy prefix of the records in ascending rank order, stopping at the
first record whose event cost no longer fits.  Because nothing depends
on input order or on a shared RNG stream, a single-pass streaming
selector (`StreamSelector`) can reproduce the exact same subset while
holding only ``O(max_events)`` records — the byte-identity contract
`traces/stream.py` and its golden tests depend on.  Uniform selection
is the whole preservation argument: every marginal distribution of the
records (arrival, priority tier, request size, lifetime) survives
uniform thinning in expectation; nothing here stratifies, truncates
tails, or reweights.

The output is sorted by the full-record `_order_key` — parsers are
allowed to yield out of arrival order (Borg records close at their
terminal event), and ``compile`` requires the sorted view.  The key
includes every field so even duplicate ``(arrival_s, name)`` pairs
(Alibaba task names collide) order deterministically regardless of
input order.

Stdlib-only at import time (machine-checked).
"""

from __future__ import annotations

import hashlib
import heapq
from typing import Iterable

from ksim_tpu_torch.traces.schema import TraceBoundExceeded, TraceError, TraceRecord

__all__ = ["estimated_events", "resample", "StreamSelector"]

#: blake2b domain-separation tags (``person`` is capped at 16 bytes).
_DOMAIN_RESCALE = b"ksim-rescale"
_DOMAIN_BUDGET = b"ksim-budget"


def estimated_events(rec: TraceRecord) -> int:
    """Pod events this record compiles to: its create, plus its delete
    when the trace knows a lifetime."""
    return 2 if rec.lifetime_s > 0 else 1


def _order_key(rec: TraceRecord):
    """Total order over records — every field participates so the sort
    is input-order-independent even under duplicate (arrival, name)."""
    return (
        rec.arrival_s,
        rec.name,
        rec.lifetime_s,
        rec.cpu_milli,
        rec.mem_mib,
        rec.tier,
        rec.priority,
        rec.kind,
    )


def _rank(seed: int, domain: bytes, rec: TraceRecord) -> int:
    """64-bit uniform rank of a record under ``seed`` — a pure function
    of (seed, domain, record), so selection never depends on input
    order, process hash seed, or a shared RNG stream."""
    payload = (
        f"{seed}|{rec.name}|{rec.arrival_s!r}|{rec.lifetime_s!r}|"
        f"{rec.cpu_milli}|{rec.mem_mib}|{rec.tier}|{rec.priority}|{rec.kind}"
    ).encode()
    digest = hashlib.blake2b(payload, digest_size=8, person=domain).digest()
    return int.from_bytes(digest, "big")


def _survives_rescale(seed: int, rec: TraceRecord, frac: float) -> bool:
    return _rank(seed, _DOMAIN_RESCALE, rec) < frac * 2.0**64


def _budget_prefix(
    records: Iterable[TraceRecord], seed: int, budget: int
) -> list[TraceRecord]:
    """The greedy rank-order prefix that fits ``budget`` events: walk
    records in ascending (rank, order-key) order, stop at the FIRST one
    whose cost no longer fits.  Shared verbatim by the batch and
    streaming paths — it IS the byte-identity contract."""
    ranked = sorted(records, key=lambda r: (_rank(seed, _DOMAIN_BUDGET, r), _order_key(r)))
    kept: list[TraceRecord] = []
    for rec in ranked:
        cost = estimated_events(rec)
        if cost > budget:
            break
        kept.append(rec)
        budget -= cost
    return kept


def resample(
    records: Iterable[TraceRecord],
    *,
    seed: int = 0,
    max_events: int = 0,
    target_nodes: "int | None" = None,
    source_nodes: "int | None" = None,
) -> list[TraceRecord]:
    """Sorted, deterministically thinned records (see module docstring).
    ``max_events=0`` means no budget; the rescale step needs BOTH node
    counts (a target without a source is a compile-time universe size,
    not a thinning instruction)."""
    out = sorted(records, key=_order_key)
    if target_nodes is not None and source_nodes is not None:
        if source_nodes <= 0 or target_nodes <= 0:
            raise TraceError("node counts for rescaling must be positive")
        frac = target_nodes / source_nodes
        if frac < 1.0:
            out = [r for r in out if _survives_rescale(seed, r, frac)]
    if max_events:
        total = sum(estimated_events(r) for r in out)
        if total > max_events:
            out = _budget_prefix(out, seed, max_events)
            out.sort(key=_order_key)
    return out


class _HeapItem:
    """Max-heap adapter: ``heapq`` is a min-heap and the (rank, key)
    tuples contain strings, so ordering is reversed here instead of
    negated."""

    __slots__ = ("key", "rec")

    def __init__(self, key, rec: TraceRecord) -> None:
        self.key = key
        self.rec = rec

    def __lt__(self, other: "_HeapItem") -> bool:
        return other.key < self.key  # reversed: heap[0] is the LARGEST key


class StreamSelector:
    """Single-pass, bounded-memory implementation of :func:`resample`.

    Feed records in ANY order; :meth:`finish` returns byte-identically
    what ``resample(all_records, ...)`` would.  Memory is bounded by the
    event budget, not the stream: with ``max_events=B`` every kept
    record costs >= 1 event, so the greedy rank-order prefix holds at
    most ``B`` records and its stop decision only ever examines the
    first ``B + 1`` records in rank order — a capped max-heap of the
    ``B + 1`` smallest-keyed records is therefore *exact*, not
    approximate.  (When the post-rescale total fits the budget, fewer
    than ``B + 1`` records exist, so none were evicted and all are
    kept, again matching the batch path.)  Without a budget, selection
    keeps everything and memory is O(stream) by definition — callers
    wanting O(window) ingest set a budget.

    ``event_bound``/``base_events`` arm *early refusal* (the
    `KSIM_JOBS_MAX_EVENTS` satellite): ``base_events`` is the fixed
    event cost the compiler adds on top of selection (the node
    bootstrap), and the selector raises
    :class:`~ksim_tpu_torch.traces.schema.TraceBoundExceeded` as soon as the
    final selected cost is *provably* above the bound, so oversized
    streams stop mid-read instead of after full parse+compile.  The
    proof obligation: with budget ``B``, the final selected cost ``S``
    is ``total`` when ``total <= B`` and otherwise lands in
    ``[B - 1, B]`` (costs are 1 or 2 and the prefix stops at the first
    overflow), so ``min(running_total, B - 1)`` — ``running_total``
    itself when unbudgeted — is a monotone lower bound on ``S``; the
    precise final gate stays with the caller.
    """

    def __init__(
        self,
        *,
        seed: int = 0,
        max_events: int = 0,
        target_nodes: "int | None" = None,
        source_nodes: "int | None" = None,
        event_bound: int = 0,
        base_events: int = 0,
    ) -> None:
        self._seed = seed
        self._budget = max_events
        self._frac = 1.0
        if target_nodes is not None and source_nodes is not None:
            if source_nodes <= 0 or target_nodes <= 0:
                raise TraceError("node counts for rescaling must be positive")
            self._frac = target_nodes / source_nodes
        self._event_bound = event_bound
        self._base_events = base_events
        self._total = 0  # post-rescale estimated events fed so far
        self._fed = 0  # post-rescale record count fed so far
        self._heap: list[_HeapItem] = []  # budgeted mode: B+1 smallest keys
        self._kept: list[TraceRecord] = []  # unbudgeted mode: everything
        if event_bound and base_events + 1 > event_bound:
            # The compiled stream always holds the bootstrap plus at
            # least one pod event — refusable before reading any bytes.
            raise TraceBoundExceeded("events", event_bound, base_events + 1)

    @property
    def selected_lower_bound(self) -> int:
        """Monotone lower bound on the final selected event cost (see
        class docstring for why it is exact enough to refuse early)."""
        if not self._budget:
            return self._total
        return min(self._total, self._budget - 1)

    def feed(self, rec: TraceRecord) -> None:
        """Account one record; raises ``TraceBoundExceeded`` the moment
        the event bound is provably blown."""
        if self._frac < 1.0 and not _survives_rescale(self._seed, rec, self._frac):
            return
        self._total += estimated_events(rec)
        self._fed += 1
        if self._budget:
            key = (_rank(self._seed, _DOMAIN_BUDGET, rec), _order_key(rec))
            cap = self._budget + 1
            if len(self._heap) < cap:
                heapq.heappush(self._heap, _HeapItem(key, rec))
            elif key < self._heap[0].key:
                heapq.heapreplace(self._heap, _HeapItem(key, rec))
        else:
            self._kept.append(rec)
        if self._event_bound:
            floor = self._base_events + self.selected_lower_bound
            if floor > self._event_bound:
                raise TraceBoundExceeded("events", self._event_bound, floor)

    def feed_all(self, records: Iterable[TraceRecord]) -> None:
        for rec in records:
            self.feed(rec)

    def finish(self) -> list[TraceRecord]:
        """The selected records in `_order_key` order — byte-identical
        to the batch :func:`resample` over the same fed records."""
        if not self._budget:
            out = list(self._kept)
        elif self._total <= self._budget:
            # Nothing was ever evicted (record count <= total <= B < cap).
            out = [item.rec for item in self._heap]
        else:
            out = _budget_prefix(
                (item.rec for item in self._heap), self._seed, self._budget
            )
        out.sort(key=_order_key)
        return out
