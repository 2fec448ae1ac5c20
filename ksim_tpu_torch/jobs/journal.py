"""Crash-safe job journal: an append-only JSONL write-ahead log.

The port of ``ksim_tpu/jobs/journal.py``: the same code and record
format, so either package reads the other's journal.

Without a journal the job registry is in-memory only: a server crash or
restart forgets submitted specs, in-flight progress and finished
results.  This module makes the job plane durable
the way the reference's long-lived service is implicitly durable (it
holds no tenant jobs at all): every submission (the full KEP-140-ish
spec document), every state transition, every cancellation and every
result document is one checksummed JSONL record appended (and flushed)
to ``$KSIM_JOBS_DIR/jobs.journal.jsonl`` BEFORE the in-memory state
machine observes the transition.  On startup ``JobManager`` replays the
journal to reconstruct the registry (jobs/manager.py
``_recover``).

Record format — one line per record::

    {"crc": <crc32 of the canonical rec JSON>, "rec": {...}}

``rec`` is canonicalized (sorted keys, no whitespace) before the CRC so
the checksum is stable under re-serialization.  ``rec["t"]`` is the
record type:

- ``submit``: id, ordinal, priority, created, and ``doc`` — the raw
  submitted job document, verbatim;
- ``state``: id, state, optional error, ts;
- ``result``: id, and the full result document (served byte-identically
  after a restart);
- ``cancel``: id, ts (the cancel REQUEST; the resulting terminal state
  arrives as its own ``state`` record);
- ``checkpoint``: id, seq, cursor (committed step-key index), segment,
  and the exact-state restore payload — ``store``
  (``ClusterStore.checkpoint()``: objects verbatim + rv counter +
  mutation epoch) plus ``service`` (backoff / pass counter /
  featurizer slot order / pnts carries) and the partial ``result``
  accounting (docs/jobs.md "Incremental resume").  Appended by the job
  worker after committed segment reconciles, throttled by
  ``KSIM_JOBS_CHECKPOINT_EVERY``; ``KSIM_JOBS_RESUME=1`` restores from
  the NEWEST valid checkpoint and replays only the remaining suffix.
  The torn-tail rule already gives checkpoint fallback for free: a
  record torn mid-append truncates away, so recovery sees the previous
  intact checkpoint.

Recovery is torn-tail tolerant: a process killed mid-append leaves a
partial (or checksum-failing) final line, and ``replay`` truncates the
file at the last valid record instead of crashing — corruption can lose
the torn tail, never the journal.  Compaction (``maybe_compact``)
bounds the file: past ``KSIM_JOBS_JOURNAL_MAX_BYTES`` the live registry
is rewritten as a snapshot (atomic tmp-file + fsync + rename), dropping
records of jobs the retention policy already pruned and keeping only
the NEWEST checkpoint per live job (older checkpoints are dead weight
once a newer one is durable).

Multi-process sharing: a fleet puts SEVERAL processes on one
journal — the front door appends submits/cancels while workers append
state/checkpoint/result records for the jobs they lease (docs/jobs.md
"Multi-worker fleet").  Two rules make that safe.  First, every append
is ONE ``os.write`` on an ``O_APPEND`` descriptor opened per record, so
concurrent appenders can interleave only at record granularity — the
old buffered ``f.write`` could split a multi-MB checkpoint line across
write(2) calls and interleave mid-record.  Second, ``shared=True`` arms
an ``fcntl.flock`` sidecar (``<path>.lock``) taken around appends,
replay's truncate, and compaction; shared compaction folds the FILE's
own records (not just this process's registry, which cannot see the
other appenders' records) and skips entirely when the lock is
contended.  Appenders re-open the path per record, so the compaction
rename never strands a writer on the old inode.

The module is stdlib-only and torch-free: recovery must work in a fresh
process whose backend may be wedged (the whole point of restarting).
Fault sites ``jobs.journal_append`` / ``jobs.journal_replay``
(docs/faults.md) inject I/O errors here, so a test can show that an
append failure fails the ONE job and never poisons the registry.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import threading
import zlib
from typing import Any, Callable, Iterable, Iterator

from ksim_tpu_torch.faults import FAULTS
from ksim_tpu_torch.obs import TRACE

__all__ = ["JobJournal", "JOURNAL_NAME"]

JOURNAL_NAME = "jobs.journal.jsonl"

#: Default compaction bound (bytes) — ``KSIM_JOBS_JOURNAL_MAX_BYTES``.
_MAX_BYTES_DEFAULT = 16 * 1024 * 1024


def _canon(rec: dict) -> str:
    """The canonical JSON the checksum covers (stable under
    re-serialization: sorted keys, no whitespace)."""
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _line(rec: dict) -> str:
    body = _canon(rec)
    crc = zlib.crc32(body.encode()) & 0xFFFFFFFF
    return (
        json.dumps({"crc": crc, "rec": json.loads(body)},
                   sort_keys=True, separators=(",", ":"))
        + "\n"
    )


def _decode_line(line: str) -> "dict | None":
    """One journal line -> the validated rec, or None (torn/corrupt)."""
    if not line.endswith("\n"):
        return None  # torn tail: the append died mid-write
    try:
        wrapper = json.loads(line)
        rec = wrapper["rec"]
        crc = int(wrapper["crc"])
    except (ValueError, KeyError, TypeError):
        return None
    if not isinstance(rec, dict):
        return None
    if zlib.crc32(_canon(rec).encode()) & 0xFFFFFFFF != crc:
        return None
    return rec


#: Terminal job states, duplicated from ``manager.TERMINAL_STATES`` —
#: the journal must stay importable without the manager (and torch-free).
_TERMINAL = frozenset({"succeeded", "failed", "cancelled", "interrupted"})


def _fold_compact(recs: "list[dict]") -> "list[dict]":
    """Fold a full record stream into its compact equivalent: per job
    (first-submit order) the submit, the NEWEST state, the cancel
    request while live, and either the result (terminal) or the NEWEST
    checkpoint (live — older checkpoints are the bulk compaction
    exists to shed).  Record types this fold does not understand, and
    records for ids whose submit is absent, pass through verbatim at
    the end: a shared journal must never drop another appender's data
    it merely fails to recognize."""
    order: list[str] = []
    ents: dict[str, dict] = {}
    extras: list[dict] = []
    for rec in recs:
        t = rec.get("t")
        jid = rec.get("id")
        if t == "submit" and jid:
            ent = ents.get(jid)
            if ent is None:
                order.append(jid)
                ents[jid] = {"submit": rec, "state": None, "result": None,
                             "cancel": None, "checkpoint": None}
            else:
                ent["submit"] = rec
        elif t in ("state", "result", "cancel", "checkpoint") and jid in ents:
            key = "checkpoint" if t == "checkpoint" else t
            ents[jid][key] = rec  # newest wins
        else:
            extras.append(rec)
    out: list[dict] = []
    for jid in order:
        ent = ents[jid]
        out.append(ent["submit"])
        st = ent["state"]
        terminal = st is not None and st.get("state") in _TERMINAL
        if ent["cancel"] is not None and not terminal:
            out.append(ent["cancel"])
        if st is not None:
            out.append(st)
        if terminal:
            if ent["result"] is not None:
                out.append(ent["result"])
        elif ent["checkpoint"] is not None:
            out.append(ent["checkpoint"])
    out.extend(extras)
    return out


class JobJournal:
    """Append-only JSONL WAL for one JobManager's registry.

    Thread-safe: appends from the submit path and every worker thread
    serialize on ``_lock``.  Lock order: ``_lock`` comes FIRST —
    ``append``/``replay`` consult the fault plane under it, and
    ``maybe_compact`` invokes the manager's snapshot callable under it
    (journal ``_lock`` -> manager ``_lock`` -> job ``_cond``; the
    manager side of that chain is declared beside
    ``JobManager._journal_records``)."""

    # Machine-checked acquisition order (tools/ksimlint lock-order —
    # docs/lint.md "Lock order"): the fault plane, and the trace plane
    # it emits into, are leaves under the journal lock.
    # ksimlint: lock-order(JobJournal._lock<FaultPlane._lock)
    # ksimlint: lock-order(JobJournal._lock<TracePlane._lock)

    def __init__(self, path: str, *, max_bytes: "int | None" = None,
                 shared: bool = False) -> None:
        if max_bytes is None:
            raw = os.environ.get("KSIM_JOBS_JOURNAL_MAX_BYTES", "")
            max_bytes = int(raw) if raw else _MAX_BYTES_DEFAULT
        self.path = path
        self.max_bytes = max(int(max_bytes), 0)  # 0 = never compact
        #: True when OTHER processes may hold this journal open (fleet
        #: mode): appends/truncates/compactions take the flock sidecar.
        self.shared = bool(shared)
        self._lock_path = f"{path}.lock"
        self._lock = threading.Lock()
        self._size = 0  # guarded-by: _lock (local appends only in shared mode)
        self.appends = 0  # guarded-by: _lock
        self.append_errors = 0  # guarded-by: _lock
        self.compactions = 0  # guarded-by: _lock
        self.truncated_bytes = 0  # guarded-by: _lock (torn-tail recovery)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    @contextlib.contextmanager
    def _flock(self, *, blocking: bool = True) -> "Iterator[bool]":
        """Cross-PROCESS exclusion (fcntl.flock on the sidecar file);
        yields whether the lock was obtained.  A no-op yielding True
        when the journal is not shared — threads in one process already
        serialize on ``_lock``.  flock is per-open-description, so two
        handles in ONE process exclude each other too (what the
        in-process durability tests lean on)."""
        if not self.shared:
            yield True
            return
        fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            try:
                fcntl.flock(
                    fd, fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB))
            except OSError:
                yield False
                return
            try:
                yield True
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)

    # -- append ----------------------------------------------------------

    def append(self, rec: dict) -> None:
        """Durably append one record (single ``os.write`` on an
        ``O_APPEND`` descriptor, then fsync).  The per-record open plus
        single write keeps concurrent appenders record-atomic: buffered
        I/O could split one large line across write(2) calls and let a
        second process interleave mid-record.  Raises on I/O failure
        (including the armed ``jobs.journal_append`` fault) — the
        CALLER owns the containment policy: fail the one job the record
        belongs to, never the registry."""
        data = _line(rec).encode("utf-8")
        with TRACE.span("jobs.journal_append", type=rec.get("t")):
            with self._lock:
                try:
                    FAULTS.check("jobs.journal_append")
                    with self._flock():
                        fd = os.open(
                            self.path,
                            os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
                        try:
                            # A short write can only come from the OS
                            # (disk full, signal); under the flock the
                            # retry tail still cannot interleave, and a
                            # crash between writes leaves a torn tail
                            # replay() truncates away.
                            view = memoryview(data)
                            while view:
                                view = view[os.write(fd, view):]
                            os.fsync(fd)
                        finally:
                            os.close(fd)
                except BaseException:
                    self.append_errors += 1
                    raise
                self._size += len(data)
                self.appends += 1

    # -- recovery --------------------------------------------------------

    def replay(self) -> list[dict]:
        """Read every valid record, truncating the file at the FIRST
        invalid line (a torn tail from a mid-append crash, or garbage —
        everything after it is unordered debris the WAL contract cannot
        vouch for).  Never raises on corruption; I/O errors (including
        the armed ``jobs.journal_replay`` fault) propagate to the
        manager, which recovers what it can and never crashes startup."""
        with TRACE.span("jobs.journal_replay"):
            with self._lock:
                FAULTS.check("jobs.journal_replay")
                # Shared mode holds the flock across read + truncate so
                # the torn-tail cut never races a live appender (whose
                # record past our read point would otherwise be cut).
                with self._flock():
                    recs: list[dict] = []
                    good_end = 0
                    try:
                        f = open(self.path, "r", encoding="utf-8",
                                 newline="")
                    except FileNotFoundError:
                        return recs
                    with f:
                        for line in f:
                            rec = _decode_line(line)
                            if rec is None:
                                break
                            recs.append(rec)
                            good_end += len(line.encode())
                        total = os.path.getsize(self.path)
                    if good_end < total:
                        self.truncated_bytes = total - good_end
                        with open(self.path, "a", encoding="utf-8") as tf:
                            tf.truncate(good_end)
                    self._size = good_end
                    return recs

    # -- compaction ------------------------------------------------------

    def maybe_compact(self, snapshot_fn: Callable[[], Iterable[dict]]) -> bool:  # ksimlint: thread-role(compactor)
        """Rewrite the journal as a snapshot of the LIVE registry when
        it outgrew ``max_bytes``.  ``snapshot_fn`` is called under the
        journal lock and must not take it again (the manager's registry
        lock is fine — see the class docstring's lock order).  Failures
        are swallowed: compaction is an optimization, the oversized
        journal stays fully valid.

        Shared journals IGNORE ``snapshot_fn`` and fold the file's own
        records instead: this process's registry cannot see records the
        other fleet processes appended, and a registry-only rewrite
        would silently drop them.  The fold runs under a NON-blocking
        flock — contention means another process is appending or
        already compacting, so we skip and let a later call retry."""
        with self._lock:
            if not self.max_bytes:
                return False
            if self.shared:
                return self._compact_shared_locked()
            if self._size <= self.max_bytes:
                return False
            try:
                lines = [_line(rec) for rec in snapshot_fn()]
                tmp = f"{self.path}.tmp{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.writelines(lines)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
            except OSError:
                return False
            self._size = sum(len(ln) for ln in lines)
            self.compactions += 1
            return True

    def _compact_shared_locked(self) -> bool:  # ksimlint: lock-held(_lock)
        """Shared-mode compaction body (caller holds ``_lock``).  Size
        comes from the FILE — the local ``_size`` counts only this
        process's appends.  Holding the exclusive flock across
        read-fold-rewrite keeps the rename atomic w.r.t. every other
        appender (they re-open the path per record, so nobody writes
        to the dead inode afterwards)."""
        try:
            if os.path.getsize(self.path) <= self.max_bytes:
                return False
        except OSError:
            return False
        with self._flock(blocking=False) as held:
            if not held:
                return False
            try:
                recs: list[dict] = []
                with open(self.path, "r", encoding="utf-8",
                          newline="") as f:
                    for line in f:
                        rec = _decode_line(line)
                        if rec is None:
                            break
                        recs.append(rec)
                lines = [_line(rec) for rec in _fold_compact(recs)]
                tmp = f"{self.path}.tmp{os.getpid()}"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.writelines(lines)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
            except OSError:
                return False
            self._size = sum(len(ln.encode()) for ln in lines)
            self.compactions += 1
            return True

    # -- evidence --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "size_bytes": self._size,
                "max_bytes": self.max_bytes,
                "shared": self.shared,
                "appends": self.appends,
                "append_errors": self.append_errors,
                "compactions": self.compactions,
                "truncated_bytes": self.truncated_bytes,
            }
