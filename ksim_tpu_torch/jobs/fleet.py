"""Multi-worker job fleet: lease-claimed jobs over one shared journal.

The port of ``ksim_tpu/jobs/fleet.py``.  Two callees of the reference's
``main`` map to what the port has: ``util.enable_compilation_cache``
(the persistent XLA compile cache) has no counterpart, because the
port's on-disk layer is the kernel libraries that kernels/build.py
compiles once into ``build/ksim_tpu_torch/`` and every process loads;
and both ``KSIM_AOT_PREWARM`` modes run engine/replay.py
``prewarm_aot_cache`` (load every library already on disk, build none),
as cmd/simulator.py does, because the port has no per-rung executables
to rescan.  ``main`` takes ``--device`` (default: the card).

N worker PROCESSES share one ``KSIM_JOBS_DIR`` behind one HTTP front
door.  The checksummed WAL journal is the source of truth, segment
checkpoints make jobs migratable mid-run, and the kernel libraries on
disk are shared by every process.  This module adds the one new
mechanism: a LEASE plane that makes concurrent job claims safe across
processes, and the poller that drives each member's role.

The division of labor (docs/jobs.md "Multi-worker fleet"):

- The FRONT DOOR (``KSIM_WORKERS_ROLE=frontdoor``) owns the HTTP
  surface.  It validates and journals submissions exactly as the solo
  manager does, but runs zero local workers — its registry holds
  MIRROR jobs whose state/result/events are folded back from what the
  worker processes append to the shared journal and to the per-job
  event files (``<dir>/events/<jid>.jsonl``).  SSE fans out from the
  mirror ring, so late joiners replay the recovered backlog gap-free
  across process boundaries, as a restarted solo manager's is.
- Each WORKER (``KSIM_WORKERS_ROLE=worker``) tails the shared journal
  for submits it has not seen, claims one by appending a lease record
  (worker id, epoch, expiry) to ``jobs.leases.jsonl`` under an
  exclusive ``fcntl.flock``, runs it on its local pool (journaling
  state/checkpoint/result records to the SHARED journal exactly like a
  solo manager), renews its leases every heartbeat, and releases them
  only AFTER the terminal record is durable.

Claim safety is the flock: ``LeasePlane.claim`` re-folds the lease
file's current state under the exclusive lock before appending, so two
workers racing for one job serialize and exactly one wins — the loser
sees the winner's unexpired lease and refuses.  Fail-over is lease
EXPIRY: a SIGKILL'd worker stops renewing, its leases age out, and a
surviving worker's claim succeeds with a bumped epoch (``takeover``),
adopts the job from the journal fold, and resumes from the newest valid
checkpoint via the manager's restore path — counts byte-identical to an
uninterrupted run.  A RELEASED lease is never re-claimable:
releases happen only after a terminal record is durable, so released ==
finished, and re-running a finished job is the one mistake the protocol
must never make.  The documented residual: a slow-but-ALIVE worker
whose lease expires (e.g. a multi-second GC pause spanning several
missed heartbeats) can race its own successor; heartbeats default to
lease/3, making that window require three consecutive missed renews.

Like journal.py this module is stdlib-only and torch-free at import: the
front door must mirror results in a process whose backend is wedged,
and the worker CLI (``python -m ksim_tpu_torch.jobs.fleet``) defers the
manager import until after argument parsing.

Fault sites ``jobs.lease_claim`` / ``jobs.lease_renew`` (docs/faults.md)
inject I/O errors into the claim/renew paths so chaos runs prove a
failed claim skips ONE poll (another member picks the job up) and
missed renews are survivable until lease expiry.
"""

from __future__ import annotations

import fcntl
import logging
import os
import threading
import time

from ksim_tpu_torch.errors import RunCancelled
from ksim_tpu_torch.faults import FAULTS
from ksim_tpu_torch.jobs.journal import JOURNAL_NAME, _decode_line, _line
from ksim_tpu_torch.obs import (
    TRACE,
    merge_chrome_traces,
    merge_latency_snapshots,
    next_publish_seq,
    process_identity,
    provider_snapshots,
    publish_snapshot,
)

__all__ = [
    "EVENTS_DIR",
    "FileLock",
    "FleetMember",
    "JournalTailer",
    "LEASES_NAME",
    "LeasePlane",
]

logger = logging.getLogger(__name__)

LEASES_NAME = "jobs.leases.jsonl"
EVENTS_DIR = "events"

#: Lease-file compaction bound: renew records accumulate one per owned
#: job per heartbeat, so long fleets would grow the file unboundedly.
_LEASES_MAX_BYTES = 4 * 1024 * 1024

#: Terminal job states, duplicated from ``manager.TERMINAL_STATES`` —
#: this module must stay importable without the manager (and torch-free).
_TERMINAL = frozenset({"succeeded", "failed", "cancelled", "interrupted"})


class FileLock:
    """Cross-process mutual exclusion via ``fcntl.flock`` on a sidecar
    file.  flock is per-open-DESCRIPTION: every ``acquire`` opens a
    fresh descriptor, so two FileLock instances in ONE process exclude
    each other too — which is exactly what the in-process claim-race
    unit tests lean on.  Instances are single-owner (one thread uses
    one instance); cross-thread exclusion is the caller's lock."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._fd: "int | None" = None

    def acquire(self, *, blocking: bool = True) -> bool:
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(
                fd, fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB))
        except OSError:
            os.close(fd)
            return False
        self._fd = fd
        return True

    def release(self) -> None:
        fd, self._fd = self._fd, None
        if fd is not None:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()


def _read_recs(path: str) -> list[dict]:
    """Every CRC-valid record from a lease/journal file, stopping at
    the first invalid line (torn tail).  Never raises on a missing
    file — an empty fleet has no lease file yet."""
    recs: list[dict] = []
    try:
        f = open(path, "r", encoding="utf-8", newline="")
    except OSError:
        return recs
    with f:
        for line in f:
            rec = _decode_line(line)
            if rec is None:
                break
            recs.append(rec)
    return recs


class JournalTailer:
    """Incremental reader over an append-only record file: ``poll``
    returns the records appended since the last call, leaving an
    in-flight torn tail (no trailing newline yet) for the next poll.
    A rewrite (compaction replaces the inode, or the file shrank)
    resets the cursor to zero and returns the WHOLE new file with
    ``reset=True`` — the caller's fold must be idempotent, which the
    per-id newest-wins folds here are.  Single-owner: only the fleet
    poller thread touches a tailer."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.offset = 0
        self.invalid = 0
        self._ino: "int | None" = None

    def poll(self) -> "tuple[bool, list[dict]]":
        try:
            st = os.stat(self.path)
        except OSError:
            return False, []
        reset = (self._ino is not None and st.st_ino != self._ino) or (
            st.st_size < self.offset
        )
        if reset:
            self.offset = 0
        self._ino = st.st_ino
        if st.st_size <= self.offset:
            return reset, []
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            data = f.read()
        recs: list[dict] = []
        pos = 0
        while True:
            nl = data.find(b"\n", pos)
            if nl < 0:
                break  # torn/in-flight tail: retry next poll
            rec = _decode_line(data[pos:nl + 1].decode("utf-8", "replace"))
            if rec is None:
                self.invalid += 1  # complete but corrupt: skip, count
            else:
                recs.append(rec)
            pos = nl + 1
        self.offset += pos
        return reset, recs


class LeasePlane:
    """The fleet's claim protocol: an append-only, CRC-checksummed
    lease file (``jobs.leases.jsonl``) mutated only under an exclusive
    ``fcntl.flock``.  Record types::

        {"t": "claim",   "id", "worker", "epoch", "expires", "ts",
                         ["takeover", "prev"]}
        {"t": "renew",   "id", "worker", "epoch", "expires", "ts"}
        {"t": "release", "id", "worker", "epoch", "ts"}
        {"t": "counters", "workers": {...}}   (compaction snapshot)

    Folding the file in order yields the current lease per job id
    (newest record wins) plus per-worker counters (claims, takeovers,
    renews, and expired — charged to the worker that LOST the lease).
    Compaction keeps the newest record per id and appends the folded
    counters LAST, so a refold's incremental counting is overwritten by
    the authoritative totals."""

    # The fault/trace planes are leaves under the lease lock (the
    # claim/renew paths consult them while folding under ``_lock``).
    # ksimlint: lock-order(LeasePlane._lock<FaultPlane._lock)
    # ksimlint: lock-order(LeasePlane._lock<TracePlane._lock)

    def __init__(
        self,
        jobs_dir: str,
        *,
        worker: str,
        lease_s: float = 10.0,
        clock=time.time,
    ) -> None:
        self.path = os.path.join(jobs_dir, LEASES_NAME)
        self.worker = worker
        self.lease_s = max(float(lease_s), 0.1)
        self._clock = clock
        self._lock = threading.Lock()
        self._flock = FileLock(f"{self.path}.lock")
        os.makedirs(jobs_dir, exist_ok=True)

    # -- folding ---------------------------------------------------------

    @staticmethod
    def _fold(recs: list[dict]) -> "tuple[dict, dict]":
        """(leases by job id, counters by worker id)."""
        leases: dict[str, dict] = {}
        counters: dict[str, dict] = {}

        def cnt(worker: str) -> dict:
            return counters.setdefault(worker, {
                "claims": 0, "takeovers": 0, "renews": 0, "expired": 0,
            })

        for rec in recs:
            t = rec.get("t")
            if t == "counters":
                counters = {
                    w: dict(c) for w, c in (rec.get("workers") or {}).items()
                }
                continue
            jid, worker = rec.get("id"), rec.get("worker")
            if not isinstance(jid, str) or not isinstance(worker, str):
                continue
            if t == "claim":
                leases[jid] = {
                    "worker": worker,
                    "epoch": int(rec.get("epoch", 1)),
                    "expires": float(rec.get("expires", 0.0)),
                    "released": False,
                    "ts": rec.get("ts"),
                }
                c = cnt(worker)
                c["claims"] += 1
                if rec.get("takeover"):
                    c["takeovers"] += 1
                    prev = rec.get("prev")
                    if isinstance(prev, str):
                        cnt(prev)["expired"] += 1
            elif t == "renew":
                ent = leases.get(jid)
                if ent is not None and ent["worker"] == worker:
                    ent["expires"] = float(rec.get("expires", ent["expires"]))
                    ent["ts"] = rec.get("ts")
                cnt(worker)["renews"] += 1
            elif t == "release":
                ent = leases.get(jid)
                if ent is None:
                    # A compacted file keeps ONLY the release record for
                    # a finished job — reconstruct the tombstone, or the
                    # released-never-reclaimable invariant would not
                    # survive compaction.
                    leases[jid] = {
                        "worker": worker,
                        "epoch": int(rec.get("epoch", 1)),
                        "expires": 0.0,
                        "released": True,
                        "ts": rec.get("ts"),
                    }
                elif ent["worker"] == worker:
                    ent["released"] = True
                    ent["expires"] = 0.0  # no expiry on a tombstone
                    ent["ts"] = rec.get("ts")
        return leases, counters

    def _append_locked(self, recs: list[dict]) -> None:  # ksimlint: lock-held(_lock)
        """Durable batch append; the caller holds ``_lock`` AND the
        flock (the whole point — the fold it just did stays true)."""
        data = "".join(_line(rec) for rec in recs).encode("utf-8")
        fd = os.open(self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            view = memoryview(data)
            while view:
                view = view[os.write(fd, view):]
            os.fsync(fd)
        finally:
            os.close(fd)

    # -- the claim protocol ----------------------------------------------

    def claim(self, jid: str) -> "dict | None":
        """Claim ``jid`` for this worker, or refuse (None).  The whole
        read-fold-decide-append runs under the exclusive flock, which
        is what makes two racing claimers serialize.  Refusals: a live
        lease held by another worker, or a RELEASED lease (released ==
        the owner journaled a terminal record; re-claiming would re-run
        a finished job).  An expired unreleased lease is the fail-over
        case: the claim succeeds with a bumped epoch and is counted as
        a takeover against the previous owner."""
        with TRACE.span("jobs.lease_claim", job=jid, worker=self.worker):
            with self._lock:
                FAULTS.check("jobs.lease_claim")
                with self._flock:
                    leases, _ = self._fold(_read_recs(self.path))
                    now = self._clock()
                    ent = leases.get(jid)
                    takeover = False
                    prev: "str | None" = None
                    if ent is not None:
                        if ent["released"]:
                            return None
                        if ent["worker"] == self.worker and ent["expires"] > now:
                            return dict(ent)  # idempotent re-claim
                        if ent["expires"] > now:
                            return None  # live lease, someone else's
                        takeover = True
                        prev = ent["worker"]
                    epoch = (ent["epoch"] + 1) if ent is not None else 1
                    rec: dict = {
                        "t": "claim", "id": jid, "worker": self.worker,
                        "epoch": epoch, "expires": now + self.lease_s,
                        "ts": round(now, 3),
                    }
                    if takeover:
                        rec["takeover"] = True
                        rec["prev"] = prev
                    self._append_locked([rec])
            if takeover:
                TRACE.event(
                    "jobs.lease_expired", job=jid, worker=prev,
                    epoch=epoch - 1,
                )
            TRACE.event(
                "jobs.fleet_claim", job=jid, worker=self.worker,
                epoch=epoch, takeover=takeover,
            )
            return {
                "worker": self.worker, "epoch": epoch,
                "expires": now + self.lease_s, "released": False,
                "ts": rec["ts"],
            }

    def renew(self, jids: list[str]) -> int:
        """Heartbeat: extend this worker's live leases on ``jids``.
        Returns how many renewed (a lease that expired and was taken
        over in the meantime is NOT renewed — the job is no longer
        ours, and the local runner's next cancel check should stop
        it)."""
        if not jids:
            return 0
        with TRACE.span("jobs.lease_renew", worker=self.worker, n=len(jids)):
            with self._lock:
                FAULTS.check("jobs.lease_renew")
                with self._flock:
                    leases, _ = self._fold(_read_recs(self.path))
                    now = self._clock()
                    recs = []
                    for jid in jids:
                        ent = leases.get(jid)
                        if (
                            ent is None
                            or ent["released"]
                            or ent["worker"] != self.worker
                        ):
                            continue
                        recs.append({
                            "t": "renew", "id": jid, "worker": self.worker,
                            "epoch": ent["epoch"],
                            "expires": now + self.lease_s,
                            "ts": round(now, 3),
                        })
                    if recs:
                        self._append_locked(recs)
                    return len(recs)

    def release(self, jid: str) -> None:
        """Mark this worker's lease finished — append-only, AFTER the
        job's terminal record is durable in the shared journal (the
        released-means-finished invariant ``claim`` relies on)."""
        with self._lock:
            with self._flock:
                leases, _ = self._fold(_read_recs(self.path))
                ent = leases.get(jid)
                if ent is None or ent["worker"] != self.worker:
                    return
                self._append_locked([{
                    "t": "release", "id": jid, "worker": self.worker,
                    "epoch": ent["epoch"], "ts": round(self._clock(), 3),
                }])

    # -- views & compaction ----------------------------------------------

    def leases(self) -> dict:
        with self._lock:
            with self._flock:
                leases, _ = self._fold(_read_recs(self.path))
                return leases

    def counters(self) -> dict:
        with self._lock:
            with self._flock:
                _, counters = self._fold(_read_recs(self.path))
                return counters

    def maybe_compact(self, *, max_bytes: int = _LEASES_MAX_BYTES) -> bool:
        """Rewrite the lease file as newest-record-per-id plus the
        folded counters (LAST, so a refold's incremental counts are
        overwritten by the authoritative totals).  Non-blocking flock:
        contention means another member is mid-claim — skip."""
        with self._lock:
            try:
                if os.path.getsize(self.path) <= max_bytes:
                    return False
            except OSError:
                return False
            if not self._flock.acquire(blocking=False):
                return False
            try:
                recs = _read_recs(self.path)
                leases, counters = self._fold(recs)
                now = self._clock()
                out = []
                for jid, ent in leases.items():
                    if ent["released"]:
                        out.append({
                            "t": "release", "id": jid,
                            "worker": ent["worker"], "epoch": ent["epoch"],
                            "ts": ent["ts"],
                        })
                    else:
                        out.append({
                            "t": "claim", "id": jid, "worker": ent["worker"],
                            "epoch": ent["epoch"], "expires": ent["expires"],
                            "ts": ent["ts"] or round(now, 3),
                        })
                out.append({"t": "counters", "workers": counters})
                lines = [_line(rec) for rec in out]
                tmp = f"{self.path}.tmp{os.getpid()}"
                try:
                    with open(tmp, "w", encoding="utf-8") as f:
                        f.writelines(lines)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, self.path)
                except OSError:
                    return False
                return True
            finally:
                self._flock.release()


class FleetMember:
    """One process's seat in the fleet: a single daemon poller thread
    driving the role's duties against the shared ``KSIM_JOBS_DIR``.

    Worker: tail the shared journal, claim unleased (or expired-lease)
    submits, adopt them onto the local pool, renew leases every
    heartbeat, forward the owned jobs' event rings to the per-job event
    files, honor journaled cancel records, and release leases once the
    terminal record is durable.

    Front door: tail the shared journal and mirror worker-journaled
    state/result records into the local mirror jobs (quietly — the
    event FILES are the event authority, the journal the state
    authority), tail the event files into the mirror SSE rings, and
    fold lease ownership into each job's status fields.  After a
    takeover a mirror's progress can legitimately drop back to the
    checkpoint baseline the new owner resumed from — truthful, not a
    bug (docs/jobs.md)."""

    # Deliberately lock-poor: ``_lock`` guards only the member's own
    # dicts and is never held across calls into the manager or a job —
    # the poller snapshots under it, then works outside it.

    def __init__(
        self,
        manager,
        jobs_dir: str,
        *,
        role: str,
        worker_id: str,
        lease_s: float = 10.0,
        heartbeat_s: "float | None" = None,
        poll_s: float = 0.5,
        publish_s: "float | None" = None,
    ) -> None:
        if role not in ("frontdoor", "worker"):
            raise ValueError(f"unknown fleet role {role!r}")
        self._manager = manager
        self._dir = jobs_dir
        self.role = role
        self.worker_id = worker_id
        self.lease_s = max(float(lease_s), 0.1)
        self.heartbeat_s = (
            max(float(heartbeat_s), 0.05)
            if heartbeat_s is not None
            else self.lease_s / 3.0
        )
        self.poll_s = max(float(poll_s), 0.02)
        # Telemetry publish cadence (docs/observability.md "Fleet
        # observability"): KSIM_OBS_PUBLISH_S seconds between snapshot
        # publishes, default 10; 0 disables the publisher thread
        # entirely (and the obs/ directory is never created).
        if publish_s is None:
            raw = os.environ.get("KSIM_OBS_PUBLISH_S", "")
            try:
                publish_s = float(raw) if raw else 10.0
            except ValueError:
                publish_s = 10.0
        self.publish_s = max(float(publish_s), 0.0)
        self.plane = LeasePlane(jobs_dir, worker=worker_id, lease_s=lease_s)
        self._tailer = JournalTailer(os.path.join(jobs_dir, JOURNAL_NAME))
        self._events_dir = os.path.join(jobs_dir, EVENTS_DIR)
        os.makedirs(self._events_dir, exist_ok=True)
        # Poller-thread-only working state (no cross-thread readers).
        self._folded: dict[str, dict] = {}
        self._drained: dict[str, int] = {}
        self._event_tailers: dict[str, JournalTailer] = {}
        self._done: set[str] = set()
        self._last_renew = 0.0
        # Cross-thread-visible state (snapshot() runs on HTTP threads).
        self._lock = threading.Lock()
        self._owned: dict[str, object] = {}  # guarded-by: _lock
        self._polls = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._publish_thread: "threading.Thread | None" = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        t = threading.Thread(
            target=self._poll_loop,
            name=f"fleet-{self.role}-{self.worker_id}",
            daemon=True,
        )  # ksimlint: thread-role(fleet-poller)
        t.start()
        self._thread = t
        if self.publish_s > 0:
            p = threading.Thread(
                target=self._publish_loop,
                name=f"obs-publish-{self.worker_id}",
                daemon=True,
            )  # ksimlint: thread-role(obs-publisher)
            p.start()
            self._publish_thread = p

    def stop(self, timeout: "float | None" = 5.0) -> None:
        """Stop the poller, then run ONE final poll inline to drain any
        remaining owned-job events and release leases of jobs that
        reached a terminal state during shutdown (a lease left behind
        simply expires — correctness never depends on this drain).
        With publishing on, one final snapshot publishes AFTER the
        drain, so the on-disk telemetry reflects this member's terminal
        truth."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        p = self._publish_thread
        if p is not None:
            p.join(timeout)
        try:
            self._poll_once()
        except Exception:
            logger.exception("fleet final drain failed")
        if self.publish_s > 0:
            try:
                self.publish_once()
            except Exception:
                logger.exception("final obs publish failed")

    # -- the poller ------------------------------------------------------

    def _poll_loop(self) -> None:  # ksimlint: thread-role(fleet-poller)
        while not self._stop.wait(self.poll_s):
            try:
                self._poll_once()
            except RunCancelled:
                raise
            except Exception:
                # Containment: one bad poll (an armed lease fault, a
                # transient I/O error) must not kill the member — the
                # next tick retries from durable state.
                logger.exception(
                    "fleet poll failed (role=%s worker=%s)",
                    self.role, self.worker_id,
                )

    def _poll_once(self) -> None:
        reset, recs = self._tailer.poll()
        if reset:
            self._folded.clear()
        self._fold(recs)
        if self.role == "worker":
            self._poll_worker()
        else:
            self._poll_frontdoor()
        self.plane.maybe_compact()
        with self._lock:
            self._polls += 1

    def _fold(self, recs: list[dict]) -> None:
        """Incremental journal fold, mirroring ``JobManager._recover``'s
        shapes so worker adoption can hand the entry straight to
        ``JobManager.adopt``.  The front door drops checkpoint PAYLOADS
        (multi-MB store snapshots it will never restore), keeping only
        the segment number for status; workers keep the newest two
        (newest first to try, one fallback behind it)."""
        for rec in recs:
            t, jid = rec.get("t"), rec.get("id")
            if not isinstance(jid, str):
                continue
            ent = self._folded.setdefault(jid, {
                "submit": None, "state": None, "error": None,
                "result": None, "cancel": False,
                "started": None, "finished": None,
                "checkpoints": [], "history": [],
                "checkpoint_segment": None,
            })
            if t == "submit":
                ent["submit"] = rec
            elif t == "state":
                state = rec.get("state")
                ent["state"], ent["error"] = state, rec.get("error")
                if state == "running":
                    ent["started"] = rec.get("ts")
                elif state in _TERMINAL:
                    ent["finished"] = rec.get("ts")
                ent["history"].append({
                    "state": state, "ts": rec.get("ts"),
                    "error": rec.get("error"),
                })
            elif t == "result":
                ent["result"] = rec.get("result")
            elif t == "cancel":
                ent["cancel"] = True
            elif t == "checkpoint":
                ent["checkpoint_segment"] = rec.get("segment")
                if self.role == "worker":
                    ent["checkpoints"] = (ent["checkpoints"] + [rec])[-2:]

    # -- worker role -----------------------------------------------------

    def _poll_worker(self) -> None:
        self._adopt_claimable()
        self._apply_cancels()
        now = time.monotonic()
        if now - self._last_renew >= self.heartbeat_s:
            with self._lock:
                owned = list(self._owned)
            try:
                self.plane.renew(owned)
            except Exception:
                # A missed renew (armed jobs.lease_renew fault, I/O
                # blip) is survivable until lease expiry.
                logger.exception("lease renew failed (worker=%s)",
                                 self.worker_id)
            self._last_renew = now
        self._drain_owned()

    def _adopt_claimable(self) -> None:
        stats = self._manager.queue.stats()
        if stats["capacity"] and stats["depth"] >= stats["capacity"]:
            return  # local backpressure: let another member claim
        leases = None
        now = time.time()
        for jid in sorted(self._folded):
            ent = self._folded[jid]
            if (
                ent["submit"] is None
                or ent["state"] in _TERMINAL
                or jid in self._done
            ):
                continue
            with self._lock:
                if jid in self._owned:
                    continue
            if leases is None:
                leases = self.plane.leases()  # one read per poll
            lease = leases.get(jid)
            if lease is not None and (
                lease["released"]
                or (lease["worker"] != self.worker_id
                    and lease["expires"] > now)
            ):
                continue  # finished, or someone else holds it live
            try:
                won = self.plane.claim(jid)
                if won is None:
                    continue  # lost the race under the flock
            except Exception:
                logger.exception("lease claim failed (job=%s)", jid)
                continue
            try:
                job = self._manager.adopt(jid, ent, won)
            except Exception:
                # Local backpressure (JobQueueFull) or a transient
                # build failure: KEEP the lease and retry next poll —
                # claim() is idempotent for our own live lease, and an
                # un-renewed lease simply expires back to the fleet.
                logger.exception("adopt failed (job=%s); retrying", jid)
                continue
            if job is None:
                # The spec no longer parses; adopt journaled the
                # terminal refusal, so the lease lifecycle ends too.
                self.plane.release(jid)
                self._done.add(jid)
                continue
            with self._lock:
                self._owned[jid] = job
            self._drained.setdefault(jid, 0)

    def _apply_cancels(self) -> None:
        with self._lock:
            owned = dict(self._owned)
        for jid, job in owned.items():
            ent = self._folded.get(jid)
            if ent is not None and ent["cancel"] and not job.cancel.is_set():
                job.request_cancel()

    def _drain_owned(self) -> None:
        with self._lock:
            owned = dict(self._owned)
        for jid, job in owned.items():
            evs, nxt, done = job.events_since(self._drained.get(jid, 0), 0)
            self._drained[jid] = nxt
            out = [ev for ev in evs if not ev.get("recovered")]
            if out:
                try:
                    self._append_events(jid, out)
                except OSError:
                    # Events are best-effort streaming evidence; the
                    # journal carries the authoritative state.
                    logger.exception("event append failed (job=%s)", jid)
            if done:
                try:
                    self.plane.release(jid)
                except Exception:
                    logger.exception("lease release failed (job=%s)", jid)
                with self._lock:
                    self._owned.pop(jid, None)
                self._done.add(jid)

    def _event_path(self, jid: str) -> str:
        return os.path.join(self._events_dir, f"{jid}.jsonl")

    def _append_events(self, jid: str, evs: list[dict]) -> None:
        """Forward a batch of the owned job's ring events to its event
        file — single O_APPEND write, record-atomic against a deposed
        predecessor's last gasp."""
        data = "".join(
            _line({"t": "event", "id": jid, "ev": ev}) for ev in evs
        ).encode("utf-8")
        fd = os.open(
            self._event_path(jid),
            os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644,
        )
        try:
            view = memoryview(data)
            while view:
                view = view[os.write(fd, view):]
        finally:
            os.close(fd)

    # -- front-door role -------------------------------------------------

    def _poll_frontdoor(self) -> None:
        try:
            leases = self.plane.leases()
        except Exception:
            logger.exception("lease read failed (frontdoor)")
            leases = {}
        for jid, ent in self._folded.items():
            job = self._manager.get(jid)
            if job is None:
                self._event_tailers.pop(jid, None)
                continue
            tailer = self._event_tailers.get(jid)
            if tailer is None:
                tailer = self._event_tailers[jid] = JournalTailer(
                    self._event_path(jid))
            _, evrecs = tailer.poll()
            for rec in evrecs:
                ev = rec.get("ev")
                if isinstance(ev, dict):
                    job.emit(dict(ev), vital=ev.get("event") in (
                        "state", "progress"))
            lease = leases.get(jid)
            if lease is not None:
                job._set_lease(lease)
            if ent["state"] is not None:
                job._mirror_state(
                    ent["state"], error=ent["error"], result=ent["result"],
                    started=ent["started"], finished=ent["finished"],
                    segment=ent["checkpoint_segment"],
                )

    # -- telemetry publishing (docs/observability.md) --------------------

    def _publish_loop(self) -> None:  # ksimlint: thread-role(obs-publisher)
        while not self._stop.wait(self.publish_s):
            try:
                self.publish_once()
            except RunCancelled:
                raise
            except Exception:
                # Containment: telemetry is evidence, never load-bearing
                # — a failed publish leaves the previous snapshot
                # standing and the next tick retries.
                logger.exception(
                    "obs publish failed (role=%s worker=%s)",
                    self.role, self.worker_id,
                )

    def _obs_document(self) -> "tuple[dict, dict]":
        """(snapshot document, merged Chrome trace document) for this
        member.  Job spans (``jobs.run``, ``replay.dispatch``, ...)
        land on each job's PRIVATE plane via the worker's scoped
        override, so the global ``TRACE`` alone under-reports a worker:
        both documents merge the global plane with every registered
        job's plane — histograms bucket-wise exactly (fixed edges),
        rings as one process lane."""
        now = time.time()
        ident = process_identity(role=self.role, worker_id=self.worker_id)
        ident["seq"] = next_publish_seq()
        ident["published_at"] = round(now, 3)
        ident["publish_s"] = self.publish_s
        jobs = self._manager.jobs()
        sections = [TRACE.snapshot()]
        traces = {self.worker_id: TRACE.export_chrome()}
        for job in jobs:
            plane = getattr(job, "trace", None)
            if plane is None:
                continue
            sections.append(plane.snapshot())
            traces[f"{self.worker_id}:{job.id}"] = plane.export_chrome()
        events: dict[str, int] = {}
        hist_snaps: dict[str, list] = {}
        for sec in sections:
            for name, v in (sec.get("events") or {}).items():
                events[name] = events.get(name, 0) + int(v)
            for name, snap in (sec.get("histograms") or {}).items():
                hist_snaps.setdefault(name, []).append(snap)
        histograms = {
            n: merge_latency_snapshots(snaps)
            for n, snaps in sorted(hist_snaps.items())
        }
        trace_sec = {
            "enabled": sections[0].get("enabled", False),
            "ring": sections[0].get("ring") or {},
            "histograms": histograms,
            "events": dict(sorted(events.items())),
        }
        try:
            mine = self.plane.counters().get(self.worker_id) or {}
        except Exception:
            mine = {}
        doc: dict = {
            "process": ident,
            # This member's own lease-protocol counters — numeric, so
            # the fleet merge's counter SUM is meaningful across
            # workers (each publishes only its own row).
            "counters": {f"fleet_{k}": v for k, v in sorted(mine.items())},
            "timings": {},
            "trace": trace_sec,
            "phase_totals": {
                n: [s["total_seconds"], s["count"]]
                for n, s in histograms.items()
                if s.get("count")
            },
            "faults": FAULTS.snapshot(),
            "jobs": self._manager.snapshot(),
        }
        for name, snap in provider_snapshots().items():
            doc.setdefault(name, snap)
        trace_doc = merge_chrome_traces(traces)
        # Pin this process's lane name to the WORKER id.  The merge
        # names a lane after the first keyed export that contributed an
        # event on that pid; if the global ring happens to be empty at
        # publish time a per-job key ("w1:job-0001") would win — or no
        # lane would exist at all — and the fleet-level merge downstream
        # would lose the one-lane-per-worker invariant trace_check
        # run 5 asserts.
        pid = os.getpid()
        for ev in trace_doc["traceEvents"]:
            if (
                ev.get("ph") == "M"
                and ev.get("name") == "process_name"
                and ev.get("pid") == pid
            ):
                ev["args"] = {"name": self.worker_id}
                break
        else:
            trace_doc["traceEvents"].insert(0, {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": self.worker_id},
            })
        return doc, trace_doc

    def publish_once(self) -> str:
        """Build and crash-atomically publish this member's telemetry
        snapshot + merged trace export to ``<jobs_dir>/obs/``."""
        doc, trace_doc = self._obs_document()
        return publish_snapshot(
            self._dir, doc, worker_id=self.worker_id, trace_doc=trace_doc
        )

    # -- evidence --------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            owned = sorted(self._owned)
            polls = self._polls
        try:
            workers = self.plane.counters()
        except Exception:
            workers = {}
        return {
            "role": self.role,
            "worker_id": self.worker_id,
            "lease_s": self.lease_s,
            "heartbeat_s": self.heartbeat_s,
            "owned": owned,
            "polls": polls,
            "journal_invalid": self._tailer.invalid,
            "workers": workers,
        }


def main(argv: "list[str] | None" = None) -> int:
    """Worker-process entry point: ``python -m ksim_tpu_torch.jobs
    --dir <KSIM_JOBS_DIR> [--worker-id w1] [--workers 2] [--device cuda|cpu]``.
    Builds a worker-role JobManager (which starts the fleet poller) on
    ``--device`` (default: the card), prints ``READY <worker id>`` for
    the spawning harness, and parks until SIGTERM/SIGINT."""
    import argparse
    import signal

    from ksim_tpu_torch.cmd import add_device_argument

    parser = argparse.ArgumentParser(description="ksim-tpu fleet worker")
    parser.add_argument("--dir", required=True, help="shared KSIM_JOBS_DIR")
    parser.add_argument("--worker-id", default=f"w{os.getpid()}")
    parser.add_argument("--workers", type=int, default=None,
                        help="local pool size (default KSIM_JOBS_WORKERS)")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    from ksim_tpu_torch.jobs.manager import JobManager

    # No compilation cache to arm: the kernel libraries under build/
    # are the on-disk layer every worker process shares.
    jm = JobManager(
        workers=args.workers,
        jobs_dir=args.dir,
        role="worker",
        worker_id=args.worker_id,
        device=args.device,
    )
    if os.environ.get("KSIM_AOT_PREWARM") in ("1", "2"):
        # Both modes load the kernel libraries already on disk
        # (engine/replay.py prewarm_aot_cache never builds one), so a
        # worker's first job skips the loads: cmd/simulator.py runs the
        # same thread for the solo server.
        from ksim_tpu_torch.engine.replay import prewarm_aot_cache

        threading.Thread(target=prewarm_aot_cache, name="aot-prewarm", daemon=True).start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    print(f"READY {args.worker_id}", flush=True)
    stop.wait()
    jm.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
