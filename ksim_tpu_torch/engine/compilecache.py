"""Process-wide cache evidence + first-launch gate for kernel launches.

The port of ``ksim_tpu/engine/compilecache.py`` (stdlib only), cut to
the in-memory layer the port exercises.  In the reference it fronts
jax's jit cache; here it fronts the first launch of kernel D per shape
rung.  Two layers:

- **In memory** (``run``): a process-global registry keyed by the rung
  (engine/replay.py ``_compile_cache_key``: the program kind, the
  segment statics, the profile signature, the exact mode and the
  dtype/shape signature of every input tensor).  It counts ``hits`` and
  ``misses`` per rung, records which OWNERS used each rung, and
  serializes the FIRST launch of a rung: one leader runs it, concurrent
  same-rung callers wait (bounded) for it.  On a CUDA card that first
  launch is what loads the kernel's library, sets its shared-memory
  attribute and asks the occupancy query.  A leader that raises removes
  its entry (``aborts``), so the next caller leads instead of waiting
  behind a tombstone.
- **On disk**: the hashed library ``kernels/build.py`` writes under
  ``build/ksim_tpu_torch/`` (``<source>-<hash>.so``).  Kernel D's code
  does not depend on the rung: every shape is a runtime parameter of one
  library per source, so there is no per-rung executable to serialize
  and the reference's on-disk executable layer (``_AotDiskSpec``) has no
  counterpart here.  The prewarm (engine/replay.py
  ``prewarm_aot_cache``) loads, never builds, every source whose hashed
  library already exists, and counts them in ``disk_prewarmed``.

Nothing here imports torch.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from ksim_tpu_torch.obs import register_provider

__all__ = ["CompileCache", "COMPILE_CACHE"]

#: Bound on the follower wait for a leader's in-flight first launch.
#: The replay watchdog (KSIM_REPLAY_WATCHDOG_S, default 300 s) covers
#: the same window from the dispatch side, so a stuck leader degrades
#: through the device_error ladder instead of wedging followers forever.
_WAIT_DEFAULT_S = 300.0


class _Entry:
    """One shape rung's state: the leader-compiled gate + per-key
    evidence.  Mutated only under the owning cache's lock (the ready
    Event is the one cross-thread signal and is safe bare)."""

    __slots__ = ("ready", "hits", "owners")

    def __init__(self) -> None:
        self.ready = threading.Event()
        self.hits = 0
        self.owners: set = set()


class CompileCache:
    """Counting, first-launch-serializing front of the kernel launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[Any, _Entry] = {}  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.waits = 0  # guarded-by: _lock (followers that blocked on a leader)
        self.aborts = 0  # guarded-by: _lock (leader dispatches that raised)
        self.disk_prewarmed = 0  # guarded-by: _lock (libraries the prewarm loaded)

    def run(
        self,
        key: Any,
        fn: Callable[[], Any],
        *,
        owner: "str | None" = None,
        wait_s: float = _WAIT_DEFAULT_S,
    ) -> Any:
        """Run ``fn`` (one dispatch's launch) under the first-launch gate.

        The first caller of ``key`` is the LEADER: it counts a miss and
        runs ``fn`` directly.  Every later caller counts a hit; if the
        leader's first call is still in flight it waits (up to
        ``wait_s``) before running its own, so a rung's first launch
        happens once no matter how many callers race onto it.  A leader
        that raises removes the entry and re-raises — the next caller
        becomes the new leader (counted in ``aborts``)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = self._entries[key] = _Entry()
                if owner is not None:
                    ent.owners.add(owner)
                self.misses += 1
                leader = True
            else:
                ent.hits += 1
                if owner is not None:
                    ent.owners.add(owner)
                self.hits += 1
                leader = False
            ready = ent.ready
        if leader:
            try:
                out = fn()
            except BaseException:
                with self._lock:
                    self.aborts += 1
                    self._entries.pop(key, None)
                # Wake any followers parked on this generation; they
                # launch themselves.
                ready.set()
                raise
            ready.set()
            return out
        if not ready.is_set():
            with self._lock:
                self.waits += 1
            ready.wait(wait_s)
        return fn()

    def note_prewarmed(self, n: int) -> None:
        """Count ``n`` libraries loaded by the prewarm (engine/replay.py
        ``prewarm_aot_cache``) — evidence only; the libraries themselves
        live with kernels/build.py."""
        with self._lock:
            self.disk_prewarmed += n

    def snapshot(self) -> dict:
        """JSON-ready evidence (the ``compile_cache`` section of
        /api/v1/metrics and the bench JSON): aggregate counters plus
        the cross-tenant sharing proof — ``shared_rungs`` = keys used
        by >= 2 distinct owners, ``shared_single_compile_rungs`` = the
        subset that also compiled exactly once (present entries never
        re-miss; an aborted leader removes its key, so every LIVE
        entry's compile count is exactly 1)."""
        with self._lock:
            rungs = len(self._entries)
            shared = sum(1 for e in self._entries.values() if len(e.owners) >= 2)
            shared_hot = sum(
                1
                for e in self._entries.values()
                if len(e.owners) >= 2 and e.hits > 0
            )
            max_owners = max(
                (len(e.owners) for e in self._entries.values()), default=0
            )
            return {
                "hits": self.hits,
                "misses": self.misses,
                "waits": self.waits,
                "aborts": self.aborts,
                "disk_prewarmed": self.disk_prewarmed,
                "rungs": rungs,
                "shared_rungs": shared,
                "shared_single_compile_rungs": shared_hot,
                "max_owners_per_rung": max_owners,
            }

    def reset(self) -> None:
        """Drop entries and counters (tests; bench children start cold
        by construction — fresh process — so production never calls
        this)."""
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0
            self.waits = 0
            self.aborts = 0
            self.disk_prewarmed = 0


#: The process-wide cache every segment dispatch consults — one compile
#: per shape rung regardless of how many runners/tenants share the
#: process.  engine/replay.py owns the key construction.
COMPILE_CACHE = CompileCache()

# Self-register as a /api/v1/metrics evidence provider: any process
# that imports this module (the replay executor, the HTTP server)
# serves the rung counters live.  obs is stdlib-only like this module,
# and never imports back — no cycle.
register_provider("compile_cache", COMPILE_CACHE.snapshot)
