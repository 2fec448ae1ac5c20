"""Per-object parse memos for the host featurization path.

Churn replay featurizes the whole cluster every scheduling pass, but most
objects are unchanged between passes: the cluster store hands out the
SAME dict object for an unchanged resource (``list(copy_objs=False)``)
and a brand-new dict on every write (create/update/patch all deepcopy
before storing, state/cluster.py).  ``id(obj)`` therefore identifies a
frozen snapshot of an object's content for as long as that object is
alive — and the memo keeps a strong reference to every key object so its
id cannot be recycled while an entry exists.

Sub-objects inherit the property: a pod's ``spec.affinity`` term dicts
are replaced together with the pod, so they are valid memo keys too.

Eviction is generational, not clear-all: entries touched recently
survive, entries untouched for a few generations are swept and their key
objects unpinned (a clear-all would force a cold re-parse of the whole
working set at once).  Note that with the incremental bound-pod
aggregation (state/boundagg.py) an unchanged bound pod's parse entries
may legitimately go untouched for many passes — its contribution lives
in the aggregate's records instead — so a sweep can evict entries for
still-live pods; the cost surfaces only as a one-pass cold re-parse on
the next full rebuild (vocabulary growth or unit rescale), which is the
same cost the rebuild itself already carries.  By convention ``key[1]``
is the pinned object's id (see ``ref_id``), which is how the sweep knows
which pins survive.

Callers that build JSON by hand (tests, library use) must not mutate an
object in place after featurizing it — mutate-and-refeaturize would see
stale parses.  The store path never does this.  ``clear()`` drops
everything.
"""

from __future__ import annotations

import collections
from typing import Any, Callable

_MISS = object()

# key -> [value, last_access_generation]; key[1] is the pinned id.
_DATA: dict[Any, list] = {}
_REFS: dict[int, Any] = {}
_GEN = 0

# Sweep trigger: ~10 slots per live pod means 512k entries ≈ 50k live
# objects — far above any benchmarked cluster, so sweeps are rare.  The
# working limit doubles whenever a sweep can't reclaim half the table
# (see maybe_flush); LIMIT is the starting point.
LIMIT = 1 << 19
_limit: "int | None" = None  # set past LIMIT when sweeps can't reclaim
# Entries untouched for this many generations are considered dead.  Live
# objects are touched every featurization; 4 covers multi-profile setups
# where alternating profiles featurize disjoint queues.
STALE_GENERATIONS = 4


def ref_id(obj: Any) -> int:
    """id(obj), pinned: the object stays alive while the memo does."""
    i = id(obj)
    if i not in _REFS:
        _REFS[i] = obj
    return i


def get(key: Any) -> Any:
    """Lookup; returns the module sentinel ``MISS`` when absent."""
    entry = _DATA.get(key)
    if entry is None:
        return _MISS
    entry[1] = _GEN
    return entry[0]


MISS = _MISS


def put(key: Any, value: Any) -> Any:
    """Store an entry.  Never evicts inline: an eviction here could unpin
    the in-flight key object (its id was taken by the caller before the
    sweep), letting the id be recycled under a surviving entry.  Size
    enforcement happens at safe points via maybe_flush()."""
    _DATA[key] = [value, _GEN]
    return value


def maybe_flush() -> None:
    """Advance the generation; sweep stale entries when over the limit.

    Called at points where no memo key is in flight (the featurizer's
    entry), so surviving entries' key objects stay pinned and swept ids
    are only unpinned when no entry references them.

    If a sweep frees little (the working set is genuinely that large),
    the limit doubles so the O(table) sweep scan stays amortized instead
    of running — and evicting nothing — on every subsequent pass."""
    global _GEN, _limit
    _GEN += 1
    limit = _limit if _limit is not None else LIMIT
    if len(_DATA) < limit:
        return
    floor = _GEN - STALE_GENERATIONS
    for key in [k for k, e in _DATA.items() if e[1] < floor]:
        del _DATA[key]
    live_ids = {k[1] for k in _DATA}
    for i in [i for i in _REFS if i not in live_ids]:
        del _REFS[i]
    if len(_DATA) > limit // 2:
        _limit = limit * 2
    elif _limit is not None and len(_DATA) < LIMIT // 2:
        _limit = None  # working set shrank back; restore the baseline


def cached(slot: str, obj: Any, fn: Callable[[], Any], *extra: Any) -> Any:
    """Memoize ``fn()`` under (slot, id(obj), *extra)."""
    key = (slot, ref_id(obj), *extra)
    hit = get(key)
    if hit is not _MISS:
        return hit
    return put(key, fn())


# Family-cache table, SEPARATE from _DATA: entries hold multi-MB arrays
# and pin a whole node list each, so the per-object memo's ~512k-entry
# sweep threshold would never trigger — a bounded LRU of a few dozen is
# the right shape (7 families x a handful of live token/node-list
# variants; anything older is dead after the next node event anyway).
_SEQ: "collections.OrderedDict[Any, Any]" = collections.OrderedDict()
_SEQ_LIMIT = 64


def cached_seq(slot: str, objs: Any, fn: Callable[[], Any], *extra: Any) -> Any:
    """Memoize ``fn()`` under (slot, tuple-of-ids(objs), *extra) — the
    family form of ``cached`` for whole-sequence builds (an encoder's
    node-side tables: identical whenever the exact same node objects and
    vocabulary token recur, which under churn is every pass without a
    node event).

    Unlike ``cached``, the entry pins its key objects ITSELF: the stored
    value carries strong references to every object in ``objs``, so none
    of their ids can be recycled while the entry lives.  (The ``key[1]``
    pin convention doesn't extend to id-tuples — a sweep would unpin
    the members and a recycled id could alias a different object into a
    stale hit.)  Eviction is LRU over a small dedicated table."""
    seq = tuple(objs)
    key = (slot, tuple(map(id, seq)), *extra)
    hit = _SEQ.get(key)
    if hit is not None:
        _SEQ.move_to_end(key)
        return hit[0]
    value = fn()
    _SEQ[key] = (value, seq)
    if len(_SEQ) > _SEQ_LIMIT:
        _SEQ.popitem(last=False)
    return value


# Token interning: per-pod memo keys embed vocabulary tokens (tuples of
# canonical strings, often hundreds of entries).  Hashing such a tuple
# on EVERY lookup is O(vocab) per pod per family; interning maps it to a
# small int once per pass so the per-pod keys hash in O(1).
_INTERN: dict[Any, int] = {}
_INTERN_NEXT = 0


def intern_token(token: Any) -> int:
    """Small stable int for a hashable token (hashed once, here).

    Reset valve: if an adversarial stream mints unbounded distinct
    tokens, the WHOLE memo resets with the intern table.  Ints come from
    a MONOTONIC counter (never restarted): callers capture interned ints
    in locals and may write memo entries with them after the valve
    fires, so a restarted numbering could hand a later token an int an
    in-flight key still embeds — aliasing a fresh lookup into a stale
    entry."""
    global _INTERN_NEXT
    i = _INTERN.get(token)
    if i is None:
        if len(_INTERN) > (1 << 16):
            _DATA.clear()
            _REFS.clear()
            _INTERN.clear()
        i = _INTERN_NEXT
        _INTERN_NEXT += 1
        _INTERN[token] = i
    return i


def clear() -> None:
    global _GEN, _limit
    _DATA.clear()
    _REFS.clear()
    _INTERN.clear()
    _SEQ.clear()
    _GEN = 0
    _limit = None


def stats() -> dict[str, int]:
    return {
        "entries": len(_DATA),
        "refs": len(_REFS),
        "generation": _GEN,
        "seq_entries": len(_SEQ),
        "interned": len(_INTERN),
    }
