"""Sample out-of-tree lifecycle plugins: PostBind export, custom
QueueSort, and a PreEnqueue gate.

The reference fork's own sample is a PostBind plugin that POSTs every
placement to hardcoded third-party URLs from inside the scheduling path
(reference simulator/pkg/nodenumber/plugin.go:98-114 — SURVEY.md flags
the URLs as fork-specific cruft).  ``PlacementExport`` keeps the
*capability* — observe every (pod, node) bind from an out-of-tree
plugin — with a pluggable sink instead: a callable, or an append-JSONL
path from plugin args (ship it wherever you like OUTSIDE the hot path).

``FifoSort`` demonstrates a custom QueueSort replacing PrioritySort
(the reference wraps custom QueueSort plugins, wrappedplugin.go:750-765)
and ``NamePrefixGate`` a PreEnqueue gate (wrappedplugin.go:376).  All
three register through ``builderImport`` / the Builder registry like
any out-of-tree plugin (scheduler/profile.py load_plugin_import).
"""

from __future__ import annotations

import json
import threading
from typing import Callable

from ksim_tpu_torch.engine.core import ScoredPlugin
from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of


class PlacementExport:
    """PostBind observer: ``sink`` receives {"pod": ns/name, "node": n}
    per successful bind.  With ``sink_path`` the records append to a
    JSONL file (one bind per line) under a lock."""

    name = "PlacementExport"

    def __init__(
        self,
        sink: Callable[[dict], None] | None = None,
        sink_path: str | None = None,
    ) -> None:
        self._sink = sink
        self._path = sink_path
        self._lock = threading.Lock()

    def post_bind(self, pod: JSON, node_name: str) -> None:
        rec = {
            "pod": f"{namespace_of(pod)}/{name_of(pod)}",
            "node": node_name,
        }
        if self._sink is not None:
            self._sink(rec)
        if self._path:
            with self._lock, open(self._path, "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")


def _build_placement_export(feats, args):
    plug = PlacementExport(
        sink=args.get("sink") if callable(args.get("sink")) else None,
        sink_path=args.get("sinkPath"),
    )
    return ScoredPlugin(plug, filter_enabled=False, score_enabled=False)


PLACEMENT_EXPORT_PLUGIN = {"builder": _build_placement_export}


# -- custom QueueSort --------------------------------------------------------


def _fifo_key(pod: JSON, priority_of=None):
    """Strict FIFO: creation time, then name — priority ignored (the
    point: observably different from PrioritySort)."""
    return (
        pod.get("metadata", {}).get("creationTimestamp") or "",
        namespace_of(pod),
        name_of(pod),
    )


def _build_fifo(feats, args):
    class _FifoMarker:
        name = "FifoSort"

    return ScoredPlugin(_FifoMarker(), filter_enabled=False, score_enabled=False)


FIFO_SORT_PLUGIN = {"builder": _build_fifo, "queue_sort_key": _fifo_key}


# -- PreEnqueue gate ---------------------------------------------------------


GATE_PREFIX = "hold-"


def _name_prefix_gate(pod: JSON) -> str | None:
    """Pods named ``hold-*`` never enter the queue (stand-in for a real
    readiness/dependency gate)."""
    if name_of(pod).startswith(GATE_PREFIX):
        return f"pod name carries the {GATE_PREFIX!r} hold prefix"
    return None


def _build_gate(feats, args):
    class _GateMarker:
        name = "NamePrefixGate"

    return ScoredPlugin(_GateMarker(), filter_enabled=False, score_enabled=False)


NAME_PREFIX_GATE_PLUGIN = {"builder": _build_gate, "pre_enqueue": _name_prefix_gate}
