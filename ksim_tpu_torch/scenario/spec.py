"""KEP-140 Scenario documents -> runner operations.

The reference designed (but never built) a Scenario CRD whose
``spec.operations`` drive timed create/patch/delete mutations with a
``doneOperation`` terminator (reference
keps/140-scenario-based-simulation/README.md, ScenarioOperation /
CreateOperation / PatchOperation / DeleteOperation / DoneOperation).
This module accepts that document shape — as a dict, JSON, or YAML —
and lowers it to the library ``Operation`` stream:

- ``createOperation.object``  -> Operation(op="create"), kind from the
  object's ``kind``;
- ``patchOperation``          -> Operation(op="patch") carrying an
  RFC 7386 JSON merge patch (the KEP leaves PatchType open; merge patch
  is the simulator-native choice — strategic merge is an apiserver
  concept);
- ``deleteOperation``         -> Operation(op="delete");
- ``doneOperation``           -> Operation(op="done") — the runner marks
  the scenario succeeded after finishing that step and ignores later
  steps.

Exactly one of the four must be set per operation, like the KEP's
"one of the following four fields must be specified".

Since round 14 a scenario may also be SOURCED instead of enumerated:
``spec.source.trace`` names a real cluster trace (ksim_tpu/traces/) to
be parsed, resampled and compiled into the operation stream —

    spec:
      source:
        trace:
          name: borg_mini.jsonl     # registered in KSIM_TRACES_DIR
          # path: /data/trace.gz    # library/CLI only; the job plane
          #                           refuses raw paths
          format: borg              # borg | alibaba
          nodes: 64                 # synthesized node universe
          maxEvents: 5000           # resample budget (0 = no cap)
          seed: 0
          opsPerStep: 100
          sourceNodes: 4000         # optional: rescale load to nodes/

and a ``spec.faults`` section arms ``KSIM_FAULTS``-style schedules from
the document itself (the chaos-native half of the same ROADMAP item):
a mapping of injection site to schedule string, canonicalized by
``faults_spec_from_doc`` into the exact grammar ``KSIM_FAULTS`` speaks
and armed by the consumer (the job plane arms it on the job's PRIVATE
plane, sites restricted to the job-plane set — docs/jobs.md).

Exactly one of ``operations`` / ``source`` must be present.
"""

from __future__ import annotations

import json
from typing import Any, Sequence

from ksim_tpu_torch.scenario.runner import Operation
from ksim_tpu_torch.state.resources import JSON as JSONObj

# TypeMeta.kind -> store kind (the 7 snapshot kinds).
KIND_MAP = {
    "Pod": "pods",
    "Node": "nodes",
    "PersistentVolume": "persistentvolumes",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "StorageClass": "storageclasses",
    "PriorityClass": "priorityclasses",
    "Namespace": "namespaces",
}


class ScenarioSpecError(ValueError):
    """Invalid Scenario document (the KEP's 'the scenario will fail')."""


def _store_kind(type_kind: str, op_id: str) -> str:
    kind = KIND_MAP.get(type_kind)
    if kind is None:
        raise ScenarioSpecError(
            f"operation {op_id!r}: unsupported kind {type_kind!r} "
            f"(supported: {sorted(KIND_MAP)})"
        )
    return kind


def merge_patch(target: JSONObj, patch: Any) -> Any:
    """RFC 7386 JSON merge patch: dicts merge recursively, null deletes,
    everything else replaces."""
    if not isinstance(patch, dict):
        return patch
    out = dict(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k, {}), v)
    return out


def default_trace_resolver(trace_doc: JSONObj) -> str:
    """Resolve a ``source.trace`` reference to a readable path: an
    explicit ``path`` (library/CLI use), else a ``name`` looked up in
    the ``KSIM_TRACES_DIR`` registry.  The job plane substitutes a
    resolver that refuses ``path`` outright (tenants must never make
    the server read arbitrary files)."""
    from ksim_tpu_torch.traces.registry import resolve

    path = trace_doc.get("path")
    if path:
        return str(path)
    name = trace_doc.get("name")
    if not name:
        raise ScenarioSpecError("source.trace needs a name (or path)")
    return resolve(str(name))


def _operations_from_source(
    src: JSONObj, trace_resolver, *, event_bound: int = 0, node_bound: int = 0
) -> list[Operation]:
    from ksim_tpu_torch.traces.compile import TRACE_FORMATS, trace_operations
    from ksim_tpu_torch.traces.schema import TraceBoundExceeded, TraceError

    if not isinstance(src, dict) or set(src) != {"trace"}:
        raise ScenarioSpecError(
            "spec.source supports exactly one key: 'trace'"
        )
    t = src["trace"] or {}
    fmt = t.get("format")
    if fmt not in TRACE_FORMATS:
        raise ScenarioSpecError(
            f"source.trace.format must be one of {list(TRACE_FORMATS)} "
            f"(got {fmt!r})"
        )
    try:
        nodes = int(t.get("nodes", 100))
        max_events = int(t.get("maxEvents", 0))
        seed = int(t.get("seed", 0))
        ops_per_step = int(t.get("opsPerStep", 100))
        source_nodes = t.get("sourceNodes")
        source_nodes = int(source_nodes) if source_nodes is not None else None
    except (TypeError, ValueError):
        raise ScenarioSpecError(
            "source.trace nodes/maxEvents/seed/opsPerStep/sourceNodes "
            "must be integers"
        ) from None
    try:
        path = (trace_resolver or default_trace_resolver)(t)
        return trace_operations(
            path,
            fmt,
            nodes=nodes,
            max_events=max_events,
            seed=seed,
            ops_per_step=ops_per_step,
            source_nodes=source_nodes,
            event_bound=event_bound,
            node_bound=node_bound,
        )
    except TraceBoundExceeded:
        # NOT a bad document: the caller's size limit fired mid-read.
        # The jobs plane owns this vocabulary (JobLimitExceeded, HTTP
        # 413) — folding it into ScenarioSpecError would turn a quota
        # refusal into a 400.
        raise
    except TraceError as e:
        # One failure vocabulary at this surface: a bad trace reference
        # or corrupt file is a bad SCENARIO document (HTTP 400), not a
        # server error.
        raise ScenarioSpecError(str(e)) from e


def faults_spec_from_doc(doc: JSONObj) -> str:
    """Canonicalize ``spec.faults`` — a mapping of injection site to
    ``KSIM_FAULTS`` schedule string (``call:N``/``first:K``/``always``/
    ``p:P[:SEED]``/``hang:T[:K]``, optional ``@error``) — into the
    comma-joined ``site=schedule`` grammar the fault plane's
    ``configure`` speaks.  Returns ``""`` when the document arms
    nothing.  Validation of schedules (and of WHICH sites a consumer
    may arm) stays with the consumer: the job plane restricts sites to
    its own set and lets ``FaultPlane.configure`` reject malformed
    schedules loudly."""
    spec = doc.get("spec") or doc
    faults = spec.get("faults")
    if faults is None:
        return ""
    if not isinstance(faults, dict) or not all(
        isinstance(k, str) and isinstance(v, str) and k and v
        for k, v in faults.items()
    ):
        raise ScenarioSpecError(
            "spec.faults must map injection sites to schedule strings "
            '(e.g. {"replay.dispatch": "call:2@device"})'
        )
    for site, sched in faults.items():
        if "=" in site or "," in site or ";" in site:
            raise ScenarioSpecError(f"spec.faults site {site!r} is malformed")
        # The schedule value must be ONE schedule: an embedded separator
        # would smuggle extra `site=schedule` entries past the caller's
        # site allowlist once FaultPlane.configure re-splits the string.
        if "," in sched or ";" in sched:
            raise ScenarioSpecError(
                f"spec.faults schedule {sched!r} for {site!r} is malformed "
                "(one schedule per site; no ','/';')"
            )
    return ",".join(f"{site}={sched}" for site, sched in sorted(faults.items()))


def operations_from_spec(
    doc: JSONObj, *, trace_resolver=None, event_bound: int = 0, node_bound: int = 0
) -> list[Operation]:
    """Lower a Scenario document (or bare ``{"operations": [...]}``) to
    the runner's Operation list, sorted by step (stable within a step,
    like the KEP's per-MajorStep batches).  A document may instead
    carry ``spec.source.trace`` (exactly one of the two): the named
    trace is ingested through ``trace_resolver`` (default: explicit
    path, else the ``KSIM_TRACES_DIR`` registry).

    ``event_bound``/``node_bound`` (0 = unbounded) arm the trace-ingest
    plane's EARLY size refusal: ingestion raises ``TraceBoundExceeded``
    — deliberately NOT mapped onto ``ScenarioSpecError`` — the moment
    the compiled size provably passes the bound, so the caller (the
    jobs plane) refuses mid-read instead of after full parse+compile.
    Inline ``spec.operations`` documents are unaffected (the caller
    checks their materialized size as before)."""
    spec = doc.get("spec") or doc
    raw_ops = spec.get("operations")
    source = spec.get("source")
    if source is not None:
        if raw_ops is not None:
            raise ScenarioSpecError(
                "document has both spec.operations and spec.source — "
                "exactly one must be present"
            )
        return _operations_from_source(
            source, trace_resolver, event_bound=event_bound, node_bound=node_bound
        )
    if raw_ops is None:
        raise ScenarioSpecError("document has no spec.operations")
    out: list[Operation] = []
    for i, rop in enumerate(raw_ops):
        op_id = str(rop.get("id") or i)
        step = int(rop.get("step", 0))
        # Key-present counts as set even with a null body: doneOperation
        # is naturally empty ("doneOperation:" in YAML parses to None).
        bodies = {
            k: rop[k] or {}
            for k in ("createOperation", "patchOperation", "deleteOperation", "doneOperation")
            if k in rop
        }
        if len(bodies) != 1:
            raise ScenarioSpecError(
                f"operation {op_id!r}: exactly one of createOperation/"
                f"patchOperation/deleteOperation/doneOperation must be set "
                f"(got {sorted(bodies) or 'none'})"
            )
        key, body = next(iter(bodies.items()))
        if key == "createOperation":
            obj = body.get("object")
            if not isinstance(obj, dict) or not obj.get("kind"):
                raise ScenarioSpecError(
                    f"operation {op_id!r}: createOperation.object needs a kind"
                )
            out.append(
                Operation(step=step, op="create", kind=_store_kind(obj["kind"], op_id), obj=obj)
            )
        elif key == "patchOperation":
            kind = _store_kind((body.get("typeMeta") or {}).get("kind", ""), op_id)
            meta = body.get("objectMeta") or {}
            patch = body.get("patch")
            if isinstance(patch, (str, bytes)):
                patch = json.loads(patch)
            out.append(
                Operation(
                    step=step,
                    op="patch",
                    kind=kind,
                    obj=patch,
                    name=meta.get("name", ""),
                    namespace=meta.get("namespace", ""),
                )
            )
        elif key == "deleteOperation":
            kind = _store_kind((body.get("typeMeta") or {}).get("kind", ""), op_id)
            meta = body.get("objectMeta") or {}
            out.append(
                Operation(
                    step=step,
                    op="delete",
                    kind=kind,
                    name=meta.get("name", ""),
                    namespace=meta.get("namespace", ""),
                )
            )
        else:  # doneOperation
            out.append(Operation(step=step, op="done", kind=""))
    out.sort(key=lambda o: o.step)
    return out


#: store kind -> TypeMeta.kind (the inverse of KIND_MAP, for raising
#: Operation streams back into Scenario documents).
TYPE_META_KIND = {v: k for k, v in KIND_MAP.items()}


def spec_from_operations(ops: "Sequence[Operation]") -> JSONObj:
    """Raise a runner ``Operation`` stream back into the KEP-140
    Scenario document shape — the inverse of ``operations_from_spec``
    (round-trip: ``operations_from_spec(spec_from_operations(ops)) ==
    list(ops)`` for in-vocabulary streams).  This is how library
    streams (``churn_scenario``) are SUBMITTED to the tenant job plane,
    whose wire format is documents, not Operation objects."""
    out: list[JSONObj] = []
    for op in ops:
        entry: JSONObj = {"step": op.step}
        if op.op == "create":
            obj = dict(op.obj or {})
            obj.setdefault("kind", TYPE_META_KIND.get(op.kind, ""))
            entry["createOperation"] = {"object": obj}
        elif op.op == "delete":
            entry["deleteOperation"] = {
                "typeMeta": {"kind": TYPE_META_KIND.get(op.kind, "")},
                "objectMeta": {"name": op.name, "namespace": op.namespace},
            }
        elif op.op == "patch":
            entry["patchOperation"] = {
                "typeMeta": {"kind": TYPE_META_KIND.get(op.kind, "")},
                "objectMeta": {"name": op.name, "namespace": op.namespace},
                "patch": op.obj,
            }
        elif op.op == "done":
            entry["doneOperation"] = {}
        else:
            raise ScenarioSpecError(f"operation {op.op!r} has no document form")
        out.append(entry)
    return {"operations": out}


def load_scenario(text_or_doc: "str | bytes | JSONObj") -> list[Operation]:
    """Parse a Scenario document from YAML/JSON text (or an already-parsed
    dict) into runner operations."""
    if isinstance(text_or_doc, (str, bytes)):
        import yaml

        doc = yaml.safe_load(text_or_doc)
    else:
        doc = text_or_doc
    if not isinstance(doc, dict):
        raise ScenarioSpecError("scenario document must be a mapping")
    return operations_from_spec(doc)
