"""Pod priority resolution through PriorityClass objects.

Upstream admission writes ``spec.priority`` from the pod's
``priorityClassName`` before the scheduler ever sees the pod; snapshots
taken from live clusters carry the resolved value, but hand-written or
KWOK-originated pods may only name the class.  The resolver mirrors the
admission plugin: explicit ``spec.priority`` wins, then the named class's
value, then the globalDefault class, then 0.  The built-in system classes
exist even when the snapshot omits them (upstream
scheduling.SystemCriticalPriority)."""

from __future__ import annotations

from typing import Callable, Sequence

from ksim_tpu_torch.state.resources import JSON, name_of

SYSTEM_PRIORITY_CLASSES = {
    "system-cluster-critical": 2_000_000_000,
    "system-node-critical": 2_000_001_000,
}


def build_priority_resolver(
    priority_classes: Sequence[JSON] = (),
) -> Callable[[JSON], int]:
    by_name = dict(SYSTEM_PRIORITY_CLASSES)
    default = 0
    for pc in priority_classes:
        by_name[name_of(pc)] = int(pc.get("value") or 0)
        if pc.get("globalDefault"):
            default = int(pc.get("value") or 0)

    def resolve(pod: JSON) -> int:
        spec = pod.get("spec", {})
        if spec.get("priority") is not None:
            return int(spec["priority"])
        class_name = spec.get("priorityClassName")
        if class_name:
            return by_name.get(class_name, 0)
        return default

    return resolve
