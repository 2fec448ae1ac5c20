"""Churn-scenario generator: BASELINE config 5.

"50k scheduling events, rolling arrivals + node preemption over 2k
nodes" — a reproducible operation stream: initial node fleet, then steps
mixing pod arrivals (with the same taint/affinity/spread feature mix as
tests.helpers.random_cluster), pod completions, and rolling node
drain/replace (delete + create, the "node preemption" churn).

A copy of ``ksim_tpu/scenario/generate.py`` with the two object builders
of ``tests/helpers.py`` it uses (``make_node``, ``make_pod``) kept here,
so the stream is the reference's operation for operation.
"""

from __future__ import annotations

import random
from typing import Iterator

from ksim_tpu_torch.scenario.runner import Operation
from ksim_tpu_torch.state.resources import JSON


def make_node(
    name: str,
    cpu: str = "4",
    memory: str = "16Gi",
    pods: int = 110,
    *,
    labels: dict[str, str] | None = None,
    taints: list[JSON] | None = None,
    unschedulable: bool = False,
    extra_alloc: dict[str, str] | None = None,
) -> JSON:
    alloc = {"cpu": cpu, "memory": memory, "pods": str(pods), "ephemeral-storage": "100Gi"}
    alloc.update(extra_alloc or {})
    spec: JSON = {}
    if taints:
        spec["taints"] = taints
    if unschedulable:
        spec["unschedulable"] = True
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": labels or {}},
        "spec": spec,
        "status": {"allocatable": dict(alloc), "capacity": dict(alloc)},
    }


def make_pod(
    name: str,
    cpu: str | None = "100m",
    memory: str | None = "128Mi",
    *,
    namespace: str = "default",
    node_name: str = "",
    labels: dict[str, str] | None = None,
    phase: str = "",
    tolerations: list[JSON] | None = None,
    affinity: JSON | None = None,
    node_selector: dict[str, str] | None = None,
    topology_spread_constraints: list[JSON] | None = None,
    priority: int | None = None,
    extra_requests: dict[str, str] | None = None,
) -> JSON:
    requests: JSON = {}
    if cpu is not None:
        requests["cpu"] = cpu
    if memory is not None:
        requests["memory"] = memory
    requests.update(extra_requests or {})
    spec: JSON = {
        "containers": [
            {"name": "c", "image": "img", "resources": {"requests": requests} if requests else {}}
        ]
    }
    if node_name:
        spec["nodeName"] = node_name
    if tolerations:
        spec["tolerations"] = tolerations
    if affinity:
        spec["affinity"] = affinity
    if node_selector:
        spec["nodeSelector"] = node_selector
    if topology_spread_constraints:
        spec["topologySpreadConstraints"] = topology_spread_constraints
    if priority is not None:
        spec["priority"] = priority
    status: JSON = {"phase": phase} if phase else {}
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": namespace, "labels": labels or {}},
        "spec": spec,
        "status": status,
    }


def _mk_node(rng: random.Random, name: str) -> JSON:
    zones = ["zone-a", "zone-b", "zone-c"]
    return make_node(
        name,
        cpu=f"{rng.choice([4, 8, 16, 32])}",
        memory=f"{rng.choice([8, 16, 32, 64])}Gi",
        pods=rng.choice([32, 64, 110]),
        labels={
            "topology.kubernetes.io/zone": rng.choice(zones),
            "kubernetes.io/hostname": name,
            "disktype": rng.choice(["ssd", "hdd"]),
        },
    )


def _mk_pod(rng: random.Random, name: str) -> JSON:
    app = rng.choice(["web", "db", "cache", "batch"])
    spread = None
    if rng.random() < 0.2:
        spread = [{
            "maxSkew": rng.choice([1, 2]),
            "topologyKey": rng.choice(
                ["topology.kubernetes.io/zone", "kubernetes.io/hostname"]
            ),
            "whenUnsatisfiable": rng.choice(["DoNotSchedule", "ScheduleAnyway"]),
            "labelSelector": {"matchLabels": {"app": app}},
        }]
    affinity = None
    if rng.random() < 0.1:
        term = {
            "labelSelector": {"matchLabels": {"app": rng.choice(["web", "db"])}},
            "topologyKey": "topology.kubernetes.io/zone",
        }
        if rng.random() < 0.5:
            affinity = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [term]}}
        else:
            affinity = {"podAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": rng.choice([1, 50, 100]), "podAffinityTerm": term}
                ]}}
    return make_pod(
        name,
        cpu=rng.choice(["100m", "250m", "500m", "1", "2"]),
        memory=rng.choice(["128Mi", "512Mi", "1Gi", "2Gi"]),
        labels={"app": app},
        topology_spread_constraints=spread,
        affinity=affinity,
    )


def churn_scenario(
    seed: int,
    *,
    n_nodes: int = 2000,
    n_events: int = 50_000,
    ops_per_step: int = 100,
    pod_create_frac: float = 0.65,
    pod_delete_frac: float = 0.25,
) -> Iterator[Operation]:
    """Yield the node bootstrap (step 0) then churn steps.  Event mix:
    ``pod_create_frac`` arrivals, ``pod_delete_frac`` completions of
    previously-bound pods, remainder node drain/replace pairs."""
    rng = random.Random(seed)
    pod_seq = 0
    node_seq = n_nodes
    live_pods: list[str] = []
    live_nodes = [f"node-{i}" for i in range(n_nodes)]

    for name in live_nodes:
        yield Operation(step=0, op="create", kind="nodes", obj=_mk_node(rng, name))

    emitted = n_nodes
    step = 1
    while emitted < n_events:
        budget = min(ops_per_step, n_events - emitted)
        for _ in range(budget):
            r = rng.random()
            if r < pod_create_frac or not live_pods:
                name = f"pod-{pod_seq}"
                pod_seq += 1
                live_pods.append(name)
                yield Operation(
                    step=step, op="create", kind="pods", obj=_mk_pod(rng, name)
                )
            elif r < pod_create_frac + pod_delete_frac:
                victim = live_pods.pop(rng.randrange(len(live_pods)))
                yield Operation(
                    step=step, op="delete", kind="pods",
                    name=victim, namespace="default",
                )
            else:
                # Rolling node preemption: drain one node, add a fresh one.
                gone = live_nodes.pop(rng.randrange(len(live_nodes)))
                yield Operation(step=step, op="delete", kind="nodes", name=gone)
                fresh = f"node-{node_seq}"
                node_seq += 1
                live_nodes.append(fresh)
                yield Operation(
                    step=step, op="create", kind="nodes", obj=_mk_node(rng, fresh)
                )
        emitted += budget
        step += 1
