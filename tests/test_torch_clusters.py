"""Cluster builders for the port's tests and chip_smoke.py (stdlib only:
no jax, no ksim_tpu), with checks that each exercises what it is for.

Imported as ``test_torch_clusters``, with tests/ on sys.path (pytest puts
it there; chip_smoke.py does it itself): the card's machine can carry an
unrelated ``tests`` package that shadows this directory as a package."""

from __future__ import annotations

import random

from helpers import make_node, make_pod, random_cluster

MB = 1024 * 1024

# (names, size in MB): tagged, untagged (normalized to :latest) and
# digest-less repo names; sizes on both sides of the 23MB / 1000MB
# thresholds of ImageLocality.
_IMAGES = (
    (["repo/app:v1"], 500),
    (["repo/side"], 100),
    (["repo/db:13", "mirror/db:13"], 1200),
    (["repo/tiny:1"], 5),
    (["repo/ml:2"], 777),
    (["repo/cache:7"], 333),
)


def images_ports_cluster(seed: int, n_nodes: int = 24, n_pods: int = 48):
    """A random cluster whose nodes report images (status.images) and
    whose queue and bound pods run several images and want host ports."""
    rng = random.Random(seed)
    nodes, pods = random_cluster(seed, n_nodes, n_pods)
    for node in nodes:
        imgs = rng.sample(_IMAGES, rng.randint(0, len(_IMAGES)))
        node["status"]["images"] = [
            {"names": list(names), "sizeBytes": size * MB} for names, size in imgs
        ]
    pool = [names[0] for names, _ in _IMAGES] + ["repo/absent:1"]
    for pod in pods:
        containers = []
        for c in range(rng.randint(1, 3)):
            ctr = {"name": f"c{c}", "image": rng.choice(pool), "resources": {}}
            if c == 0:
                ctr["resources"] = pod["spec"]["containers"][0].get("resources", {})
            if rng.random() < 0.3:
                port = {"hostPort": rng.choice([8080, 9090]), "containerPort": 80}
                if rng.random() < 0.3:
                    port["protocol"] = "UDP"
                if rng.random() < 0.3:
                    port["hostIP"] = rng.choice(["10.0.0.1", "10.0.0.2"])
                ctr["ports"] = [port]
            containers.append(ctr)
        pod["spec"]["containers"] = containers
    return nodes, pods


def unschedulable_heavy_cluster(seed: int, n_nodes: int = 24, n_pods: int = 48):
    """Most nodes cordoned, few tolerations, small nodes: most pods find
    no feasible node, and the ones placed exhaust what is left."""
    nodes, pods = random_cluster(seed, n_nodes, n_pods, unschedulable_fraction=0.8)
    for i, node in enumerate(nodes):
        node["status"]["allocatable"]["cpu"] = "1"
        node["status"]["allocatable"]["pods"] = str(1 + i % 3)
    return nodes, pods


def ports_commit_cluster():
    """tests/test_extras_plugins.py's NodePorts case: q1 conflicts on node
    a and lands on b; q2 then conflicts on both (the carry commit)."""

    def with_ports(pod, ports):
        pod["spec"]["containers"][0]["ports"] = ports
        return pod

    nodes = [make_node("a"), make_node("b")]
    bound = with_ports(make_pod("existing", node_name="a"), [{"hostPort": 8080, "protocol": "TCP"}])
    q1 = with_ports(make_pod("q1"), [{"hostPort": 8080}])
    q2 = with_ports(make_pod("q2"), [{"hostPort": 8080}])
    return nodes, [bound, q1, q2]


CLUSTERS = {
    "seed0": lambda: random_cluster(0, 40, 64),
    "seed1": lambda: random_cluster(1, 33, 50),
    "seed2": lambda: random_cluster(2, 17, 30, bound_fraction=0.6),
    "images_ports": lambda: images_ports_cluster(3),
    "unschedulable": lambda: unschedulable_heavy_cluster(4),
    "ports_commit": ports_commit_cluster,
}


def test_images_ports_cluster_has_images_and_host_ports():
    nodes, pods = images_ports_cluster(3)
    assert sum(len(n["status"]["images"]) for n in nodes) > len(nodes)
    ports = [c for p in pods for c in p["spec"]["containers"] if c.get("ports")]
    assert ports and any(p["spec"].get("nodeName") for p in pods)
    assert any(len(p["spec"]["containers"]) == 3 for p in pods)


def test_clusters_are_reproducible():
    for build in CLUSTERS.values():
        assert build() == build()
