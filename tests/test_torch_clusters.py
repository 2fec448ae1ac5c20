"""Cluster builders for the port's tests and chip_smoke.py (no jax, no
ksim_tpu), with checks that each exercises what it is for, and the hooked
profiles of the staged route.

Imported as ``test_torch_clusters``, with tests/ on sys.path (pytest puts
it there; chip_smoke.py does it itself): the card's machine can carry an
unrelated ``tests`` package that shadows this directory as a package."""

from __future__ import annotations

import random

import numpy as np

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


ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def spread_affinity_cluster(seed: int, n_nodes: int = 30, n_pods: int = 60):
    """A random cluster heavy in topology spread and pod (anti-)affinity:
    a rack key with many multi-node domains, nodes missing the zone key,
    up to three spread constraints per pod (minDomains, the Honor
    inclusion policies, matchLabelKeys) and namespace selectors."""
    rng = random.Random(seed)
    nodes, pods = random_cluster(seed, n_nodes, n_pods, bound_fraction=0.4, pod_affinity_fraction=0.6)
    for i, node in enumerate(nodes):
        labels = node["metadata"]["labels"]
        labels["rack"] = f"rack-{i // 2}"
        if rng.random() < 0.1:
            del labels[ZONE]
    namespaces = ["default", "team-a", "team-b"]
    for pod in pods:
        pod["metadata"]["namespace"] = rng.choice(namespaces)
        pod["metadata"]["labels"]["tier"] = rng.choice(["front", "back"])
        if rng.random() < 0.5:
            continue
        app = pod["metadata"]["labels"]["app"]
        cons = []
        for _ in range(rng.randint(1, 3)):
            con = {
                "maxSkew": rng.choice([1, 2, 3]),
                "topologyKey": rng.choice([ZONE, HOST, "rack"]),
                "whenUnsatisfiable": rng.choice(["DoNotSchedule", "ScheduleAnyway"]),
                "labelSelector": {"matchLabels": {"app": app}},
            }
            if rng.random() < 0.3:
                con["minDomains"] = rng.choice([2, 4])
                con["whenUnsatisfiable"] = "DoNotSchedule"
            if rng.random() < 0.3:
                con["nodeAffinityPolicy"] = rng.choice(["Honor", "Ignore"])
            if rng.random() < 0.3:
                con["nodeTaintsPolicy"] = rng.choice(["Honor", "Ignore"])
            if rng.random() < 0.2:
                con["matchLabelKeys"] = ["tier"]
            cons.append(con)
        pod["spec"]["topologySpreadConstraints"] = cons
        aff = pod["spec"].get("affinity") or {}
        for kind in ("podAffinity", "podAntiAffinity"):
            for term in (aff.get(kind) or {}).get("requiredDuringSchedulingIgnoredDuringExecution", []):
                if rng.random() < 0.3:
                    term["namespaceSelector"] = {"matchLabels": {"team": rng.choice(["a", "b"])}}
    ns_objs = [
        {"metadata": {"name": "team-a", "labels": {"team": "a"}}},
        {"metadata": {"name": "team-b", "labels": {"team": "b"}}},
        {"metadata": {"name": "default", "labels": {}}},
    ]
    return nodes, pods, {"namespaces": ns_objs}


def _pvc(name, *, volume_name="", sc="", modes=("ReadWriteOnce",)):
    return {
        "apiVersion": "v1", "kind": "PersistentVolumeClaim",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"accessModes": list(modes), "storageClassName": sc, "volumeName": volume_name,
                 "resources": {"requests": {"storage": "1Gi"}}},
    }


def _pv(name, *, zone=None, affinity_zone=None, sc="", phase="Available", driver=None):
    pv = {
        "apiVersion": "v1", "kind": "PersistentVolume",
        "metadata": {"name": name, "labels": {}},
        "spec": {"capacity": {"storage": "10Gi"}, "accessModes": ["ReadWriteOnce"], "storageClassName": sc},
        "status": {"phase": phase},
    }
    if zone:
        pv["metadata"]["labels"][ZONE] = zone
    if affinity_zone:
        pv["spec"]["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
            {"matchExpressions": [{"key": ZONE, "operator": "In", "values": [affinity_zone]}]}
        ]}}
    if driver:
        pv["spec"]["csi"] = {"driver": driver, "volumeHandle": name}
    return pv


def volume_cluster(seed: int, n_nodes: int = 16, n_pods: int = 40):
    """tests/test_volumes.py's scenarios in one random cluster: bound PVs
    with node affinity and zone labels, WFFC claims with and without a
    provisioner, unbound Immediate and missing claims, CSI attach limits
    that fill up across commits, ReadWriteOncePod claims and GCE disks
    shared read-only or conflicting read-write."""
    rng = random.Random(seed)
    zones = ["a", "b", "c"]
    nodes = [
        make_node(f"node-{i}", labels={ZONE: zones[i % 3], HOST: f"node-{i}"},
                  extra_alloc={"attachable-volumes-csi-d": str(rng.choice([1, 2, 3]))})
        for i in range(n_nodes)
    ]
    scs = [
        {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass", "metadata": {"name": "dyn"},
         "provisioner": "d", "volumeBindingMode": "WaitForFirstConsumer"},
        {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass", "metadata": {"name": "local"},
         "provisioner": "kubernetes.io/no-provisioner", "volumeBindingMode": "WaitForFirstConsumer"},
    ]
    pvs, pvcs = [], []
    for i in range(12):  # bound CSI volumes, zone-pinned by affinity or label
        z = rng.choice(zones)
        pvs.append(_pv(f"pv-b{i}", sc="dyn", phase="Bound", driver="d",
                       **({"affinity_zone": z} if i % 2 else {"zone": z})))
        pvcs.append(_pvc(f"c-b{i}", volume_name=f"pv-b{i}", sc="dyn"))
    for i in range(4):  # static local candidates for WFFC claims
        pvs.append(_pv(f"pv-l{i}", sc="local", affinity_zone=zones[i % 3]))
        pvcs.append(_pvc(f"c-l{i}", sc="local"))
    for i in range(3):
        pvcs.append(_pvc(f"c-d{i}", sc="dyn"))  # dynamically provisioned
    pvcs.append(_pvc("c-imm"))  # no class: Immediate, unbound
    for i in range(3):
        pvcs.append(_pvc(f"c-rwop{i}", modes=("ReadWriteOncePod",)))
    claims = [c["metadata"]["name"] for c in pvcs] + ["c-missing"]
    pods = []
    for i in range(n_pods):
        bound = rng.random() < 0.3
        pod = make_pod(f"pod-{i}", cpu=rng.choice(["100m", "500m"]), memory="128Mi",
                       node_name=f"node-{rng.randrange(n_nodes)}" if bound else "")
        vols = []
        for k in range(rng.randint(0, 2)):
            claim = rng.choice(claims[:-2] if bound else claims)
            vols.append({"name": f"v{k}", "persistentVolumeClaim": {"claimName": claim}})
        if rng.random() < 0.3:
            vols.append({"name": "disk", "gcePersistentDisk": {
                "pdName": rng.choice(["disk-1", "disk-2"]), "readOnly": rng.random() < 0.5}})
        if vols:
            pod["spec"]["volumes"] = vols
        pods.append(pod)
    return nodes, pods, {"pvs": pvs, "pvcs": pvcs, "storage_classes": scs}


# The widths of wide_cluster: past every table size the kernels once held
# at a fixed width (9 score resources, 17 shape points, 17 attach pools, 17
# spread topology keys, 9 constraints on one pod).
WIDE_RESOURCES = tuple(f"example.com/r{i}" for i in range(6))
WIDE_POOLS = 17
WIDE_KEYS = 17
WIDE_CONSTRAINTS = 9


def wide_cluster(seed: int, n_nodes: int = 16, n_pods: int = 40):
    """A random cluster wide in every profile table: six extended
    resources, 17 CSI attach pools (plus the legacy aws-ebs and gce-pd
    pools) that bound pods' volumes fill, 17 topology label keys (the even
    ones one domain per node, the odd ones a few shared domains, some
    nodes missing some keys) over which the queue's spread constraints
    range, pod-0 carrying 9 of them."""
    rng = random.Random(seed)
    nodes, pods = random_cluster(seed, n_nodes, n_pods, bound_fraction=0.3)
    for i, node in enumerate(nodes):
        alloc = node["status"]["allocatable"]
        for r in WIDE_RESOURCES:
            alloc[r] = str(rng.choice([4, 8, 16, 64]))
        for k in range(WIDE_POOLS):
            alloc[f"attachable-volumes-csi-d{k}"] = str(rng.choice([1, 2, 3]))
        alloc["attachable-volumes-aws-ebs"] = str(rng.choice([1, 2]))
        alloc["attachable-volumes-gce-pd"] = str(rng.choice([1, 2]))
        node["status"]["capacity"] = dict(alloc)
        labels = node["metadata"]["labels"]
        for k in range(WIDE_KEYS):
            if rng.random() < 0.1:
                continue
            labels[f"k{k}"] = node["metadata"]["name"] if k % 2 == 0 else f"d{rng.randrange(3)}"
    pvs, pvcs = [], []
    for k in range(WIDE_POOLS):
        for v in range(2):
            name = f"pv-{k}-{v}"
            pvs.append(_pv(name, sc="csi", phase="Bound", driver=f"d{k}"))
            pvcs.append(_pvc(f"c-{k}-{v}", volume_name=name, sc="csi"))
    claims = [c["metadata"]["name"] for c in pvcs]
    for i, pod in enumerate(pods):
        req = pod["spec"]["containers"][0]["resources"].setdefault("requests", {})
        for r in rng.sample(WIDE_RESOURCES, rng.randint(0, 3)):
            req[r] = str(rng.choice([1, 2, 4]))
        n_con = WIDE_CONSTRAINTS if i == 0 else rng.randint(0, 3)
        app = pod["metadata"]["labels"].get("app", "web")
        cons = []
        for c in range(n_con):
            key = f"k{(i + 3 * c) % WIDE_KEYS}"
            cons.append({
                "maxSkew": rng.choice([1, 2]),
                "topologyKey": key,
                "whenUnsatisfiable": rng.choice(["DoNotSchedule", "ScheduleAnyway"]),
                "labelSelector": {"matchLabels": {"app": app}},
            })
        if cons:
            pod["spec"]["topologySpreadConstraints"] = cons
        else:
            pod["spec"].pop("topologySpreadConstraints", None)
        vols = []
        for v in range(rng.choice([0, 0, 1, 2])):
            vols.append({"name": f"v{v}", "persistentVolumeClaim": {"claimName": rng.choice(claims)}})
        if rng.random() < 0.2:
            vols.append({"name": "ebs", "awsElasticBlockStore": {"volumeID": f"vol-{rng.randrange(3)}"}})
        if rng.random() < 0.2:
            vols.append({"name": "pd", "gcePersistentDisk": {"pdName": f"pd-{rng.randrange(3)}",
                                                             "readOnly": rng.random() < 0.5}})
        if vols:
            pod["spec"]["volumes"] = vols
    return nodes, pods, {"pvs": pvs, "pvcs": pvcs, "storage_classes": [_sc("csi", provisioner="d0")]}


# Nine resources to score: the base three and the six extended ones; 17
# strictly increasing utilization points, scores 0..10.
WIDE_NINE = ("cpu", "memory", "ephemeral-storage") + WIDE_RESOURCES
WIDE_SHAPE = tuple((6 * i, (i * 7) % 11) for i in range(17))
# One profile table widened each (on wide_cluster, whose snapshot widens
# the pools, keys and constraints), and "all": every table at once with
# the legacy instances.
WIDE_CASES = ("fit_resources", "fit_shape", "balanced_resources", "volume_pools", "spread_keys",
              "spread_constraints", "legacy_volume_limits", "all")
# "all" as a KubeSchedulerConfiguration (the service's profile compiler).
WIDE_CONFIG = {"profiles": [{
    "plugins": {"multiPoint": {"enabled": [{"name": "EBSLimits"}, {"name": "GCEPDLimits"}]}},
    "pluginConfig": [
        {"name": "NodeResourcesFit", "args": {"scoringStrategy": {
            "type": "RequestedToCapacityRatio",
            "resources": [{"name": r, "weight": w + 1} for w, r in enumerate(WIDE_NINE)],
            "requestedToCapacityRatio": {"shape": [{"utilization": u, "score": s} for u, s in WIDE_SHAPE]},
        }}},
        {"name": "NodeResourcesBalancedAllocation", "args": {"resources": [{"name": r} for r in WIDE_NINE]}},
    ],
}]}


def wide_profile(case: str, feats, core, res, vol, defaults) -> tuple:
    """The default profile of one package (ksim_tpu's or the port's: its
    engine.core, plugins.noderesources and plugins.volumes modules and its
    default_plugins), widened for ``case`` (WIDE_CASES)."""
    plugins = list(defaults(feats))
    names = [sp.plugin.name for sp in plugins]
    every = case == "all"
    if case in ("fit_resources", "fit_shape") or every:
        kw = {}
        if case != "fit_shape":
            kw["score_resources"] = tuple((r, w + 1) for w, r in enumerate(WIDE_NINE))
        if case != "fit_resources":
            kw.update(strategy="RequestedToCapacityRatio", shape=WIDE_SHAPE)
        plugins[names.index("NodeResourcesFit")] = core.ScoredPlugin(res.NodeResourcesFit(feats.resources, **kw))
    if case == "balanced_resources" or every:
        bal = res.NodeResourcesBalancedAllocation(feats.resources, score_resources=WIDE_NINE)
        plugins[names.index("NodeResourcesBalancedAllocation")] = core.ScoredPlugin(bal, filter_enabled=False)
    if case == "legacy_volume_limits" or every:
        at = names.index("NodeVolumeLimits") + 1
        vt = feats.aux["volumes"]
        plugins[at:at] = [
            core.ScoredPlugin(vol.NodeVolumeLimits(vt, name="EBSLimits", pools=("aws-ebs",)), score_enabled=False),
            core.ScoredPlugin(vol.NodeVolumeLimits(vt, name="GCEPDLimits", pools=("gce-pd",)), score_enabled=False),
        ]
    return tuple(plugins)


def torch_hooks() -> dict:
    """The hooked profile's device hooks, the port's half (tests/
    test_torch_hooks.py pairs each with ksim_tpu's): per plugin name,
    {PluginExtender field: callable over the port's tensors}.  A veto of
    node 0 and raw + 7 on NodeResourcesFit, one hook alone on each of four
    more plugins, and all six on PodTopologySpread."""
    import torch

    from ksim_tpu_torch.plugins.base import FilterOutput

    def veto(node: int, code: int):
        def hook(state, pods, aux, out):
            hit = torch.arange(out.ok.shape[-1], device=out.ok.device) == node
            return FilterOutput(ok=out.ok & ~hit, reason_bits=torch.where(hit, code, out.reason_bits).to(torch.int32))

        return hook

    return {
        "NodeResourcesFit": {"after_filter": veto(0, 1), "after_score": lambda s, p, a, x: x + 7},
        "NodeUnschedulable": {"before_filter": lambda s, p, a: (s._replace(unschedulable=torch.zeros_like(s.unschedulable)), p)},
        "NodeResourcesBalancedAllocation": {
            "before_score": lambda s, p, a: (s._replace(requested=torch.div(s.requested, 2, rounding_mode="floor")), p),
        },
        "TaintToleration": {"before_normalize": lambda s, p, a, raw, ok: raw + 1},
        "NodeAffinity": {"after_normalize": lambda s, p, a, norm, ok: torch.div(norm, 2, rounding_mode="floor")},
        "PodTopologySpread": {
            "before_filter": lambda s, p, a: (s, p),
            "after_filter": veto(1, 4),
            "before_score": lambda s, p, a: (s._replace(pod_count=s.pod_count + 1), p),
            "after_score": lambda s, p, a, x: x + 3,
            "before_normalize": lambda s, p, a, raw, ok: raw * 2,
            "after_normalize": lambda s, p, a, norm, ok: torch.div(norm, 3, rounding_mode="floor"),
        },
    }


def identity_hooks(plugins) -> dict:
    """Identity hooks on all six device fields of every plugin."""
    ident = {
        "before_filter": lambda s, p, a: (s, p),
        "after_filter": lambda s, p, a, out: out,
        "before_score": lambda s, p, a: (s, p),
        "after_score": lambda s, p, a, x: x,
        "before_normalize": lambda s, p, a, raw, ok: raw,
        "after_normalize": lambda s, p, a, norm, ok: norm,
    }
    return {sp.plugin.name: dict(ident) for sp in plugins}


def hooked_profile(plugins, hooks: dict) -> tuple:
    """``plugins`` (the port's ScoredPlugins) with ``hooks[name]`` as each
    named plugin's PluginExtender."""
    from ksim_tpu_torch.engine.core import PluginExtender, ScoredPlugin

    return tuple(
        ScoredPlugin(sp.plugin, sp.weight, sp.filter_enabled, sp.score_enabled,
                     extender=PluginExtender(**hooks[sp.plugin.name]) if sp.plugin.name in hooks else None)
        for sp in plugins
    )


def _sc(name, *, provisioner="pd.csi.storage.gke.io", mode="WaitForFirstConsumer"):
    return {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass", "metadata": {"name": name},
            "provisioner": provisioner, "volumeBindingMode": mode}


def _with_claim(pod, claim):
    pod["spec"]["volumes"] = [{"name": "data", "persistentVolumeClaim": {"claimName": claim}}]
    return pod


def _gce(name, node_name, read_only):
    pod = make_pod(name, node_name=node_name)
    pod["spec"]["volumes"] = [{"name": "d", "gcePersistentDisk": {"pdName": "disk-1", "readOnly": read_only}}]
    return pod


def _zone_nodes(*names_zones):
    return [make_node(n, labels={ZONE: z}) for n, z in names_zones]


def _req_term(app, key=ZONE, **extra):
    return {"labelSelector": {"matchLabels": {"app": app}}, "topologyKey": key, **extra}


def _spread(mode, max_skew=1, key=ZONE, **extra):
    return [{"maxSkew": max_skew, "topologyKey": key, "whenUnsatisfiable": mode,
             "labelSelector": {"matchLabels": {"app": "web"}}, **extra}]


def _scenario_volume_limits(full: bool):
    """tests/test_volumes.py's limits case: three claims fit 1 + 2 attach
    slots across commits; with those three bound, a fourth fits nowhere."""
    nodes = [make_node("n0", extra_alloc={"attachable-volumes-csi-d": "1"}),
             make_node("n1", extra_alloc={"attachable-volumes-csi-d": "2"})]
    pvs = [_pv(f"pv{i + 1}", sc="fast", phase="Bound", driver="d") for i in range(4)]
    pvcs = [_pvc(f"c{i}", volume_name=f"pv{i + 1}", sc="fast") for i in range(4)]
    kw = {"pvs": pvs, "pvcs": pvcs, "storage_classes": [_sc("fast", provisioner="d")]}
    if not full:
        return nodes, [], {**kw, "queue_pods": [_with_claim(make_pod(f"p{i}"), f"c{i}") for i in range(3)]}
    bound = [_with_claim(make_pod(f"b{i}", node_name=n), f"c{i}") for i, n in enumerate(["n0", "n1", "n1"])]
    return nodes, bound, {**kw, "queue_pods": [_with_claim(make_pod("p3"), "c3")]}


# The scenarios of tests/test_spread.py, tests/test_interpod.py and
# tests/test_volumes.py, as (nodes, pods, featurizer kwargs with the
# queue), with what the reference's test asserts of each kept beside it
# in the port's tests.
SCENARIOS = {
    "spread_skew": lambda: (
        _zone_nodes(("a1", "za"), ("b1", "zb")),
        [make_pod("w1", labels={"app": "web"}, node_name="a1"),
         make_pod("w2", labels={"app": "web"}, node_name="a1")],
        {"queue_pods": [make_pod("w3", labels={"app": "web"},
                                 topology_spread_constraints=_spread("DoNotSchedule"))]},
    ),
    "spread_missing_key": lambda: (
        [make_node("plain", labels={})], [],
        {"queue_pods": [make_pod("w", labels={"app": "web"},
                                 topology_spread_constraints=_spread("DoNotSchedule"))]},
    ),
    "spread_anyway": lambda: (
        [make_node(f"n{i}", labels={ZONE: f"z{i % 2}"}) for i in range(4)], [],
        {"queue_pods": [make_pod(f"w{i}", labels={"app": "web"},
                                 topology_spread_constraints=_spread("ScheduleAnyway")) for i in range(4)]},
    ),
    "spread_min_domains": lambda: (
        _zone_nodes(("a1", "za"), ("b1", "zb")),
        [make_pod("w1", labels={"app": "web"}, node_name="a1")],
        {"queue_pods": [make_pod("w2", labels={"app": "web"},
                                 topology_spread_constraints=_spread("DoNotSchedule", minDomains=3))]},
    ),
    "interpod_escape": lambda: (
        _zone_nodes(("n0", "za")), [],
        {"queue_pods": [make_pod("q", labels={"app": "web"}, affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("web")]}})]},
    ),
    "interpod_required_missing": lambda: (
        _zone_nodes(("n0", "za")), [],
        {"queue_pods": [make_pod("q", labels={"app": "web"}, affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("db")]}})]},
    ),
    "interpod_key_required": lambda: (
        [make_node("keyed", labels={ZONE: "za"}), make_node("plain", labels={})], [],
        {"queue_pods": [make_pod("q", labels={"app": "web"}, affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("web")]}})]},
    ),
    "interpod_anti": lambda: (
        _zone_nodes(("a1", "za"), ("b1", "zb")),
        [make_pod("w1", labels={"app": "web"}, node_name="a1")],
        {"queue_pods": [make_pod("q", labels={"app": "other"}, affinity={"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("web")]}})]},
    ),
    "interpod_existing_anti": lambda: (
        _zone_nodes(("a1", "za"), ("b1", "zb")),
        [make_pod("guard", labels={"app": "db"}, node_name="a1", affinity={"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("web")]}})],
        {"queue_pods": [make_pod("q", labels={"app": "web"})]},
    ),
    "interpod_preferred": lambda: (
        _zone_nodes(("a1", "za"), ("a2", "za"), ("b1", "zb")),
        [make_pod("w1", labels={"app": "web"}, node_name="a1")],
        {"queue_pods": [make_pod("q", labels={"app": "cache"}, affinity={"podAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": 50, "podAffinityTerm": _req_term("web")}]}})]},
    ),
    "interpod_hard_weight": lambda: (
        _zone_nodes(("a1", "za"), ("b1", "zb")),
        [make_pod("seed", labels={"app": "web"}, node_name="a1", affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("web")]}})],
        {"queue_pods": [make_pod("q", labels={"app": "web"})]},
    ),
    "interpod_namespace_selector": lambda: (
        [make_node("n0", labels={HOST: "n0"})],
        [make_pod("w1", namespace="team-a", labels={"app": "web"}, node_name="n0")],
        {"queue_pods": [
            make_pod("q", namespace="team-b", labels={"app": "x"}, affinity={"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _req_term("web", HOST, namespaceSelector={"matchLabels": {"team": "a"}})]}}),
            make_pod("q2", namespace="team-b", labels={"app": "x"}, affinity={"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("web", HOST)]}}),
        ],
         "namespaces": [{"metadata": {"name": "team-a", "labels": {"team": "a"}}},
                        {"metadata": {"name": "team-b", "labels": {"team": "b"}}}]},
    ),
    "interpod_shared_key": lambda: (
        _zone_nodes(("n0", "za")),
        [make_pod("db0", labels={"app": "db"}, node_name="n0")],
        {"queue_pods": [make_pod("q", labels={"app": "web"}, affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                _req_term("db"),
                {"labelSelector": {"matchLabels": {"tier": "cache"}}, "topologyKey": ZONE}]}})]},
    ),
    "interpod_distinct_keys": lambda: (
        [make_node("n0", labels={ZONE: "za", HOST: "n0"})],
        [make_pod("db0", labels={"app": "db"}, node_name="n0")],
        {"queue_pods": [make_pod("q", labels={"app": "web"}, affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                _req_term("db"),
                {"labelSelector": {"matchLabels": {"tier": "cache"}}, "topologyKey": HOST}]}})]},
    ),
    "interpod_sequential_anti": lambda: (
        [make_node(f"n{i}", labels={HOST: f"n{i}"}) for i in range(3)], [],
        {"queue_pods": [make_pod(f"w{i}", labels={"app": "web"}, affinity={"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("web", HOST)]}})
            for i in range(3)]},
    ),
    "interpod_sequential_follow": lambda: (
        _zone_nodes(("a1", "za"), ("b1", "zb"), ("a2", "za")), [],
        {"queue_pods": [make_pod(f"w{i}", labels={"app": "web"}, affinity={"podAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [_req_term("web")]}})
            for i in range(3)]},
    ),
    "volume_node_affinity": lambda: (
        _zone_nodes(("na", "a"), ("nb", "b")), [],
        {"queue_pods": [_with_claim(make_pod("p"), "claim")],
         "pvs": [_pv("pv1", affinity_zone="a")], "pvcs": [_pvc("claim", volume_name="pv1")]},
    ),
    "volume_unbound_and_missing": lambda: (
        [make_node("n0")], [],
        {"queue_pods": [_with_claim(make_pod("p1"), "immediate"), _with_claim(make_pod("p2"), "nosuch")],
         "pvcs": [_pvc("immediate")]},
    ),
    "volume_wffc_static": lambda: (
        _zone_nodes(("na", "a"), ("nb", "b")), [],
        {"queue_pods": [_with_claim(make_pod("p"), "claim")],
         "pvs": [_pv("pv-a", affinity_zone="a", sc="local")], "pvcs": [_pvc("claim", sc="local")],
         "storage_classes": [_sc("local", provisioner="kubernetes.io/no-provisioner")]},
    ),
    "volume_wffc_dynamic": lambda: (
        _zone_nodes(("na", "a"), ("nb", "b")), [],
        {"queue_pods": [_with_claim(make_pod("p"), "claim")],
         "pvcs": [_pvc("claim", sc="dyn")], "storage_classes": [_sc("dyn")]},
    ),
    "volume_zone": lambda: (
        _zone_nodes(("na", "a"), ("nb", "b")), [],
        {"queue_pods": [_with_claim(make_pod("p"), "claim")],
         "pvs": [_pv("pv1", zone="a")], "pvcs": [_pvc("claim", volume_name="pv1")]},
    ),
    "volume_limits_commit": lambda: _scenario_volume_limits(False),
    "volume_limits_full": lambda: _scenario_volume_limits(True),
    # The claim is bound here: tests/test_volumes.py's RWOP claim is an
    # unbound Immediate one, so VolumeBinding fails the pod everywhere and
    # its "lands on n1" holds only as names[-1].
    "volume_rwop": lambda: (
        [make_node("n0"), make_node("n1")],
        [_with_claim(make_pod("holder", node_name="n0"), "shared")],
        {"queue_pods": [_with_claim(make_pod("p"), "shared")],
         "pvs": [_pv("pv-rwop", phase="Bound")],
         "pvcs": [_pvc("shared", volume_name="pv-rwop", modes=("ReadWriteOncePod",))]},
    ),
    "volume_disk_rw": lambda: (
        [make_node("n0"), make_node("n1")], [_gce("h", "n0", True)], {"queue_pods": [_gce("q-rw", "", False)]},
    ),
    "volume_disk_ro": lambda: (
        [make_node("n0"), make_node("n1")], [_gce("h", "n0", True)], {"queue_pods": [_gce("q-ro", "", True)]},
    ),
}


CLUSTERS = {
    "seed0": lambda: random_cluster(0, 40, 64),
    "seed1": lambda: random_cluster(1, 33, 50),
    "seed2": lambda: random_cluster(2, 17, 30, bound_fraction=0.6),
    "images_ports": lambda: images_ports_cluster(3),
    "unschedulable": lambda: unschedulable_heavy_cluster(4),
    "ports_commit": ports_commit_cluster,
}
# Clusters that also need featurizer keyword arguments (namespaces,
# volumes): (nodes, pods, kwargs).
CLUSTERS_KW = {
    "spread_affinity": lambda: spread_affinity_cluster(7),
    "spread_affinity2": lambda: spread_affinity_cluster(8, n_nodes=23, n_pods=50),
    "volumes": lambda: volume_cluster(9),
    "volumes2": lambda: volume_cluster(10, n_nodes=9, n_pods=30),
}


# The DataProviderScore instances of the samples' tests: a renewable
# share in 0..100 and an arbitrary int32 value (negatives included).
PROVIDERS = ("Renewable", "Carbon")


def provider_fn(name: str, seed: int = 0):
    """A data provider: a per-node value made from ``seed`` and the node's
    name with numpy (the same value wherever the node sits)."""

    def provide(nodes):
        out = []
        for n in nodes:
            key = sum(map(ord, n["metadata"]["name"])) + 7919 * seed
            rng = np.random.default_rng(key)
            out.append(rng.integers(0, 101) if name == "Renewable" else rng.integers(-50000, 50000))
        return np.asarray(out, dtype=np.int64)

    return provide


def sample_cluster(seed: int = 0):
    """About 24 nodes and 64 pods: the random cluster plus nodes and pods
    whose names carry no digit suffix (NodeNumber's -1 code)."""
    nodes, pods = random_cluster(seed, 22, 60)
    nodes += [make_node("edge-a", cpu="8", memory="16Gi"), make_node("edge-b", cpu="4", memory="8Gi")]
    pods += [make_pod(f"job-{c}", cpu="200m") for c in "wxyz"]
    return nodes, pods


def case_inputs(case: str):
    """(nodes, pods, featurizer kwargs) of any named cluster or scenario."""
    if case in CLUSTERS:
        return (*CLUSTERS[case](), {})
    if case in SCENARIOS:
        return SCENARIOS[case]()
    return CLUSTERS_KW[case]()


# Kernel E's visit window (E4 window): padded nodes -> real nodes, and the
# sweep of rotating starts and k the window is held over.
WINDOW_NODES = {40: 37, 6144: 5000}
WINDOW_STARTS = ("zero", "tile", "last", "past")
WINDOW_KS = ("one", "seven", "k500", "over")
WINDOW_CASES = tuple((n, start, k) for n in WINDOW_NODES for start in WINDOW_STARTS for k in WINDOW_KS
                     if not (k == "k500" and n < 500))


def window_ok(n_nodes: int, seed: int = 0) -> np.ndarray:
    """One pod's filter result over ``n_nodes`` padded nodes: about a third
    of the real nodes feasible, and the padding slots' ok true (the window
    must never visit them)."""
    n_real = WINDOW_NODES[n_nodes]
    ok = np.random.default_rng(1000 * seed + n_nodes).random(n_nodes) < 0.3
    ok[n_real:] = True
    return ok


def window_case(n_nodes: int, start: str, k: str, seed: int = 0):
    """(ok [N] bool, start, n_real, k) of one pod's visit window.  start:
    0; a tile boundary (4096 at 6144 nodes: a multiple of the 256-, 1024-
    and 4096-node tiles of clusters of 1, 2 and 8 blocks; a 32-node chunk
    at 40); the last real node; past the real nodes (taken modulo their
    count).  k: 1, 7, 500, or one more than the feasible count (every real
    node visited).  k never exceeds N: the reference's top_k refuses it."""
    ok = window_ok(n_nodes, seed)
    n_real = WINDOW_NODES[n_nodes]
    feasible = int(ok[:n_real].sum())
    s = {"zero": 0, "tile": 4096 if n_nodes > 4096 else 32, "last": n_real - 1, "past": n_real + 3}[start]
    kk = {"one": 1, "seven": 7, "k500": 500, "over": feasible + 1}[k]
    return ok, s, n_real, kk


def test_window_cases_cover_the_sweep():
    """The starts fall where they are meant to, and "over" asks for more
    nodes than are feasible."""
    for n, start, k in WINDOW_CASES:
        ok, s, n_real, kk = window_case(n, start, k)
        assert ok[n_real:].all() and 0 < ok[:n_real].sum() < n_real
        assert kk <= n and (k != "over" or kk > ok[:n_real].sum())
        assert (start == "past") == (s >= n_real)
    assert len(WINDOW_CASES) == 28


def test_images_ports_cluster_has_images_and_host_ports():
    nodes, pods = images_ports_cluster(3)
    assert sum(len(n["status"]["images"]) for n in nodes) > len(nodes)
    ports = [c for p in pods for c in p["spec"]["containers"] if c.get("ports")]
    assert ports and any(p["spec"].get("nodeName") for p in pods)
    assert any(len(p["spec"]["containers"]) == 3 for p in pods)


def test_clusters_are_reproducible():
    for build in list(CLUSTERS.values()) + list(CLUSTERS_KW.values()) + list(SCENARIOS.values()):
        assert build() == build()


def test_spread_affinity_cluster_has_what_it_is_for():
    nodes, pods, kw = spread_affinity_cluster(7)
    cons = [c for p in pods for c in p["spec"].get("topologySpreadConstraints", [])]
    assert any(len(p["spec"].get("topologySpreadConstraints", [])) == 3 for p in pods)
    assert {c["topologyKey"] for c in cons} == {ZONE, HOST, "rack"}
    assert any("minDomains" in c for c in cons) and any("matchLabelKeys" in c for c in cons)
    assert any(ZONE not in n["metadata"]["labels"] for n in nodes)
    assert any("namespaceSelector" in str(p["spec"].get("affinity")) for p in pods)
    assert kw["namespaces"]


def test_volume_cluster_has_what_it_is_for():
    nodes, pods, kw = volume_cluster(9)
    vols = [v for p in pods for v in p["spec"].get("volumes", [])]
    claims = {v["persistentVolumeClaim"]["claimName"] for v in vols if "persistentVolumeClaim" in v}
    assert {"c-imm", "c-missing"} & claims and any(c.startswith("c-rwop") for c in claims)
    assert any("gcePersistentDisk" in v for v in vols)
    assert len(kw["pvs"]) == 16 and len(kw["storage_classes"]) == 2
