"""KubeSchedulerConfiguration -> compiled kernel profiles.

The reference "compiles" a profile by rewriting the scheduler's
KubeSchedulerConfiguration (wrap every plugin, merge plugin sets, disable
MultiPoint defaults) and restarting the scheduler container (reference
simulator/scheduler/scheduler.go:141-183 ConvertConfigurationForSimulator,
simulator/scheduler/plugin/plugins.go:174-304 ConvertForSimulator/
mergePluginSet/getScorePluginWeight).  Here: select + configure the
plugin chain for the Engine — "restart" is a new plugin tuple (Engine
construction), with rollback on a config that fails to compile.

The port of ``ksim_tpu/scheduler/profile.py``: the same merge, the same
builders, building the port's plugins.  A config naming a legacy per-pool
volume-limit plugin (EBSLimits, GCEPDLimits, ...) compiles, and the
Engine refuses it with NotImplementedError (kernels/chain.py
``check_chain``: the kernels hold one NodeVolumeLimits instance).

Merge semantics mirror upstream default_plugins.go mergePluginSet:

- start from the default MultiPoint list (order defines filter order and
  therefore early-exit recording order);
- ``disabled`` entries remove by name, ``"*"`` removes all defaults;
- ``enabled`` entries already in the defaults override the weight in
  place; new names append in declaration order;
- the per-extension-point sets (filter/score/...) then enable/disable on
  top, for out-of-tree or re-weighted plugins.

Plugin args honored from pluginConfig (upstream *Args types):
``NodeResourcesFitArgs.scoringStrategy`` (LeastAllocated resources),
``NodeResourcesBalancedAllocationArgs.resources``,
``InterPodAffinityArgs.hardPodAffinityWeight`` (threaded into the
featurizer's inter-pod encoding).

Every upstream default-profile plugin resolves: kernels for the filter/
score families (including the volume family), STRUCTURAL handling in the
service for PrioritySort (queue sort with PriorityClass resolution),
DefaultBinder (bind), DefaultPreemption (postfilter), and SchedulingGates
(queue gate).  Truly unknown names raise; anything enabled without a
kernel would surface through ``CompiledProfile.skipped``.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from ksim_tpu_torch.engine.core import ScoredPlugin
from ksim_tpu_torch.state.featurizer import FeaturizedSnapshot, Featurizer
from ksim_tpu_torch.state.interpod import DEFAULT_HARD_POD_AFFINITY_WEIGHT

logger = logging.getLogger(__name__)

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# Upstream v1.30 getDefaultPlugins MultiPoint order and weights
# (pkg/scheduler/apis/config/v1/default_plugins.go).
DEFAULT_MULTIPOINT: tuple[tuple[str, int], ...] = (
    ("SchedulingGates", 0),
    ("PrioritySort", 0),
    ("NodeUnschedulable", 0),
    ("NodeName", 0),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
    ("NodePorts", 0),
    ("NodeResourcesFit", 1),
    ("VolumeRestrictions", 0),
    ("NodeVolumeLimits", 0),
    ("VolumeBinding", 0),
    ("VolumeZone", 0),
    ("PodTopologySpread", 2),
    ("InterPodAffinity", 2),
    ("DefaultPreemption", 0),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("DefaultBinder", 0),
)

# Plugins realized outside the kernel set.
STRUCTURAL_PLUGINS = frozenset(
    {"SchedulingGates", "PrioritySort", "DefaultPreemption", "DefaultBinder"}
)

# Builder: (feats, args) -> ScoredPlugin (weight filled by the compiler).
Builder = Callable[[FeaturizedSnapshot, dict], ScoredPlugin]


def _build_node_unschedulable(feats, args):
    from ksim_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable

    return ScoredPlugin(NodeUnschedulable(), score_enabled=False)


def _build_fit(feats, args):
    from ksim_tpu_torch.plugins.noderesources import NodeResourcesFit

    strategy = args.get("scoringStrategy") or {}
    resources = strategy.get("resources") or [
        {"name": "cpu", "weight": 1},
        {"name": "memory", "weight": 1},
    ]
    # All three upstream strategies are valid config (the reference decodes
    # any upstream KubeSchedulerConfiguration, simulator/config/config.go:
    # 275-291, and its tests exercise MostAllocated, config_test.go:30-56);
    # the kernel validates the name and the RTCR shape.
    stype = strategy.get("type") or "LeastAllocated"
    shape = tuple(
        (int(p.get("utilization", 0)), int(p.get("score", 0)))
        for p in (strategy.get("requestedToCapacityRatio") or {}).get("shape") or []
    )
    spec = tuple((r["name"], int(r.get("weight") or 1)) for r in resources)
    return ScoredPlugin(
        NodeResourcesFit(
            feats.resources, score_resources=spec, strategy=stype, shape=shape
        )
    )


def _build_balanced(feats, args):
    from ksim_tpu_torch.plugins.noderesources import NodeResourcesBalancedAllocation

    resources = args.get("resources") or [{"name": "cpu"}, {"name": "memory"}]
    spec = tuple(r["name"] for r in resources)
    return ScoredPlugin(
        NodeResourcesBalancedAllocation(feats.resources, score_resources=spec),
        filter_enabled=False,
    )


def _build_taints(feats, args):
    from ksim_tpu_torch.plugins.tainttoleration import TaintToleration

    return ScoredPlugin(TaintToleration(feats.aux["taints"]))


def _build_node_affinity(feats, args):
    from ksim_tpu_torch.plugins.nodeaffinity import NodeAffinity

    # NodeAffinityArgs.addedAffinity rides the featurizer (profile-level
    # terms in the affinity vocabulary, CompiledProfile.featurizer); the
    # kernel reads the added_terms/added_pref aux fields unconditionally.
    return ScoredPlugin(NodeAffinity())


def _build_spread(feats, args):
    from ksim_tpu_torch.plugins.podtopologyspread import PodTopologySpread

    return ScoredPlugin(PodTopologySpread(feats.aux["spread"]))


def _build_interpod(feats, args):
    from ksim_tpu_torch.plugins.interpodaffinity import InterPodAffinity

    return ScoredPlugin(InterPodAffinity(feats.aux["interpod"]))


def _build_node_name(feats, args):
    from ksim_tpu_torch.plugins.nodename import NodeName

    return ScoredPlugin(NodeName(), score_enabled=False)


def _build_node_ports(feats, args):
    from ksim_tpu_torch.plugins.nodeports import NodePorts

    return ScoredPlugin(NodePorts(), score_enabled=False)


def _build_image_locality(feats, args):
    from ksim_tpu_torch.plugins.imagelocality import ImageLocality

    return ScoredPlugin(
        ImageLocality(feats.aux["imagelocality"]), filter_enabled=False
    )


def _build_volume(cls_name):
    def build(feats, args):
        from ksim_tpu_torch.plugins import volumes

        cls = getattr(volumes, cls_name)
        return ScoredPlugin(cls(feats.aux["volumes"]), score_enabled=False)

    return build


# Legacy registry name -> attachable-volumes-* pool suffix.  Upstream
# v1.30 registers these as one-type non-CSI limit plugins
# (nodevolumelimits/non_csi.go); the reference's exported default config
# enables them in the filter set (snapshot_test.go:1415), so any
# reference-exported snapshot must import here.
LEGACY_VOLUME_LIMITS = {
    "EBSLimits": "aws-ebs",
    "GCEPDLimits": "gce-pd",
    "AzureDiskLimits": "azure-disk",
    "CinderLimits": "cinder",
}


def _build_legacy_volume_limits(name: str, pool: str):
    def build(feats, args):
        from ksim_tpu_torch.plugins.volumes import NodeVolumeLimits

        return ScoredPlugin(
            NodeVolumeLimits(feats.aux["volumes"], name=name, pools=(pool,)),
            score_enabled=False,
        )

    return build


def load_plugin_import(spec: str) -> tuple[Builder, dict, dict]:
    """Resolve a ``pkg.module:attr`` plugin import — this simulator's form
    of the reference's wasm-plugin loading, where out-of-tree plugins are
    registered purely from configuration (reference
    simulator/scheduler/config/wasm.go:14-58: a pluginConfig arg
    ``guestURL`` names a wasm guest; here ``builderImport`` names an
    importable Builder).

    The attribute may be a Builder ``(feats, args) -> ScoredPlugin``, or
    a dict/object exposing ``builder`` and optionally ``extra_encoders``
    (aux key -> featurizer extra encoder) for plugins that ship their own
    tensors, plus the snapshot-independent QUEUE hooks (upstream runs
    these on the scheduling queue, outside the per-pod cycle, so they
    live on the import target rather than the per-snapshot instance):

    - ``queue_sort_key(pod, priority_of) -> sortable`` — a custom
      QueueSort replacing PrioritySort (the reference wraps custom
      QueueSort plugins, wrappedplugin.go:750-765; upstream allows
      exactly one per profile);
    - ``pre_enqueue(pod) -> str | None`` — a PreEnqueue gate
      (wrappedplugin.go:376): a non-None message keeps the pod out of
      the scheduling queue, like an unsatisfied scheduling gate.

    A non-empty ``KSIM_ALLOWED_PLUGIN_MODULES`` (comma-separated module
    prefixes) narrows the trust gate from all-or-nothing to an operator
    allowlist: only modules equal to or under a listed prefix may load
    (the closest Python analogue to the reference confining wasm guests
    to the configured guestURL sandbox, wasm.go:14-58)."""
    import importlib

    mod, sep, attr = spec.partition(":")
    if not sep or not mod or not attr:
        raise ValueError(
            f"plugin import {spec!r} must look like 'pkg.module:attr'"
        )
    allowlist = [
        p.strip()
        for p in os.environ.get("KSIM_ALLOWED_PLUGIN_MODULES", "").split(",")
        if p.strip()
    ]
    if allowlist and not any(
        mod == p or mod.startswith(p + ".") for p in allowlist
    ):
        raise ValueError(
            f"plugin import {spec!r}: module {mod!r} is not in "
            "KSIM_ALLOWED_PLUGIN_MODULES"
        )
    try:
        target = getattr(importlib.import_module(mod), attr)
    except (ImportError, AttributeError) as e:
        raise ValueError(f"cannot load plugin import {spec!r}: {e}") from e
    if isinstance(target, dict):
        builder = target.get("builder")
        encoders = target.get("extra_encoders") or {}
        hooks = {
            k: target.get(k)
            for k in ("queue_sort_key", "pre_enqueue")
            if callable(target.get(k))
        }
    else:
        builder = getattr(target, "builder", target)
        encoders = getattr(target, "extra_encoders", None) or {}
        hooks = {
            k: getattr(target, k)
            for k in ("queue_sort_key", "pre_enqueue")
            if callable(getattr(target, k, None))
        }
    if not callable(builder):
        raise ValueError(
            f"plugin import {spec!r} does not provide a callable builder"
        )
    return builder, dict(encoders), hooks


def _load_config_plugins(
    profile_cfg: dict, registry: dict[str, Builder], allow_imports: bool
) -> tuple[dict[str, Builder], dict, dict]:
    """Scan a profile's pluginConfig for ``builderImport`` args and
    register the loaded Builders (before plugin-set merging, like the
    reference registers wasm plugins before config conversion —
    pkg/debuggablescheduler/debuggable_scheduler.go:46-88).  Explicitly
    passed registry entries win over config-loaded ones.

    ``allow_imports`` gates the capability: importing a module executes
    arbitrary code, so only operator-owned configs (boot config, CLI)
    may use it — a config arriving over the debug HTTP API may not,
    unless the operator opted in (service allow_plugin_imports /
    KSIM_ALLOW_PLUGIN_IMPORTS=1).  The reference's wasm guests are
    sandboxed; a Python import is not."""
    encoders: dict = {}
    queue_hooks: dict[str, dict] = {}  # plugin name -> {hook: fn}
    for pc in profile_cfg.get("pluginConfig") or []:
        name = pc.get("name")
        spec = (pc.get("args") or {}).get("builderImport")
        if not name or not spec:
            continue
        if not allow_imports:
            raise ValueError(
                f"pluginConfig {name!r} uses builderImport, which this "
                "config source is not trusted for (enable with "
                "allow_plugin_imports / KSIM_ALLOW_PLUGIN_IMPORTS=1)"
            )
        builder, enc, hooks = load_plugin_import(spec)
        if name not in registry:
            registry[name] = builder
        encoders.update(enc)
        if hooks:
            queue_hooks[name] = hooks
    return registry, encoders, queue_hooks


INTREE_BUILDERS: dict[str, Builder] = {
    "NodeUnschedulable": _build_node_unschedulable,
    "NodeName": _build_node_name,
    "NodeResourcesFit": _build_fit,
    "NodeResourcesBalancedAllocation": _build_balanced,
    "TaintToleration": _build_taints,
    "NodeAffinity": _build_node_affinity,
    "NodePorts": _build_node_ports,
    "PodTopologySpread": _build_spread,
    "InterPodAffinity": _build_interpod,
    "ImageLocality": _build_image_locality,
    "VolumeRestrictions": _build_volume("VolumeRestrictions"),
    "NodeVolumeLimits": _build_volume("NodeVolumeLimits"),
    "VolumeBinding": _build_volume("VolumeBinding"),
    "VolumeZone": _build_volume("VolumeZone"),
    **{
        name: _build_legacy_volume_limits(name, pool)
        for name, pool in LEGACY_VOLUME_LIMITS.items()
    },
}


@dataclass
class CompiledProfile:
    """One profile's kernel set, ready to drive the Engine."""

    scheduler_name: str
    enabled: tuple[tuple[str, int], ...]  # (plugin, weight) in filter order
    plugin_args: dict[str, dict]
    skipped: tuple[str, ...]  # enabled names with no kernel (gap surface)
    registry: dict[str, Builder] = field(default_factory=dict)
    hard_pod_affinity_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT
    # Per-extension-point overrides (upstream per-point PluginSets disable
    # a plugin at ONE point, not everywhere).
    filter_disabled: frozenset[str] = frozenset()
    score_disabled: frozenset[str] = frozenset()
    reserve_disabled: frozenset[str] = frozenset()
    prebind_disabled: frozenset[str] = frozenset()
    permit_disabled: frozenset[str] = frozenset()
    postfilter_disabled: frozenset[str] = frozenset()
    bind_disabled: frozenset[str] = frozenset()
    postbind_disabled: frozenset[str] = frozenset()
    # Snapshot-independent queue hooks from config-registered plugins
    # (load_plugin_import): a custom QueueSort replacing PrioritySort
    # (name, key fn), and PreEnqueue gates [(name, fn), ...].
    queue_sort_plugin: "tuple[str, Callable] | None" = None
    pre_enqueue_hooks: tuple = ()
    # KubeSchedulerProfile.percentageOfNodesToScore (v1.30: per-profile
    # override of the global field; None = inherit, 0 = adaptive).  Used
    # only by the opt-in sampling emulation (KSIM_PNTS_EMULATION=1).
    percentage_of_nodes_to_score: int | None = None
    # Plugins added only through a per-point set: name -> points enabled.
    point_only: dict[str, frozenset[str]] = field(default_factory=dict)
    # Featurizer extra encoders shipped by config-loaded plugins
    # (load_plugin_import).
    extra_encoders: dict = field(default_factory=dict)

    def spread_defaults(self) -> tuple | None:
        """PodTopologySpreadArgs -> default-constraint tuple (upstream
        v1 defaults.go: defaultingType defaults to System; List uses the
        args' defaultConstraints; System forbids explicit ones)."""
        from ksim_tpu_torch.state.encoding import SYSTEM_DEFAULT_CONSTRAINTS

        args = self.plugin_args.get("PodTopologySpread", {})
        dtype = args.get("defaultingType") or "System"
        explicit = args.get("defaultConstraints") or []
        if dtype == "System":
            if explicit:
                raise ValueError(
                    "PodTopologySpreadArgs: defaultConstraints must be "
                    "empty when defaultingType is System (upstream "
                    "validation)"
                )
            return SYSTEM_DEFAULT_CONSTRAINTS
        if dtype != "List":
            raise ValueError(
                f"PodTopologySpreadArgs: unknown defaultingType {dtype!r}"
            )
        return tuple(explicit) or None

    def featurizer(self, *, pod_bucket_min: int | None = None) -> Featurizer:
        return Featurizer(
            interpod_hard_weight=self.hard_pod_affinity_weight,
            extra_encoders=self.extra_encoders,
            pod_bucket_min=pod_bucket_min,
            added_affinity=self.plugin_args.get("NodeAffinity", {}).get(
                "addedAffinity"
            ),
            spread_defaults=self.spread_defaults(),
        )

    def plugins(self, feats: FeaturizedSnapshot) -> tuple[ScoredPlugin, ...]:
        """The Engine plugin tuple.  Rebuilding after a config change is
        the reference's scheduler restart."""
        out = []
        for name, weight in self.enabled:
            builder = self.registry.get(name) or INTREE_BUILDERS.get(name)
            if builder is None:
                continue
            sp = builder(feats, self.plugin_args.get(name, {}))
            filter_on = sp.filter_enabled and name not in self.filter_disabled
            score_on = sp.score_enabled and name not in self.score_disabled

            def host_on(hook: str, disabled: frozenset, point: str) -> bool:
                ext = sp.extender
                has_ext = ext is not None and (
                    getattr(ext, f"before_{hook}", None) is not None
                    or getattr(ext, f"after_{hook}", None) is not None
                )
                on = (hasattr(sp.plugin, hook) or has_ext) and name not in disabled
                if name in self.point_only:
                    on = on and point in self.point_only[name]
                return on

            permit_on = host_on("permit", self.permit_disabled, "permit")
            reserve_host = host_on(
                "reserve", self.reserve_disabled, "reserve"
            ) or host_on("unreserve", self.reserve_disabled, "reserve")
            postfilter_on = host_on(
                "post_filter", self.postfilter_disabled, "postFilter"
            )
            prebind_host = host_on("pre_bind", self.prebind_disabled, "preBind")
            bind_on = host_on("bind", self.bind_disabled, "bind")
            postbind_on = host_on(
                "post_bind", self.postbind_disabled, "postBind"
            )
            def point_on(point: str, disabled: frozenset) -> bool:
                if name in disabled:
                    return False
                if name in self.point_only:
                    return point in self.point_only[name]
                return True

            if name in self.point_only:
                points = self.point_only[name]
                filter_on = filter_on and "filter" in points
                score_on = score_on and "score" in points
            # A host-hook-only plugin stays in the set with both kernel
            # points off: the engine loops skip it, the service still
            # runs its host-side hooks.
            if not (
                filter_on
                or score_on
                or permit_on
                or reserve_host
                or postfilter_on
                or prebind_host
                or bind_on
                or postbind_on
            ):
                continue
            out.append(
                ScoredPlugin(
                    sp.plugin,
                    weight=weight if weight > 0 else 1,
                    filter_enabled=filter_on,
                    score_enabled=score_on,
                    extender=sp.extender,
                    # Point-only plugins are active ONLY at their named
                    # points: prebind_enabled both gates the host
                    # pre_bind hook (service._run_pre_bind) and the
                    # recorded reserve/prebind success maps.
                    reserve_enabled=point_on("reserve", self.reserve_disabled),
                    prebind_enabled=point_on("preBind", self.prebind_disabled),
                    permit_enabled=permit_on,
                    postfilter_enabled=postfilter_on,
                    bind_enabled=bind_on,
                    postbind_enabled=postbind_on,
                )
            )
        return tuple(out)


def _merge_plugin_set(
    defaults: Sequence[tuple[str, int]],
    custom: dict | None,
) -> list[tuple[str, int]]:
    """Upstream mergePluginSet over (name, weight) lists."""
    custom = custom or {}
    disabled = {p.get("name") for p in custom.get("disabled") or []}
    enabled_custom = custom.get("enabled") or []
    overrides = {
        p["name"]: int(p.get("weight") or 0)
        for p in enabled_custom
        if p.get("name")
    }
    merged: list[tuple[str, int]] = []
    replaced: set[str] = set()
    for name, weight in defaults:
        if "*" in disabled or name in disabled:
            continue
        if name in overrides:
            # Upstream replaces the default entry with the custom one
            # wholesale; a nil weight then defaults to 1, NOT the
            # default-profile weight.
            merged.append((name, overrides[name] or 1))
            replaced.add(name)
        else:
            merged.append((name, weight))
    for p in enabled_custom:
        name = p.get("name")
        if name and name not in replaced:
            merged.append((name, int(p.get("weight") or 0)))
    return merged


def compile_profile(
    profile_cfg: dict | None = None,
    *,
    registry: dict[str, Builder] | None = None,
    allow_plugin_imports: bool = False,
) -> CompiledProfile:
    """One KubeSchedulerProfile dict -> CompiledProfile.  Raises ValueError
    on unknown enabled plugins (reference registry behavior) unless they
    are upstream defaults without kernels (recorded in ``skipped``)."""
    profile_cfg = profile_cfg or {}
    # In-code registry entries may be bare Builders or the same
    # dict/object shape load_plugin_import accepts (builder + queue
    # hooks); normalize to Builders + a hook map.
    norm_registry: dict[str, Builder] = {}
    queue_hooks: dict[str, dict] = {}
    for name, entry in (registry or {}).items():
        if callable(entry):
            norm_registry[name] = entry
            continue
        get = entry.get if isinstance(entry, dict) else (
            lambda k, _e=entry: getattr(_e, k, None)
        )
        builder = get("builder")
        if not callable(builder):
            raise ValueError(
                f"registry entry {name!r} does not provide a callable "
                "builder (dict/object entries need 'builder' alongside "
                "their queue hooks)"
            )
        norm_registry[name] = builder
        hooks = {
            k: get(k)
            for k in ("queue_sort_key", "pre_enqueue")
            if callable(get(k))
        }
        if hooks:
            queue_hooks[name] = hooks
    # Config-declared out-of-tree plugins register first (the reference's
    # RegisterWasmPlugins-before-conversion ordering).
    registry, loaded_encoders, loaded_hooks = _load_config_plugins(
        profile_cfg, norm_registry, allow_plugin_imports
    )
    for name, hooks in loaded_hooks.items():
        queue_hooks.setdefault(name, hooks)
    plugins_cfg = profile_cfg.get("plugins") or {}
    merged = _merge_plugin_set(DEFAULT_MULTIPOINT, plugins_cfg.get("multiPoint"))

    # Per-point sets act on ONE extension point: a disable drops the
    # plugin at that point only; an enable adds it at that point only
    # (upstream Plugins struct per-point PluginSets).  Kernel relevance is
    # filter/score; other points are validated but structurally inert.
    default_names = {n for n, _ in DEFAULT_MULTIPOINT}
    filter_off: set[str] = set()
    score_off: set[str] = set()
    reserve_off: set[str] = set()
    prebind_off: set[str] = set()
    permit_off: set[str] = set()
    postfilter_off: set[str] = set()
    bind_off: set[str] = set()
    postbind_off: set[str] = set()
    point_only: dict[str, set[str]] = {}
    for point in ("queueSort", "preEnqueue", "preFilter", "filter",
                  "postFilter", "preScore", "score", "reserve", "permit",
                  "preBind", "bind", "postBind"):
        point_cfg = plugins_cfg.get(point)
        if not point_cfg:
            continue
        have = {n for n, _ in merged}
        disabled_here = {p.get("name") for p in point_cfg.get("disabled") or []}
        if point == "filter":
            filter_off |= have if "*" in disabled_here else disabled_here
        elif point == "score":
            score_off |= have if "*" in disabled_here else disabled_here
        elif point == "reserve":
            reserve_off |= have if "*" in disabled_here else disabled_here
        elif point == "preBind":
            prebind_off |= have if "*" in disabled_here else disabled_here
        elif point == "permit":
            permit_off |= have if "*" in disabled_here else disabled_here
        elif point == "postFilter":
            postfilter_off |= have if "*" in disabled_here else disabled_here
        elif point == "bind":
            bind_off |= have if "*" in disabled_here else disabled_here
        elif point == "postBind":
            postbind_off |= have if "*" in disabled_here else disabled_here
        for p in point_cfg.get("enabled") or []:
            name = p.get("name")
            if not name:
                continue
            if name not in have and name not in default_names:
                if name not in registry and name not in INTREE_BUILDERS:
                    raise ValueError(f"unknown plugin {name!r} enabled at {point}")
            if name not in have:
                merged.append((name, int(p.get("weight") or 0)))
                have.add(name)
                point_only[name] = set()
            if name in point_only:
                point_only[name].add(point)
            elif point == "score" and p.get("weight"):
                # Re-weighting an already-enabled plugin at the score point.
                merged = [
                    (n, int(p["weight"]) if n == name else w) for n, w in merged
                ]

    plugin_args: dict[str, dict] = {}
    for pc in profile_cfg.get("pluginConfig") or []:
        name = pc.get("name")
        if name:
            plugin_args[name] = dict(pc.get("args") or {})

    skipped = tuple(
        n
        for n, _ in merged
        if n not in INTREE_BUILDERS
        and n not in (registry or {})
        and n not in STRUCTURAL_PLUGINS
    )
    for name in skipped:
        if name not in default_names:
            raise ValueError(f"unknown plugin {name!r} in profile")
        logger.warning("plugin %s has no kernel yet; skipping", name)

    hard_weight = int(
        plugin_args.get("InterPodAffinity", {}).get(
            "hardPodAffinityWeight", DEFAULT_HARD_POD_AFFINITY_WEIGHT
        )
    )
    # Queue hooks activate for ENABLED plugins only.  A plugin shipping
    # queue_sort_key replaces PrioritySort's order for the profile;
    # upstream allows exactly one QueueSort plugin per profile
    # (wrappedplugin.go:357 "There must be only one in each profile").
    enabled_names = {n for n, _ in merged}
    sorters = [
        (n, h["queue_sort_key"])
        for n, h in queue_hooks.items()
        if n in enabled_names and "queue_sort_key" in h
    ]
    if len(sorters) > 1:
        raise ValueError(
            "multiple queue-sort plugins enabled: "
            + ", ".join(sorted(n for n, _ in sorters))
        )
    pre_enqueue_hooks = tuple(
        (n, h["pre_enqueue"])
        for n, h in sorted(queue_hooks.items())
        if n in enabled_names and "pre_enqueue" in h
    )
    prof = CompiledProfile(
        scheduler_name=profile_cfg.get("schedulerName") or DEFAULT_SCHEDULER_NAME,
        enabled=tuple(merged),
        plugin_args=plugin_args,
        skipped=skipped,
        registry=dict(registry or {}),
        hard_pod_affinity_weight=hard_weight,
        filter_disabled=frozenset(filter_off),
        score_disabled=frozenset(score_off),
        reserve_disabled=frozenset(reserve_off),
        prebind_disabled=frozenset(prebind_off),
        permit_disabled=frozenset(permit_off),
        postfilter_disabled=frozenset(postfilter_off),
        bind_disabled=frozenset(bind_off),
        postbind_disabled=frozenset(postbind_off),
        point_only={k: frozenset(v) for k, v in point_only.items()},
        extra_encoders=loaded_encoders,
        queue_sort_plugin=sorters[0] if sorters else None,
        pre_enqueue_hooks=pre_enqueue_hooks,
        percentage_of_nodes_to_score=(
            int(profile_cfg["percentageOfNodesToScore"])
            if isinstance(profile_cfg.get("percentageOfNodesToScore"), int)
            else None
        ),
    )
    prof.spread_defaults()  # validate PodTopologySpreadArgs at compile time
    return prof


def compile_configuration(
    cfg: dict | None,
    *,
    registry: dict[str, Builder] | None = None,
    allow_plugin_imports: bool = False,
) -> list[CompiledProfile]:
    """KubeSchedulerConfiguration dict -> compiled profiles (defaulting to
    one default-scheduler profile, reference scheduler.go:143-150)."""
    cfg = cfg or {}
    profiles = cfg.get("profiles") or [{}]
    return [
        compile_profile(
            p, registry=registry, allow_plugin_imports=allow_plugin_imports
        )
        for p in profiles
    ]
