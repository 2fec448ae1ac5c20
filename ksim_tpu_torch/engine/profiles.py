"""The default profile, in upstream order and with upstream weights.

``default_plugins`` builds upstream's default profile (default_plugins.go
getDefaultPlugins) from the plugins ported so far.  A plugin that is not
ported yet must be named in ``disabled``; otherwise it raises
NotImplementedError naming the plugin, so a profile never silently runs
with fewer plugins than asked for.
"""

from __future__ import annotations

from ksim_tpu_torch.engine.core import ScoredPlugin
from ksim_tpu_torch.plugins.imagelocality import ImageLocality
from ksim_tpu_torch.plugins.nodeaffinity import NodeAffinity
from ksim_tpu_torch.plugins.nodename import NodeName
from ksim_tpu_torch.plugins.nodeports import NodePorts
from ksim_tpu_torch.plugins.noderesources import (
    NodeResourcesBalancedAllocation,
    NodeResourcesFit,
)
from ksim_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from ksim_tpu_torch.plugins.tainttoleration import TaintToleration
from ksim_tpu_torch.state.featurizer import FeaturizedSnapshot

#: Default-profile plugins not ported yet.
UNPORTED = frozenset(
    (
        "VolumeRestrictions",
        "NodeVolumeLimits",
        "VolumeBinding",
        "VolumeZone",
        "PodTopologySpread",
        "InterPodAffinity",
    )
)

# Upstream MultiPoint registration order (default_plugins.go), which the
# filter-result recording depends on.
_ORDER = (
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
    "VolumeRestrictions",
    "NodeVolumeLimits",
    "VolumeBinding",
    "VolumeZone",
    "PodTopologySpread",
    "InterPodAffinity",
    "ImageLocality",
)


def default_plugins(
    feats: FeaturizedSnapshot, disabled: frozenset[str] = frozenset()
) -> tuple[ScoredPlugin, ...]:
    """Upstream default-profile weights: BalancedAllocation 1, Fit 1,
    ImageLocality 1, NodeAffinity 2, TaintToleration 3 (and
    PodTopologySpread 2, InterPodAffinity 2 once ported).  Plugins named
    in ``disabled`` are left out."""
    missing = sorted(UNPORTED - set(disabled), key=_ORDER.index)
    if missing:
        raise NotImplementedError(
            f"plugin {missing[0]} is not ported to ksim_tpu_torch: "
            f"pass disabled=UNPORTED (or a superset) to run without it"
        )
    build = {
        "NodeUnschedulable": lambda: ScoredPlugin(NodeUnschedulable(), score_enabled=False),
        "NodeName": lambda: ScoredPlugin(NodeName(), score_enabled=False),
        "TaintToleration": lambda: ScoredPlugin(TaintToleration(feats.aux["taints"]), weight=3),
        "NodeAffinity": lambda: ScoredPlugin(NodeAffinity(), weight=2),
        "NodePorts": lambda: ScoredPlugin(NodePorts(), score_enabled=False),
        "NodeResourcesFit": lambda: ScoredPlugin(NodeResourcesFit(feats.resources), weight=1),
        "NodeResourcesBalancedAllocation": lambda: ScoredPlugin(
            NodeResourcesBalancedAllocation(feats.resources), weight=1, filter_enabled=False
        ),
        "ImageLocality": lambda: ScoredPlugin(
            ImageLocality(feats.aux["imagelocality"]), weight=1, filter_enabled=False
        ),
    }
    return tuple(build[name]() for name in _ORDER if name in build and name not in disabled)
