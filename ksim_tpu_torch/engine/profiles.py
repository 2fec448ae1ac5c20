"""The default profile, in upstream order and with upstream weights
(upstream pkg/scheduler/apis/config/v1/default_plugins.go
getDefaultPlugins), as ``ksim_tpu``'s ``default_plugins`` builds it."""

from __future__ import annotations

from ksim_tpu_torch.engine.core import ScoredPlugin
from ksim_tpu_torch.plugins.imagelocality import ImageLocality
from ksim_tpu_torch.plugins.interpodaffinity import InterPodAffinity
from ksim_tpu_torch.plugins.nodeaffinity import NodeAffinity
from ksim_tpu_torch.plugins.nodename import NodeName
from ksim_tpu_torch.plugins.nodeports import NodePorts
from ksim_tpu_torch.plugins.noderesources import (
    NodeResourcesBalancedAllocation,
    NodeResourcesFit,
)
from ksim_tpu_torch.plugins.nodeunschedulable import NodeUnschedulable
from ksim_tpu_torch.plugins.podtopologyspread import PodTopologySpread
from ksim_tpu_torch.plugins.tainttoleration import TaintToleration
from ksim_tpu_torch.plugins.volumes import (
    NodeVolumeLimits,
    VolumeBinding,
    VolumeRestrictions,
    VolumeZone,
)
from ksim_tpu_torch.state.featurizer import FeaturizedSnapshot


def default_plugins(feats: FeaturizedSnapshot) -> tuple[ScoredPlugin, ...]:
    """Upstream default-profile weights: BalancedAllocation 1, Fit 1,
    ImageLocality 1, NodeAffinity 2, PodTopologySpread 2,
    InterPodAffinity 2, TaintToleration 3.  Filter order is upstream's
    MultiPoint registration order, which the filter-result recording
    depends on."""
    vols = feats.aux["volumes"]
    return (
        ScoredPlugin(NodeUnschedulable(), score_enabled=False),
        ScoredPlugin(NodeName(), score_enabled=False),
        ScoredPlugin(TaintToleration(feats.aux["taints"]), weight=3),
        ScoredPlugin(NodeAffinity(), weight=2),
        ScoredPlugin(NodePorts(), score_enabled=False),
        ScoredPlugin(NodeResourcesFit(feats.resources), weight=1),
        ScoredPlugin(
            NodeResourcesBalancedAllocation(feats.resources), weight=1, filter_enabled=False
        ),
        ScoredPlugin(VolumeRestrictions(vols), score_enabled=False),
        ScoredPlugin(NodeVolumeLimits(vols), score_enabled=False),
        ScoredPlugin(VolumeBinding(vols), score_enabled=False),
        ScoredPlugin(VolumeZone(vols), score_enabled=False),
        ScoredPlugin(PodTopologySpread(feats.aux["spread"]), weight=2),
        ScoredPlugin(InterPodAffinity(feats.aux["interpod"]), weight=2),
        ScoredPlugin(ImageLocality(feats.aux["imagelocality"]), weight=1, filter_enabled=False),
    )
