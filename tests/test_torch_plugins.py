"""Each ported plugin against its ksim_tpu counterpart, on the CPU.

For every pod of a 64-pod x 40-node cluster with taints, node affinity,
images and host ports (plus queue pods that name a node), the filter's
reason codes, the raw score and the normalized score must be equal,
element for element (tolerance 0), in exact mode (x64 on) and f32 mode
(x64 off).  NodeResourcesFit runs all three scoring strategies.  The
volume plugins run on tests/test_torch_clusters.py's volume cluster,
PodTopologySpread and InterPodAffinity on its spread/affinity cluster,
each against its initial carry."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.plugins import (
    imagelocality as j_img,
    interpodaffinity as j_ipa,
    nodeaffinity as j_aff,
    nodename as j_nn,
    noderesources as j_res,
    nodeports as j_ports,
    nodeunschedulable as j_unsched,
    podtopologyspread as j_spread,
    tainttoleration as j_taint,
    volumes as j_vol,
)
from ksim_tpu.engine.core import ScoredPlugin as JaxScoredPlugin
from ksim_tpu.plugins.base import PodView as JaxPodView
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.engine.core import Engine, ScoredPlugin
from ksim_tpu_torch.plugins import (
    imagelocality,
    interpodaffinity,
    nodeaffinity,
    nodename,
    noderesources,
    nodeports,
    nodeunschedulable,
    podtopologyspread,
    tainttoleration,
    volumes,
)
from ksim_tpu_torch.state.featurizer import snapshot_from_arrays
from tests.helpers import make_pod
from tests.test_torch_engine import x64
from test_torch_clusters import images_ports_cluster, spread_affinity_cluster, volume_cluster

_SHAPE = ((0, 10), (30, 2), (100, 7))  # a falling, then a rising segment


def _pair(name: str, feats_j, feats_t):
    """(ksim_tpu plugin, port plugin) built the same way."""
    res_j, res_t = feats_j.resources, feats_t.resources
    fit = {
        "Fit-LeastAllocated": {},
        "Fit-MostAllocated": {"strategy": "MostAllocated"},
        "Fit-RequestedToCapacityRatio": {"strategy": "RequestedToCapacityRatio", "shape": _SHAPE},
    }
    if name in fit:
        return j_res.NodeResourcesFit(res_j, **fit[name]), noderesources.NodeResourcesFit(res_t, **fit[name])
    return {
        "NodeUnschedulable": lambda: (j_unsched.NodeUnschedulable(), nodeunschedulable.NodeUnschedulable()),
        "NodeName": lambda: (j_nn.NodeName(), nodename.NodeName()),
        "TaintToleration": lambda: (
            j_taint.TaintToleration(feats_j.aux["taints"]),
            tainttoleration.TaintToleration(feats_t.aux["taints"]),
        ),
        "NodeAffinity": lambda: (j_aff.NodeAffinity(), nodeaffinity.NodeAffinity()),
        "NodePorts": lambda: (j_ports.NodePorts(), nodeports.NodePorts()),
        "BalancedAllocation": lambda: (
            j_res.NodeResourcesBalancedAllocation(res_j),
            noderesources.NodeResourcesBalancedAllocation(res_t),
        ),
        "ImageLocality": lambda: (
            j_img.ImageLocality(feats_j.aux["imagelocality"]),
            imagelocality.ImageLocality(feats_t.aux["imagelocality"]),
        ),
        "VolumeBinding": lambda: (
            j_vol.VolumeBinding(feats_j.aux["volumes"]), volumes.VolumeBinding(feats_t.aux["volumes"])
        ),
        "VolumeZone": lambda: (
            j_vol.VolumeZone(feats_j.aux["volumes"]), volumes.VolumeZone(feats_t.aux["volumes"])
        ),
        "NodeVolumeLimits": lambda: (
            j_vol.NodeVolumeLimits(feats_j.aux["volumes"]),
            volumes.NodeVolumeLimits(feats_t.aux["volumes"]),
        ),
        "VolumeRestrictions": lambda: (
            j_vol.VolumeRestrictions(feats_j.aux["volumes"]),
            volumes.VolumeRestrictions(feats_t.aux["volumes"]),
        ),
        "PodTopologySpread": lambda: (
            j_spread.PodTopologySpread(feats_j.aux["spread"]),
            podtopologyspread.PodTopologySpread(feats_t.aux["spread"]),
        ),
        "InterPodAffinity": lambda: (
            j_ipa.InterPodAffinity(feats_j.aux["interpod"]),
            interpodaffinity.InterPodAffinity(feats_t.aux["interpod"]),
        ),
    }[name]()


PLUGINS = (
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "Fit-LeastAllocated",
    "Fit-MostAllocated",
    "Fit-RequestedToCapacityRatio",
    "BalancedAllocation",
    "ImageLocality",
    "VolumeBinding",
    "VolumeZone",
    "NodeVolumeLimits",
    "VolumeRestrictions",
    "PodTopologySpread",
    "InterPodAffinity",
)
VOLUME_PLUGINS = ("VolumeBinding", "VolumeZone", "NodeVolumeLimits", "VolumeRestrictions")


def _snapshot(name: str = ""):
    if name in VOLUME_PLUGINS:
        nodes, pods, kw = volume_cluster(11, n_nodes=20, n_pods=48)
        return JaxFeaturizer().featurize(nodes, pods, **kw)
    if name in ("PodTopologySpread", "InterPodAffinity"):
        nodes, pods, kw = spread_affinity_cluster(12, n_nodes=36, n_pods=64)
        return JaxFeaturizer().featurize(nodes, pods, **kw)
    nodes, pods = images_ports_cluster(7, n_nodes=40, n_pods=64)
    queue = [p for p in pods if not p["spec"].get("nodeName")]
    named = make_pod("named"), make_pod("ghost")
    named[0]["spec"]["nodeName"] = "node-3"
    named[1]["spec"]["nodeName"] = "missing"
    queue = queue[: 64 - len(named)] + list(named)
    return JaxFeaturizer().featurize(nodes, pods, queue_pods=queue)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("name", PLUGINS)
def test_plugin_matches_reference(name, exact):
    jf = _snapshot(name)
    tf = snapshot_from_arrays(jf)
    pj, pt = _pair(name, jf, tf)
    P, N = jf.pods.valid.shape[0], jf.nodes.valid.shape[0]
    # A feasibility mask for score/normalize: valid nodes, thinned at
    # random so the normalize maxima run over varying subsets.
    ok = jf.nodes.valid[None, :] & (np.random.default_rng(0).random((P, N)) < 0.7)
    with x64(exact):
        ref_engine = JaxEngine(jf, (JaxScoredPlugin(pj, filter_enabled=False, score_enabled=False),))
        state, pods, aux, _ = ref_engine.example_args
        carried = hasattr(pj, "carry_init")
        carry = pj.carry_init(aux) if carried else None
        kw = {"carry": carry} if carried else {}

        def one(pb, ok_row):
            pod = JaxPodView(pb.requests, pb.nonzero_requests, pb.tolerates_unschedulable, pb.has_requests, pb.index)
            out = {}
            if hasattr(pj, "filter"):
                out["bits"] = pj.filter(state, pod, aux, **kw).reason_bits
            if hasattr(pj, "score"):
                raw = pj.score(state, pod, aux, ok=ok_row, **kw)
                out["raw"] = raw
                if getattr(pj, "normalize_needs_ctx", False):
                    out["norm"] = pj.normalize(raw, ok_row, state=state, pod=pod, aux=aux, **kw)
                elif hasattr(pj, "normalize"):
                    out["norm"] = pj.normalize(raw, ok_row)
            return out

        ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(one))(pods, ok))
    port = Engine(tf, (ScoredPlugin(pt, filter_enabled=False, score_enabled=False),), device="cpu")
    view = port._pods.view()
    ok_t = torch.from_numpy(ok)
    kw = {"carry": pt.carry_init(port._aux)} if hasattr(pt, "carry_init") else {}
    got = {}
    if "bits" in ref:
        got["bits"] = pt.filter(port._node_state, view, port._aux, **kw).reason_bits
    if "raw" in ref:
        got["raw"] = pt.score(port._node_state, view, port._aux, ok_t, exact=exact, **kw)
        if "norm" in ref:
            got["norm"] = pt.normalize(got["raw"], ok_t, pods=view, aux=port._aux, exact=exact)
    assert set(got) == set(ref)
    for key, want in ref.items():
        have = got[key].numpy()
        assert have.dtype == want.dtype, (key, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=key)
    if name in ("NodeName", "NodePorts", "ImageLocality", "TaintToleration") + VOLUME_PLUGINS + (
        "PodTopologySpread", "InterPodAffinity"
    ):
        # The cluster exercises the plugin: not every entry is trivial.
        key = "raw" if name == "ImageLocality" else "bits"
        assert (ref[key] != 0).any(), key
    if name in ("PodTopologySpread", "InterPodAffinity"):
        assert (ref["raw"] != 0).any() and (ref["norm"] != 0).any()
