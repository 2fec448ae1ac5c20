"""Each ported plugin against its ksim_tpu counterpart, on the CPU.

For every pod of a 64-pod x 40-node cluster with taints, node affinity,
images and host ports (plus queue pods that name a node), the filter's
reason codes, the raw score and the normalized score must be equal,
element for element (tolerance 0), in exact mode (x64 on) and f32 mode
(x64 off).  NodeResourcesFit runs all three scoring strategies."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.plugins import (
    imagelocality as j_img,
    nodeaffinity as j_aff,
    nodename as j_nn,
    noderesources as j_res,
    nodeports as j_ports,
    nodeunschedulable as j_unsched,
    tainttoleration as j_taint,
)
from ksim_tpu.engine.core import ScoredPlugin as JaxScoredPlugin
from ksim_tpu.plugins.base import PodView as JaxPodView
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.engine.core import Engine, ScoredPlugin
from ksim_tpu_torch.plugins import (
    imagelocality,
    nodeaffinity,
    nodename,
    noderesources,
    nodeports,
    nodeunschedulable,
    tainttoleration,
)
from ksim_tpu_torch.state.featurizer import snapshot_from_arrays
from tests.helpers import make_pod
from tests.test_torch_engine import x64
from test_torch_clusters import images_ports_cluster

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
)


def _snapshot():
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
    jf = _snapshot()
    tf = snapshot_from_arrays(jf)
    pj, pt = _pair(name, jf, tf)
    P, N = jf.pods.valid.shape[0], jf.nodes.valid.shape[0]
    # A feasibility mask for score/normalize: valid nodes, thinned at
    # random so the normalize maxima run over varying subsets.
    ok = jf.nodes.valid[None, :] & (np.random.default_rng(0).random((P, N)) < 0.7)
    with x64(exact):
        ref_engine = JaxEngine(jf, (JaxScoredPlugin(pj, filter_enabled=False, score_enabled=False),))
        state, pods, aux, _ = ref_engine.example_args
        carry = aux["nodeports"]["conflict_counts"]

        def one(pb, ok_row):
            pod = JaxPodView(pb.requests, pb.nonzero_requests, pb.tolerates_unschedulable, pb.has_requests, pb.index)
            out = {}
            if hasattr(pj, "filter"):
                kw = {"carry": carry} if name == "NodePorts" else {}
                out["bits"] = pj.filter(state, pod, aux, **kw).reason_bits
            if hasattr(pj, "score"):
                raw = pj.score(state, pod, aux, ok=ok_row)
                out["raw"] = raw
                if hasattr(pj, "normalize"):
                    out["norm"] = pj.normalize(raw, ok_row)
            return out

        ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(one))(pods, ok))
    port = Engine(tf, (ScoredPlugin(pt, filter_enabled=False, score_enabled=False),), device="cpu")
    view = port._pods.view()
    ok_t = torch.from_numpy(ok)
    got = {}
    if "bits" in ref:
        kw = {"carry": port._aux["nodeports"]["conflict_counts"]} if name == "NodePorts" else {}
        got["bits"] = pt.filter(port._node_state, view, port._aux, **kw).reason_bits
    if "raw" in ref:
        got["raw"] = pt.score(port._node_state, view, port._aux, ok_t, exact=exact)
        if "norm" in ref:
            got["norm"] = pt.normalize(got["raw"], ok_t)
    assert set(got) == set(ref)
    for key, want in ref.items():
        have = got[key].numpy()
        assert have.dtype == want.dtype, (key, have.dtype, want.dtype)
        np.testing.assert_array_equal(have, want, err_msg=key)
    if name in ("NodeName", "NodePorts", "ImageLocality", "TaintToleration"):
        # The cluster exercises the plugin: not every entry is trivial.
        key = "raw" if name == "ImageLocality" else "bits"
        assert (ref[key] != 0).any(), key
