"""The 13 result annotations rendered from the port's record="full"
results equal ksim_tpu's, string for string."""

from __future__ import annotations

import pytest

from ksim_tpu.engine.annotations import ALL_RESULT_KEYS as JAX_KEYS
from ksim_tpu.engine.annotations import RenderCtx as JaxRenderCtx
from ksim_tpu.engine.annotations import render_pod_results as jax_render
from ksim_tpu_torch.engine.annotations import ALL_RESULT_KEYS, RenderCtx, render_pod_results
from tests.test_torch_engine import engines, x64


@pytest.mark.parametrize(
    "case,exact",
    [("seed0", True), ("images_ports", True), ("images_ports", False), ("unschedulable", True)],
)
def test_annotations_match_reference(case, exact):
    assert ALL_RESULT_KEYS == JAX_KEYS and len(ALL_RESULT_KEYS) == 13
    with x64(exact):
        ref_engine, port = engines(case, "full", exact)
        ref, _ = ref_engine.schedule()
    got, _ = port.schedule()
    jctx = JaxRenderCtx(ref_engine._feats, ref_engine._plugins)
    tctx = RenderCtx(port._feats, port._plugins)
    n_pods = len(port._feats.pods.keys)
    scheduled = 0
    for pi in range(n_pods):
        want = jax_render(ref_engine._feats, ref_engine._plugins, ref, pi, ctx=jctx)
        have = render_pod_results(port._feats, port._plugins, got, pi, ctx=tctx)
        assert have == want, pi
        scheduled += "kube-scheduler-simulator.sigs.k8s.io/selected-node" in have
    assert 0 < scheduled <= n_pods
