"""PluginExtender device hooks on the port against ksim_tpu, on the CPU,
and the refusal of a hooked profile on the card.

The hooks are Python callables on tensors, written once for each package
(jax.numpy per pod there, torch over a block of pods here) with the same
effect.  One profile carries every device hook alone on a plugin of its
own, and all six together on PodTopologySpread; ``schedule`` and
``evaluate_batch`` equal ksim_tpu's record for record (tolerance 0) in
exact and f32 modes.  A profile with a device hook is refused on a CUDA
device when its Engine is built; one without, or with host hooks only, is
not (tests/test_torch_gpu.py holds the refusal on the card)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.engine.core import PluginExtender as JaxPluginExtender
from ksim_tpu.engine.core import ScoredPlugin as JaxScoredPlugin
from ksim_tpu.engine.profiles import default_plugins as jax_default_plugins
from ksim_tpu.plugins.base import FilterOutput as JaxFilterOutput
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.engine.core import Engine, PluginExtender, ScoredPlugin, kernel_refusal
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.plugins.base import FilterOutput
from ksim_tpu_torch.state.featurizer import Featurizer, snapshot_from_arrays
from tests.helpers import make_node, make_pod, random_cluster
from tests.test_torch_engine import assert_results_equal, assert_states_equal, x64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _veto(node: int, code: int):
    """after_filter: node ``node`` fails with reason code ``code``."""

    def jax_hook(state, pod, aux, out):
        veto = jnp.arange(out.ok.shape[0]) == node
        return JaxFilterOutput(ok=out.ok & ~veto, reason_bits=jnp.where(veto, code, out.reason_bits).astype(jnp.int32))

    def torch_hook(state, pods, aux, out):
        veto = torch.arange(out.ok.shape[-1], device=out.ok.device) == node
        return FilterOutput(ok=out.ok & ~veto, reason_bits=torch.where(veto, code, out.reason_bits).to(torch.int32))

    return jax_hook, torch_hook


# Per plugin: {hook field: (ksim_tpu's hook, the port's)}.  Each plugin
# but PodTopologySpread carries its hooks alone; PodTopologySpread
# carries all six.
HOOKS = {
    # ksim_tpu's test_plugin_extender_hooks: a veto of node 0, raw + 7.
    "NodeResourcesFit": {
        "after_filter": _veto(0, 1),
        "after_score": (lambda s, p, a, x: x + 7, lambda s, p, a, x: x + 7),
    },
    "NodeUnschedulable": {
        "before_filter": (
            lambda s, p, a: (s._replace(unschedulable=jnp.zeros_like(s.unschedulable)), p),
            lambda s, p, a: (s._replace(unschedulable=torch.zeros_like(s.unschedulable)), p),
        ),
    },
    "NodeResourcesBalancedAllocation": {
        "before_score": (
            lambda s, p, a: (s._replace(requested=s.requested // 2), p),
            lambda s, p, a: (s._replace(requested=torch.div(s.requested, 2, rounding_mode="floor")), p),
        ),
    },
    "TaintToleration": {
        "before_normalize": (lambda s, p, a, raw, ok: raw + 1, lambda s, p, a, raw, ok: raw + 1),
    },
    "NodeAffinity": {
        "after_normalize": (
            lambda s, p, a, norm, ok: norm // 2,
            lambda s, p, a, norm, ok: torch.div(norm, 2, rounding_mode="floor"),
        ),
    },
    "PodTopologySpread": {
        "before_filter": (lambda s, p, a: (s, p), lambda s, p, a: (s, p)),
        "after_filter": _veto(1, 4),
        "before_score": (
            lambda s, p, a: (s._replace(pod_count=s.pod_count + 1), p),
            lambda s, p, a: (s._replace(pod_count=s.pod_count + 1), p),
        ),
        "after_score": (lambda s, p, a, x: x + 3, lambda s, p, a, x: x + 3),
        "before_normalize": (lambda s, p, a, raw, ok: raw * 2, lambda s, p, a, raw, ok: raw * 2),
        "after_normalize": (
            lambda s, p, a, norm, ok: norm // 3,
            lambda s, p, a, norm, ok: torch.div(norm, 3, rounding_mode="floor"),
        ),
    },
}


def _hooked(plugins, scored_cls, ext_cls, side: int):
    return tuple(
        scored_cls(
            sp.plugin, sp.weight, sp.filter_enabled, sp.score_enabled,
            extender=ext_cls(**{f: pair[side] for f, pair in HOOKS[sp.plugin.name].items()})
            if sp.plugin.name in HOOKS else None,
        )
        for sp in plugins
    )


def hooked_engines(record: str, exact: bool):
    nodes, pods = random_cluster(3, 24, 64)
    jf = JaxFeaturizer().featurize(nodes, pods)
    tf = snapshot_from_arrays(jf)
    ref = JaxEngine(jf, _hooked(jax_default_plugins(jf), JaxScoredPlugin, JaxPluginExtender, 0), record=record)
    port = Engine(tf, _hooked(default_plugins(tf), ScoredPlugin, PluginExtender, 1), record=record, exact=exact,
                  device="cpu")
    return ref, port


@pytest.mark.parametrize("exact, scan", [(True, True), (False, False)], ids=["exact", "f32"])
def test_every_device_hook_matches_reference(exact, scan):
    """Batch evaluation in both modes, and in exact mode the scan (the
    hooks are the same callables in both modes; each of ksim_tpu's
    programs compiled is what this test's time goes to)."""
    with x64(exact):
        ref_engine, port = hooked_engines("full", exact)
        ref_batch = ref_engine.evaluate_batch()
        if scan:
            ref, ref_state = ref_engine.schedule()
    assert "PluginExtender device hook" in kernel_refusal(port._plugins)
    batch = port.evaluate_batch(chunk=16)
    assert_results_equal(ref_batch, batch)
    # The hooks took effect: the vetoes' codes.
    fi = batch.filter_plugin_names.index("NodeResourcesFit")
    assert (batch.reason_bits[:, fi, 0] == 1).all()
    si = batch.filter_plugin_names.index("PodTopologySpread")
    assert (batch.reason_bits[:, si, 1] == 4).all()
    if scan:
        got, state = port.schedule(chunk=32)
        assert_results_equal(ref, got)
        assert_states_equal(ref_state, state)
        assert not (got.selected == 0).any() and not (got.selected == 1).any()


def test_plugin_extender_hooks():
    """ksim_tpu's tests/test_samples_extenders.py::test_plugin_extender_hooks
    on the port: the hooks run in the engine's chain."""
    nodes = [make_node("a"), make_node("b")]
    queue = [make_pod("p")]
    feats = Featurizer().featurize(nodes, [], queue_pods=queue)
    base = default_plugins(feats)
    seen = {}
    veto = _veto(0, 1)[1]

    def after_filter(state, pods, aux, out):
        seen["filter"] = True
        return veto(state, pods, aux, out)

    def after_score(state, pods, aux, scores):
        seen["score"] = True
        return scores + 7

    wrapped = tuple(
        ScoredPlugin(
            sp.plugin, sp.weight, sp.filter_enabled, sp.score_enabled,
            extender=PluginExtender(after_filter=after_filter, after_score=after_score)
            if sp.plugin.name == "NodeResourcesFit" else None,
        )
        for sp in base
    )
    eng = Engine(feats, wrapped, record="full", device="cpu")
    res = eng.evaluate_batch()
    assert seen == {"filter": True, "score": True}
    fi = res.filter_plugin_names.index("NodeResourcesFit")
    assert int(res.reason_bits[0, fi, 0]) == 1  # vetoed by the hook
    assert int(res.selected[0]) == 1
    plain = Engine(feats, base, record="full", device="cpu").evaluate_batch()
    si = res.plugin_names.index("NodeResourcesFit")
    assert int(res.scores[0, si, 1]) == int(plain.scores[0, si, 1]) + 7


class _NoKernel:
    """A score plugin the kernels have no code for."""

    name = "Custom"

    def raw_dtype(self, exact):
        return torch.int32

    def score(self, state, pods, aux, ok=None, *, exact=True):
        return torch.zeros(ok.shape, dtype=torch.int32)


def test_route_is_decided_from_the_profile():
    """No refusal for the default profile, for host-only hooks and for
    plugins enabled at no device stage; a refusal on a CUDA device, when
    the Engine is built and before any transfer, for any device hook and
    for a filter or score without kernel code.  The CPU runs them all."""
    feats = Featurizer().featurize([make_node("n1")], [], queue_pods=[make_pod("p1")])
    base = default_plugins(feats)
    host_only = PluginExtender(before_permit=lambda pod, node: None)
    device_hook = PluginExtender(after_score=lambda state, pods, aux, scores: scores)
    marker = type("Marker", (), {"name": "Marker"})()

    def with_ext(ext):
        return tuple(
            ScoredPlugin(sp.plugin, sp.weight, sp.filter_enabled, sp.score_enabled,
                         extender=ext if sp.plugin.name == "NodeResourcesFit" else None)
            for sp in base
        )

    cases = {
        "kernel": [base, with_ext(host_only), base + (ScoredPlugin(marker, filter_enabled=False, score_enabled=False),)],
        "plain": [with_ext(device_hook), base + (ScoredPlugin(_NoKernel(), filter_enabled=False),)],
    }
    for route, profiles in cases.items():
        for plugins in profiles:
            assert (kernel_refusal(plugins) is None) == (route == "kernel")
            Engine(feats, plugins, device="cpu").evaluate_batch()
    for plugins, why in zip(cases["plain"], ("NodeResourcesFit carries a PluginExtender device hook",
                                             "plugin Custom has no kernel code")):
        with pytest.raises(NotImplementedError, match=why):
            Engine(feats, plugins, device="cuda")
    # The CPU's plain chain scores the custom plugin.
    res = Engine(feats, cases["plain"][1], device="cpu", record="full").evaluate_batch()
    assert res.plugin_names[-1] == "Custom" and np.all(res.scores[:, -1] == 0)
