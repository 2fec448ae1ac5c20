"""The port's Engine against ksim_tpu's on the eight-plugin profile (the
default profile without the volume, PodTopologySpread and
InterPodAffinity plugins), on the CPU.

One ksim_tpu-featurized snapshot feeds both engines.  Every recorded
tensor (selected, total, final, bits, raw), its dtype and the committed
node state must be equal, element for element (tolerance 0: every output
is an integer or a bool), in exact mode (x64 on in ksim_tpu) and in f32
mode (x64 off)."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest

from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.engine.profiles import default_plugins as jax_default_plugins
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import UNPORTED, default_plugins
from ksim_tpu_torch.state.featurizer import snapshot_from_arrays
from test_torch_clusters import CLUSTERS

RESULT_FIELDS = ("selected", "feasible", "total", "final_scores", "reason_bits", "scores")


@contextlib.contextmanager
def x64(enabled: bool):
    """ksim_tpu's numeric mode: x64 on is exact mode, off is f32 mode."""
    before = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def engines(case: str, record: str, exact: bool):
    nodes, pods = CLUSTERS[case]()
    jf = JaxFeaturizer().featurize(nodes, pods)
    jax_plugins = tuple(sp for sp in jax_default_plugins(jf) if sp.plugin.name not in UNPORTED)
    tf = snapshot_from_arrays(jf)
    port = Engine(tf, default_plugins(tf, disabled=UNPORTED), record=record, exact=exact, device="cpu")
    return JaxEngine(jf, jax_plugins, record=record), port


def assert_results_equal(ref, got) -> None:
    assert got.plugin_names == ref.plugin_names
    assert got.filter_plugin_names == ref.filter_plugin_names
    for name in RESULT_FIELDS:
        a, b = getattr(ref, name), getattr(got, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        assert b.dtype == a.dtype and b.shape == a.shape, (name, b.dtype, a.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)


def assert_states_equal(ref, got) -> None:
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), getattr(got, name)
        assert b.dtype == a.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("record", ["full", "final", "selection"])
def test_schedule_matches_reference(record, exact):
    with x64(exact):
        ref_engine, port = engines("seed0", record, exact)
        ref, ref_state = ref_engine.schedule()
    got, state = port.schedule(chunk=24)  # chunk boundaries inside the queue
    assert_results_equal(ref, got)
    assert_states_equal(ref_state, state)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", ["images_ports", "unschedulable", "ports_commit", "seed2"])
def test_schedule_matches_reference_on_special_clusters(case, exact):
    with x64(exact):
        ref_engine, port = engines(case, "full", exact)
        ref, ref_state = ref_engine.schedule()
    got, state = port.schedule()
    assert_results_equal(ref, got)
    assert_states_equal(ref_state, state)
    if case == "ports_commit":
        # q1 lands on b (a holds the conflicting bound pod); q2 then
        # conflicts on both through the committed carry.
        assert got.selected[0] == 1 and got.selected[1] == -1
    if case == "unschedulable":
        assert (got.selected[: len(port._feats.pods.keys)] < 0).mean() > 0.5


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_evaluate_batch_chunked_matches_reference(exact):
    with x64(exact):
        ref_engine, port = engines("seed1", "full", exact)
        ref = ref_engine.evaluate_batch()
    # 64 padded pods in chunks of 24: a ragged last chunk.
    assert_results_equal(ref, port.evaluate_batch(chunk=24))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("record", ["final", "selection"])
def test_evaluate_batch_fused_matches_reference(record, exact):
    with x64(exact):
        ref_engine, port = engines("images_ports", record, exact)
        ref = ref_engine.evaluate_batch_fused()
    assert_results_equal(ref, port.evaluate_batch_fused())


def test_evaluate_batch_fused_refuses_full_record():
    _, port = engines("ports_commit", "full", True)
    with pytest.raises(ValueError):
        port.evaluate_batch_fused()


def test_engine_refuses_unported_options():
    _, port = engines("ports_commit", "selection", True)
    with pytest.raises(NotImplementedError):
        Engine(port._feats, port._plugins, device="cpu", sampling_k=1)
    with pytest.raises(NotImplementedError, match="PodTopologySpread"):
        default_plugins(port._feats, disabled=UNPORTED - {"PodTopologySpread"})
    from ksim_tpu_torch.engine.core import ScoredPlugin

    hooked = (ScoredPlugin(port._plugins[0].plugin, score_enabled=False, extender=object()),)
    with pytest.raises(NotImplementedError):
        Engine(port._feats, hooked, device="cpu")
