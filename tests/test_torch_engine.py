"""The port's Engine against ksim_tpu's on the whole default profile (all
14 plugins), on the CPU.

One ksim_tpu-featurized snapshot feeds both engines.  Every recorded
tensor (selected, total, final, bits, raw, and under sampling visited and
the next start), its dtype and the committed node state must be equal,
element for element (tolerance 0: every output is an integer or a bool),
in exact mode (x64 on in ksim_tpu) and in f32 mode (x64 off)."""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import pytest

from ksim_tpu.engine.core import Engine as JaxEngine
from ksim_tpu.engine.profiles import default_plugins as jax_default_plugins
from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.state.featurizer import snapshot_from_arrays
from test_torch_clusters import case_inputs

RESULT_FIELDS = (
    "selected", "feasible", "total", "final_scores", "reason_bits", "scores", "visited",
)


@contextlib.contextmanager
def x64(enabled: bool):
    """ksim_tpu's numeric mode: x64 on is exact mode, off is f32 mode."""
    before = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", enabled)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def engines_for(nodes, pods, kw: dict, record: str, exact: bool, sampling_k=None):
    """(ksim_tpu Engine, port Engine) on one ksim_tpu-featurized snapshot,
    both with the whole default profile.  Build under ``x64(exact)``."""
    jf = JaxFeaturizer().featurize(nodes, pods, **kw)
    tf = snapshot_from_arrays(jf)
    port = Engine(tf, default_plugins(tf), record=record, exact=exact, device="cpu", sampling_k=sampling_k)
    return JaxEngine(jf, jax_default_plugins(jf), record=record, sampling_k=sampling_k), port


def engines(case: str, record: str, exact: bool):
    return engines_for(*case_inputs(case), record, exact)


def assert_results_equal(ref, got) -> None:
    assert got.plugin_names == ref.plugin_names
    assert got.filter_plugin_names == ref.filter_plugin_names
    assert got.sampling_next_start == ref.sampling_next_start
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
@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2"])
def test_schedule_matches_reference(case, record, exact):
    with x64(exact):
        ref_engine, port = engines(case, record, exact)
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
@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2"])
def test_evaluate_batch_chunked_matches_reference(case, exact):
    with x64(exact):
        ref_engine, port = engines(case, "full", exact)
        ref = ref_engine.evaluate_batch()
    # Chunks of 24 over a padded pod axis of 32 or 64: a ragged last chunk.
    assert_results_equal(ref, port.evaluate_batch(chunk=24))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("record", ["final", "selection"])
@pytest.mark.parametrize("case", ["images_ports", "seed0", "seed1", "seed2"])
def test_evaluate_batch_fused_matches_reference(case, record, exact):
    with x64(exact):
        ref_engine, port = engines(case, record, exact)
        ref = ref_engine.evaluate_batch_fused()
    assert_results_equal(ref, port.evaluate_batch_fused())


def test_evaluate_batch_fused_refuses_full_record():
    _, port = engines("ports_commit", "full", True)
    with pytest.raises(ValueError):
        port.evaluate_batch_fused()


def test_default_profile_matches_reference_order_and_weights():
    ref_engine, port = engines("seed0", "selection", True)
    want = [(sp.plugin.name, sp.weight, sp.filter_enabled, sp.score_enabled) for sp in ref_engine._plugins]
    have = [(sp.plugin.name, sp.weight, sp.filter_enabled, sp.score_enabled) for sp in port._plugins]
    assert have == want and len(have) == 14


def test_engine_refuses_unported_options():
    _, port = engines("ports_commit", "selection", True)
    from ksim_tpu_torch.engine.core import ScoredPlugin
    from ksim_tpu_torch.plugins.volumes import NodeVolumeLimits

    # PluginExtender hooks are ported (tests/test_torch_hooks.py); a
    # plugin enabled at a stage it has no code for is still refused.
    no_score = (ScoredPlugin(port._plugins[0].plugin, score_enabled=True),)
    assert not hasattr(no_score[0].plugin, "score")
    with pytest.raises(NotImplementedError, match="has no score"):
        Engine(port._feats, no_score, device="cpu")
    # A second, pool-restricted NodeVolumeLimits instance (the legacy
    # EBSLimits et al.) is taken, and the port equals ksim_tpu with it.
    from ksim_tpu.engine.core import ScoredPlugin as JaxScoredPlugin
    from ksim_tpu.plugins.volumes import NodeVolumeLimits as JaxNodeVolumeLimits

    ref_engine, _ = engines("ports_commit", "full", True)
    jf = ref_engine._feats
    ref_legacy = JaxNodeVolumeLimits(jf.aux["volumes"], name="EBSLimits", pools=("aws-ebs",))
    legacy = NodeVolumeLimits(port._feats.aux["volumes"], name="EBSLimits", pools=("aws-ebs",))
    with x64(True):
        ref = JaxEngine(jf, ref_engine._plugins + (JaxScoredPlugin(ref_legacy, score_enabled=False),),
                        record="full").evaluate_batch()
    got = Engine(port._feats, port._plugins + (ScoredPlugin(legacy, score_enabled=False),), device="cpu",
                 record="full").evaluate_batch()
    assert got.filter_plugin_names[-1] == "EBSLimits"
    assert_results_equal(ref, got)
    # sampling_k is checked against the real node count (2 nodes here).
    for k in (0, 3):
        with pytest.raises(ValueError, match="sampling_k"):
            Engine(port._feats, port._plugins, device="cpu", sampling_k=k)


def run_both(case: str, exact: bool, *, batch: bool = True):
    """Schedule (record="full") and, with ``batch``, evaluate_batch on both
    engines; asserts every recorded tensor and the committed state equal
    (tolerance 0).  Returns the port's (engine, schedule result, batch
    result or None)."""
    with x64(exact):
        ref_engine, port = engines(case, "full", exact)
        ref, ref_state = ref_engine.schedule()
        ref_b = ref_engine.evaluate_batch() if batch else None
    got, state = port.schedule()
    assert_results_equal(ref, got)
    assert_states_equal(ref_state, state)
    got_b = None
    if batch:
        got_b = port.evaluate_batch(chunk=16)
        assert_results_equal(ref_b, got_b)
    return port, got, got_b


def reasons(port, res, plugin: str, pi: int, ni: int) -> list[str]:
    """The decoded filter reasons of ``plugin`` for pod pi on node ni."""
    fi = res.filter_plugin_names.index(plugin)
    inst = next(sp.plugin for sp in port._plugins if sp.plugin.name == plugin)
    return inst.decode_reasons(int(res.reason_bits[pi, fi, ni]))


def node_name(port, res, pi: int) -> str | None:
    sel = int(res.selected[pi])
    return port._feats.nodes.names[sel] if sel >= 0 else None


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("block", [256, 8, 24, 1000])
def test_evaluate_batch_fused_block_matches_reference(block, exact):
    """``block`` is taken as the reference takes it (clamped to the pod
    axis, halved until it divides it): 24 becomes 8 on a 32- or 64-row
    axis, 1000 the whole axis; the results do not depend on it."""
    with x64(exact):
        ref_engine, port = engines("seed1", "final", exact)
        ref = ref_engine.evaluate_batch_fused(block=block)
    assert_results_equal(ref, port.evaluate_batch_fused(block=block))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", ["seed0", "seed2"])
def test_evaluate_batch_partition_matches_reference(case, exact):
    """partition=True keeps the reference's contract (chunks keyed by
    their original pod positions, int64) and its results in pod order:
    equal to the reference's partitioned and unpartitioned evaluation,
    row for row."""
    with x64(exact):
        ref_engine, port = engines(case, "full", exact)
        ref = ref_engine.evaluate_batch(chunk=16, partition=True)
        ref_plain = ref_engine.evaluate_batch()
    keys = [idx for idx, _out in port.evaluate_batch_chunks(chunk=16, partition=True)]
    assert all(isinstance(idx, np.ndarray) and idx.dtype == np.int64 for idx in keys)
    np.testing.assert_array_equal(np.concatenate(keys), np.arange(int(port._pods.valid.shape[0])))
    got = port.evaluate_batch(chunk=16, partition=True)
    assert_results_equal(ref, got)
    assert_results_equal(ref_plain, got)
