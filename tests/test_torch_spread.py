"""PodTopologySpread in the port against ksim_tpu, on the CPU.

The scenarios of tests/test_spread.py (skew, a missing topology key,
ScheduleAnyway spreading, minDomains) and two spread-heavy random
clusters go through both engines with the whole default profile: every
recorded tensor must be equal, element for element (tolerance 0), in
exact and f32 modes, and each scenario must show what the reference's
test asserts.  The exact-mode log-weight table must equal XLA's float64
log bit for bit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ksim_tpu_torch.plugins.podtopologyspread import (
    ERR_REASON_CONSTRAINTS_NOT_MATCH,
    ERR_REASON_NODE_LABEL_NOT_MATCH,
    log_weights,
)
from tests.test_torch_engine import (
    assert_results_equal,
    engines,
    node_name,
    reasons,
    run_both,
    x64,
)

SPREAD = "PodTopologySpread"


def test_exact_log_table_equals_xla_float64_log():
    """The host table the plain version and the kernels share stands in
    for the reference's device jnp.log(dom_num + 2.0) under x64: equal
    bit for bit for every domain count up to 16384 (the main path pads
    5000 nodes to 6144)."""
    n = 16384
    w64, w32 = log_weights(n)
    with x64(True):
        counts = jnp.arange(n + 1, dtype=jnp.int32)
        want = np.asarray(jax.jit(lambda d: jnp.log(d.astype(jnp.float64) + 2.0))(counts))
    assert want.dtype == np.float64 and w64.dtype == np.float64
    np.testing.assert_array_equal(w64.view(np.int64), want.view(np.int64))
    # f32 mode: the reference's own table, float32(numpy.log(k + 2)).
    np.testing.assert_array_equal(w32, np.log(np.arange(n + 1, dtype=np.float64) + 2.0).astype(np.float32))


def _skew(port, res, res_b):
    assert node_name(port, res, 0) == "b1"
    assert reasons(port, res, SPREAD, 0, 0) == [ERR_REASON_CONSTRAINTS_NOT_MATCH]  # zone-a blocked
    assert reasons(port, res, SPREAD, 0, 1) == []


def _missing_key(port, res, res_b):
    assert reasons(port, res_b, SPREAD, 0, 0) == [ERR_REASON_NODE_LABEL_NOT_MATCH]


def _anyway(port, res, res_b):
    assert sorted(int(s) % 2 for s in res.selected[:4]) == [0, 0, 1, 1]


def _min_domains(port, res, res_b):
    # Two domains under minDomains 3: the global minimum counts as 0, so
    # zone-a's one matching pod plus the pod itself is a skew of 2.
    assert node_name(port, res, 0) == "b1"
    assert reasons(port, res, SPREAD, 0, 0) == [ERR_REASON_CONSTRAINTS_NOT_MATCH]


EXPECT = {
    "spread_skew": _skew,
    "spread_missing_key": _missing_key,
    "spread_anyway": _anyway,
    "spread_min_domains": _min_domains,
}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", sorted(EXPECT))
def test_spread_scenario_matches_reference(case, exact):
    port, res, res_b = run_both(case, exact)
    EXPECT[case](port, res, res_b)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", ["spread_affinity", "spread_affinity2"])
def test_spread_heavy_cluster_matches_reference(case, exact):
    port, res, _ = run_both(case, exact)
    si = res.plugin_names.index(SPREAD)
    fi = res.filter_plugin_names.index(SPREAD)
    # The cluster exercises the plugin: skew and missing-key failures,
    # and nonzero raw and normalized scores.
    assert {1, 2} <= set(np.unique(res.reason_bits[:, fi]).tolist())
    assert (res.scores[:, si] != 0).any() and (res.final_scores[:, si] != 0).any()
    with x64(exact):
        ref_engine, port = engines(case, "final", exact)
        ref = ref_engine.evaluate_batch_fused()
    assert_results_equal(ref, port.evaluate_batch_fused())
