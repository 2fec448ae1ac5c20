"""InterPodAffinity in the port against ksim_tpu, on the CPU.

The scenarios of tests/test_interpod.py (the self-affinity escape, a
required term with no match, the topology key required on the node,
incoming and existing anti-affinity, preferred and hard-weight scores,
namespace selectors, required terms sharing or not sharing a topology
key, and the scan's commits) go through both engines with the whole
default profile: every recorded tensor must be equal, element for
element (tolerance 0), in exact and f32 modes, and each scenario must
show what the reference's test asserts."""

from __future__ import annotations

import numpy as np
import pytest

from ksim_tpu_torch.plugins.interpodaffinity import (
    ERR_REASON_AFFINITY_RULES_NOT_MATCH,
    ERR_REASON_ANTI_AFFINITY_RULES_NOT_MATCH,
    ERR_REASON_EXISTING_ANTI_AFFINITY_RULES_NOT_MATCH,
)
from tests.test_torch_engine import node_name, reasons, run_both

IPA = "InterPodAffinity"


def _raw(res, pi, ni):
    return int(res.scores[pi, res.plugin_names.index(IPA), ni])


def _escape(port, res):
    assert reasons(port, res, IPA, 0, 0) == [] and int(res.selected[0]) == 0


def _required_missing(port, res):
    assert reasons(port, res, IPA, 0, 0) == [ERR_REASON_AFFINITY_RULES_NOT_MATCH]
    assert int(res.selected[0]) == -1


def _key_required(port, res):
    assert reasons(port, res, IPA, 0, 0) == []  # escape applies, key present
    assert reasons(port, res, IPA, 0, 1) != []  # missing key always fails


def _anti(port, res):
    assert reasons(port, res, IPA, 0, 0) == [ERR_REASON_ANTI_AFFINITY_RULES_NOT_MATCH]
    assert node_name(port, res, 0) == "b1"


def _existing_anti(port, res):
    assert reasons(port, res, IPA, 0, 0) == [ERR_REASON_EXISTING_ANTI_AFFINITY_RULES_NOT_MATCH]
    assert node_name(port, res, 0) == "b1"


def _preferred(port, res):
    assert [_raw(res, 0, n) for n in range(3)] == [50, 50, 0]
    assert node_name(port, res, 0) in ("a1", "a2")


def _hard_weight(port, res):
    assert [_raw(res, 0, n) for n in range(2)] == [1, 0]


def _namespace_selector(port, res):
    assert reasons(port, res, IPA, 0, 0) != []  # the selector sees team-a
    assert reasons(port, res, IPA, 1, 0) == []  # its own namespace does not


def _shared_key(port, res):
    assert reasons(port, res, IPA, 0, 0) == []


def _distinct_keys(port, res):
    assert reasons(port, res, IPA, 0, 0) == [ERR_REASON_AFFINITY_RULES_NOT_MATCH]


def _sequential_anti(port, res):
    assert sorted(int(s) for s in res.selected[:3]) == [0, 1, 2]


def _sequential_follow(port, res):
    assert all(int(s) >= 0 for s in res.selected[:3])
    assert len({node_name(port, res, i)[0] for i in range(3)}) == 1  # one zone


EXPECT = {
    "interpod_escape": _escape,
    "interpod_required_missing": _required_missing,
    "interpod_key_required": _key_required,
    "interpod_anti": _anti,
    "interpod_existing_anti": _existing_anti,
    "interpod_preferred": _preferred,
    "interpod_hard_weight": _hard_weight,
    "interpod_namespace_selector": _namespace_selector,
    "interpod_shared_key": _shared_key,
    "interpod_distinct_keys": _distinct_keys,
    "interpod_sequential_anti": _sequential_anti,
    "interpod_sequential_follow": _sequential_follow,
}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", sorted(EXPECT))
def test_interpod_scenario_matches_reference(case, exact):
    port, res, _ = run_both(case, exact, batch=False)
    EXPECT[case](port, res)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_interpod_heavy_cluster_matches_reference(exact):
    port, res, res_b = run_both("spread_affinity2", exact)
    fi = res.filter_plugin_names.index(IPA)
    si = res.plugin_names.index(IPA)
    # All three filter checks fail somewhere; scores are not all zero.
    assert {1, 2, 4} <= set(np.unique(res_b.reason_bits[:, fi]).tolist())
    assert (res.final_scores[:, si] != 0).any()
