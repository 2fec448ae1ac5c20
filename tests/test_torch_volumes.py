"""The volume plugins (VolumeBinding, VolumeZone, NodeVolumeLimits,
VolumeRestrictions) in the port against ksim_tpu, on the CPU.

The scenarios of tests/test_volumes.py (a bound PV's node affinity, an
unbound Immediate claim and a missing one, WaitForFirstConsumer claims
with static candidates or a provisioner, a zone-labelled PV, attach
limits across commits and when full, ReadWriteOncePod, GCE disks shared
read-only or conflicting read-write) and two random volume clusters go
through both engines with the whole default profile: every recorded
tensor must be equal, element for element (tolerance 0), in exact and
f32 modes, and each scenario must show what the reference's test
asserts."""

from __future__ import annotations

import numpy as np
import pytest

from ksim_tpu_torch.plugins.volumes import (
    ERR_BIND_CONFLICT,
    ERR_DISK_CONFLICT,
    ERR_MAX_VOLUME_COUNT,
    ERR_NODE_CONFLICT,
    ERR_RWOP_CONFLICT,
    ERR_UNBOUND_IMMEDIATE,
    ERR_ZONE_CONFLICT,
)
from tests.test_torch_engine import node_name, reasons, run_both


def _node_affinity(port, res):
    assert node_name(port, res, 0) == "na"
    assert reasons(port, res, "VolumeBinding", 0, 1) == [ERR_NODE_CONFLICT]


def _unbound_and_missing(port, res):
    assert int(res.selected[0]) == -1 and int(res.selected[1]) == -1
    assert reasons(port, res, "VolumeBinding", 0, 0) == [ERR_UNBOUND_IMMEDIATE]
    assert "not found" in reasons(port, res, "VolumeBinding", 1, 0)[0]


def _wffc_static(port, res):
    assert node_name(port, res, 0) == "na"
    assert reasons(port, res, "VolumeBinding", 0, 1) == [ERR_BIND_CONFLICT]


def _wffc_dynamic(port, res):
    assert int(res.selected[0]) >= 0
    assert reasons(port, res, "VolumeBinding", 0, 0) == []


def _zone(port, res):
    assert node_name(port, res, 0) == "na"
    assert reasons(port, res, "VolumeZone", 0, 1) == [ERR_ZONE_CONFLICT]


def _limits_commit(port, res):
    # Capacity 1 + 2: all three fit, the carry enforcing per-node limits.
    assert sorted(node_name(port, res, i) for i in range(3)) == ["n0", "n1", "n1"]


def _limits_full(port, res):
    assert int(res.selected[0]) == -1
    assert reasons(port, res, "NodeVolumeLimits", 0, 0) == [ERR_MAX_VOLUME_COUNT]


def _rwop(port, res):
    assert node_name(port, res, 0) == "n1"
    assert reasons(port, res, "VolumeRestrictions", 0, 0) == [ERR_RWOP_CONFLICT]


def _disk_rw(port, res):
    assert node_name(port, res, 0) == "n1"
    assert reasons(port, res, "VolumeRestrictions", 0, 0) == [ERR_DISK_CONFLICT]


def _disk_ro(port, res):
    assert reasons(port, res, "VolumeRestrictions", 0, 0) == []  # ro + ro shares


EXPECT = {
    "volume_node_affinity": _node_affinity,
    "volume_unbound_and_missing": _unbound_and_missing,
    "volume_wffc_static": _wffc_static,
    "volume_wffc_dynamic": _wffc_dynamic,
    "volume_zone": _zone,
    "volume_limits_commit": _limits_commit,
    "volume_limits_full": _limits_full,
    "volume_rwop": _rwop,
    "volume_disk_rw": _disk_rw,
    "volume_disk_ro": _disk_ro,
}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", sorted(EXPECT))
def test_volume_scenario_matches_reference(case, exact):
    port, res, _ = run_both(case, exact, batch=False)
    EXPECT[case](port, res)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", ["volumes", "volumes2"])
def test_volume_cluster_matches_reference(case, exact):
    port, res, res_b = run_both(case, exact)
    codes = {
        name: set(np.unique(res.reason_bits[:, res.filter_plugin_names.index(name)]).tolist())
        for name in ("VolumeBinding", "NodeVolumeLimits", "VolumeRestrictions", "VolumeZone")
    }
    # The cluster exercises every volume plugin's failures.
    assert all(len(c) > 1 for c in codes.values()), codes
