"""The port's copied featurizer against ksim_tpu's: equal arrays on the
same clusters, so the ten copied state modules cannot drift; and
``snapshot_from_arrays`` carrying a ksim_tpu snapshot into the port.
Every aux family is compared field by field, the ``spread``,
``interpod`` and ``volumes`` ones included, on clusters that fill them."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ksim_tpu.state.featurizer import Featurizer as JaxFeaturizer
from ksim_tpu_torch.state.featurizer import Featurizer, snapshot_from_arrays
from tests.helpers import random_cluster
from test_torch_clusters import CLUSTERS, CLUSTERS_KW, case_inputs, images_ports_cluster


def _assert_same(a, b, where: str) -> None:
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def assert_snapshots_equal(jf, tf) -> None:
    assert tuple(jf.resources) == tuple(tf.resources)
    assert jf.units == tf.units and jf.exact == tf.exact
    for part in ("nodes", "pods"):
        for f in dataclasses.fields(getattr(jf, part)):
            _assert_same(getattr(getattr(jf, part), f.name), getattr(getattr(tf, part), f.name), f"{part}.{f.name}")
    assert set(jf.aux) == set(tf.aux)
    for key, jv in jf.aux.items():
        tv = tf.aux[key]
        assert type(jv).__name__ == type(tv).__name__, key
        for f in dataclasses.fields(jv):
            _assert_same(getattr(jv, f.name), getattr(tv, f.name), f"aux.{key}.{f.name}")


@pytest.mark.parametrize("case", sorted(CLUSTERS) + sorted(CLUSTERS_KW))
def test_featurizer_matches_reference(case):
    nodes, pods, kw = case_inputs(case)
    assert_snapshots_equal(
        JaxFeaturizer().featurize(nodes, pods, **kw), Featurizer().featurize(nodes, pods, **kw)
    )


@pytest.mark.parametrize("case", ["spread_affinity", "volumes"])
def test_snapshot_from_arrays_carries_spread_interpod_and_volumes(case):
    nodes, pods, kw = case_inputs(case)
    jf = JaxFeaturizer().featurize(nodes, pods, **kw)
    tf = snapshot_from_arrays(jf)
    assert_snapshots_equal(jf, tf)
    family = "volumes" if case == "volumes" else "spread"
    # The family is filled, not left at its empty encoding.
    filled = {
        "volumes": lambda v: v.pod_vol.any() and v.pod_pv.any() and v.pod_disk_any.any(),
        "spread": lambda v: v.con_valid.any() and tf.aux["interpod"].req_anti.any(),
    }
    assert filled[family](tf.aux[family])


def test_snapshot_from_arrays_round_trips_reference_snapshot():
    nodes, pods = images_ports_cluster(5)
    jf = JaxFeaturizer().featurize(nodes, pods)
    tf = snapshot_from_arrays(jf)
    assert type(tf).__module__ == "ksim_tpu_torch.state.featurizer"
    assert_snapshots_equal(jf, tf)
    assert_snapshots_equal(jf, snapshot_from_arrays(tf))
    # Owned copies: the port's snapshot never aliases the reference's.
    assert not np.shares_memory(tf.nodes.allocatable, jf.nodes.allocatable)


def test_snapshot_from_arrays_takes_mappings_of_arrays():
    nodes, pods = random_cluster(6, 12, 20)
    jf = JaxFeaturizer().featurize(nodes, pods)

    def as_dict(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}

    plain = {
        "resources": jf.resources,
        "units": jf.units,
        "exact": jf.exact,
        "nodes": as_dict(jf.nodes),
        "pods": as_dict(jf.pods),
        "aux": {k: as_dict(v) for k, v in jf.aux.items()},
    }
    assert_snapshots_equal(jf, snapshot_from_arrays(plain))
