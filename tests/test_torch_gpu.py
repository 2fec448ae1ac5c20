"""Kernels A (schedule_scan), B (batch_eval) and C (schedule_sampled)
against their plain PyTorch versions on a CUDA device, element for
element (tolerance 0), at small size, with the whole default profile.

Marked ``gpu``; each test skips when there is no CUDA device.  This file
imports neither jax nor ksim_tpu, so it runs on a machine with a card
and without jax:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ksim_tpu_torch.engine.core import Engine
from ksim_tpu_torch.engine.profiles import default_plugins
from ksim_tpu_torch.kernels.batch_eval import batch_eval, batch_eval_plain
from ksim_tpu_torch.kernels.schedule_sampled import schedule_sampled, schedule_sampled_plain
from ksim_tpu_torch.kernels.schedule_scan import schedule_scan, schedule_scan_plain
from ksim_tpu_torch.state.featurizer import Featurizer
from test_torch_clusters import case_inputs

pytestmark = pytest.mark.gpu

FIELDS = ("selected", "total", "final_scores", "reason_bits", "scores", "visited")


class PlainEngine(Engine):
    """The same engine running the kernels' plain versions on the card."""

    _scan_fn = staticmethod(schedule_scan_plain)
    _sampled_fn = staticmethod(schedule_sampled_plain)
    _batch_fn = staticmethod(batch_eval_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


def _pair(case, record, exact, device, sampling_k=None):
    nodes, pods, kw = case_inputs(case)
    feats = Featurizer().featurize(nodes, pods, **kw)
    plugins = default_plugins(feats)
    kw = dict(record=record, exact=exact, device=device, sampling_k=sampling_k)
    return Engine(feats, plugins, **kw), PlainEngine(feats, plugins, **kw)


def _assert_equal(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.sampling_next_start == b.sampling_next_start


CASES = ["seed0", "images_ports", "unschedulable", "ports_commit", "spread_affinity", "volumes"]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("record", ["full", "final", "selection"])
@pytest.mark.parametrize("case", CASES)
def test_schedule_scan_kernel_matches_plain(cuda, case, record, exact):
    kernel, plain = _pair(case, record, exact, cuda)
    before = schedule_scan.launches
    got, state = kernel.schedule(chunk=16)
    assert schedule_scan.launches > before
    want, want_state = plain.schedule(chunk=16)
    _assert_equal(got, want)
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name), getattr(want_state, name), err_msg=name)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("case", ["seed1", "images_ports", "spread_affinity2", "volumes2"])
def test_batch_eval_kernel_matches_plain(cuda, case, exact):
    kernel, plain = _pair(case, "full", exact, cuda)
    before = batch_eval.launches
    got = kernel.evaluate_batch(chunk=16)
    assert batch_eval.launches > before
    _assert_equal(got, plain.evaluate_batch(chunk=16))
    kernel, plain = _pair(case, "final", exact, cuda)
    _assert_equal(kernel.evaluate_batch_fused(), plain.evaluate_batch_fused())


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
@pytest.mark.parametrize("record", ["full", "selection"])
@pytest.mark.parametrize("case,k,start", [
    ("seed0", 7, 5), ("seed0", 40, -3), ("spread_affinity", 5, 100), ("volumes", 3, 2),
])
def test_schedule_sampled_kernel_matches_plain(cuda, case, k, start, record, exact):
    kernel, plain = _pair(case, record, exact, cuda, sampling_k=k)
    before = schedule_sampled.launches
    got, state = kernel.schedule(chunk=16, sampling_start=start)
    assert schedule_sampled.launches > before
    want, want_state = plain.schedule(chunk=16, sampling_start=start)
    _assert_equal(got, want)
    for name in state._fields:
        np.testing.assert_array_equal(getattr(state, name), getattr(want_state, name), err_msg=name)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_kernels_with_global_domain_scratch_match_plain(cuda, exact, monkeypatch):
    """PodTopologySpread's per-domain scratch in global memory (where it
    outgrows its shared-memory budget) instead of shared memory."""
    from ksim_tpu_torch.kernels import chain

    monkeypatch.setattr(chain, "DOMAIN_SMEM_BYTES", 0)
    kernel, plain = _pair("spread_affinity", "full", exact, cuda)
    _assert_equal(kernel.schedule(chunk=16)[0], plain.schedule(chunk=16)[0])
    _assert_equal(kernel.evaluate_batch(chunk=16), plain.evaluate_batch(chunk=16))
    kernel, plain = _pair("spread_affinity", "full", exact, cuda, sampling_k=6)
    _assert_equal(kernel.schedule(sampling_start=9)[0], plain.schedule(sampling_start=9)[0])
