"""Kernel D (replay_segment) and row 6's standalone entry (derive_interpod)
against their plain PyTorch versions on a CUDA device, element for
element (tolerance 0), on a small churn replay with the whole default
profile.

Marked ``gpu``; each test skips when there is no CUDA device.  This file
imports neither jax nor ksim_tpu:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_replay.py
"""

from __future__ import annotations

import pytest
import torch

import ksim_tpu_torch.engine.replay as replay_mod
from ksim_tpu_torch.kernels import replay_segment as segment_mod
from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scenario.runner import ScenarioRunner

pytestmark = pytest.mark.gpu

CHURN = dict(n_nodes=200, n_events=800, ops_per_step=50)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


def _replay(device: str, exact: bool, monkeypatch):
    """The churn through the device path; returns (result, the segments'
    (statics, prog, const, ev, state0, final, outs))."""
    segments = []
    kernel = replay_mod.replay_segment

    def capture(st, prog, const, ev, state0):
        held = {k: v.clone() for k, v in state0.items()}
        final, outs = kernel(st, prog, const, ev, state0)
        segments.append((st, prog, const, ev, held, final, outs))
        return final, outs

    monkeypatch.setattr(replay_mod, "replay_segment", capture)
    runner = ScenarioRunner(max_pods_per_pass=1024, pod_bucket_min=128, device_replay=True,
                            device_segment_steps=8, exact=exact, device=device)
    return runner.run(list(churn_scenario(0, **CHURN))), segments


def _steps(res):
    return [(s.scheduled, s.unschedulable, s.pending_after) for s in res.steps]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_replay_segment_kernel_matches_plain(cuda, exact, monkeypatch):
    before = segment_mod.replay_segment.launches
    segment_mod.reset_derive_runs()
    res, segments = _replay(cuda, exact, monkeypatch)
    assert segment_mod.replay_segment.launches - before == len(segments) > 0
    # Row 6 runs once per active step inside kernel D, which counts it.
    assert segment_mod.derive_runs() == sum(int(ev["active"].sum()) for _st, _p, _c, ev, *_ in segments)
    for st, prog, const, ev, state0, final, outs in segments:
        want_final, want_outs = segment_mod.replay_segment_plain(st, prog, const, ev, state0)
        for key in want_outs:
            assert torch.equal(outs[key], want_outs[key]), key
        for key in want_final:
            assert torch.equal(final[key], want_final[key]), key
    cpu_res, _ = _replay("cpu", exact, monkeypatch)
    assert _steps(res) == _steps(cpu_res)


@pytest.mark.parametrize("smem", [True, False], ids=["shared", "global"])
def test_derive_interpod_kernel_matches_plain(cuda, smem, monkeypatch):
    _res, segments = _replay(cuda, False, monkeypatch)
    if not smem:
        monkeypatch.setattr(segment_mod, "DERIVE_SMEM_BYTES", 0)
    for st, _prog, const, _ev, state0, _final, _outs in segments:
        ipa = const["aux"]["interpod"]
        loc = {k: state0["ip_" + k] for k in ("cnt", "eat", "vw")}
        got = segment_mod.derive_interpod(loc, ipa, st.n_tk, st.n_dom)
        want = segment_mod.derive_interpod_plain(loc, ipa, st.n_tk, st.n_dom)
        for key in want:
            assert torch.equal(got[key], want[key]), key
