"""The behavior locks on the port, on the CPU (the plain versions).

Seed 0, 2000 nodes, 6k events: 2524 scheduled / 471 unschedulable, 6430
events applied — on the port's per-pass path (Engine.schedule per step)
and on its device-resident path (kernel D's plain version per segment),
in f32 mode.  The exact-mode 6k locks and the 50k flagship (52781 /
42829) take minutes here and are marked slow, as ksim_tpu marks its own
exact-mode device lock (tests/test_replay_device.py)."""

from __future__ import annotations

import pytest
import torch

from ksim_tpu_torch.scenario.generate import churn_scenario
from ksim_tpu_torch.scenario.runner import ScenarioRunner

LOCK_6K = (6430, 2524, 471)
LOCK_50K = (52781, 42829)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run small tensor ops: one intra-op thread does
    them as fast as many, and keeps the suite's parallel workers from
    oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(n_events: int, *, device_replay: bool, exact: bool):
    runner = ScenarioRunner(
        max_pods_per_pass=1024,
        pod_bucket_min=128,
        device_replay=device_replay,
        device_segment_steps=16,
        exact=exact,
        device="cpu",
    )
    res = runner.run(list(churn_scenario(0, n_nodes=2000, n_events=n_events, ops_per_step=100)))
    return res, runner.replay_driver


def _check_6k(device_replay: bool, exact: bool) -> None:
    res, drv = _run(6000, device_replay=device_replay, exact=exact)
    assert (res.events_applied, res.pods_scheduled, res.unschedulable_attempts) == LOCK_6K
    if device_replay:
        assert drv.device_steps >= 32
        assert drv.device_steps + drv.fallback_steps == len(res.steps)


@pytest.mark.parametrize("device_replay", [False, True], ids=["per_pass", "device"])
def test_6k_lock_f32(device_replay):
    _check_6k(device_replay, exact=False)


@pytest.mark.slow
@pytest.mark.parametrize("device_replay", [False, True], ids=["per_pass", "device"])
def test_6k_lock_exact(device_replay):
    _check_6k(device_replay, exact=True)


@pytest.mark.slow
@pytest.mark.parametrize("device_replay", [False, True], ids=["per_pass", "device"])
def test_50k_lock_f32(device_replay):
    res, drv = _run(50_000, device_replay=device_replay, exact=False)
    assert (res.pods_scheduled, res.unschedulable_attempts) == LOCK_50K
    if device_replay:
        assert drv.device_steps + drv.fallback_steps == len(res.steps)
