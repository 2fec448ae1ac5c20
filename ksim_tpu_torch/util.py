"""Small utilities (the reference's simulator/util package analogue):
the two of ``ksim_tpu/util.py`` the port uses, copied."""

from __future__ import annotations

import threading
import time
from typing import Callable, TypeVar

from ksim_tpu_torch.obs import LatencyHistogram

T = TypeVar("T")


def retry_with_exponential_backoff(
    fn: Callable[[], T],
    *,
    initial: float = 0.1,
    factor: float = 2.0,
    steps: int = 6,
    retriable: tuple[type[BaseException], ...] = (Exception,),
) -> T:
    """Run ``fn`` until it succeeds, backing off exponentially — the
    reference's RetryWithExponentialBackOff (util/retry.go:9-26: 100ms
    initial, 6 steps).  Raises the last error when steps are exhausted."""
    delay = initial
    for attempt in range(steps):
        try:
            return fn()
        except retriable:
            if attempt == steps - 1:
                raise
            time.sleep(delay)
            delay *= factor
    raise AssertionError("unreachable")


class Metrics:
    """Thread-safe counters + latency histograms.

    The reference's observability is the upstream scheduler's Prometheus
    metrics plus klog (SURVEY section 5); this is the in-process
    analogue, exposed as JSON at /api/v1/metrics.  Timers record into
    fixed-bucket log-spaced histograms (ksim_tpu_torch.obs.LatencyHistogram)
    — the former mean-only [total, count] pairs hid multimodal
    latencies (a 5 s cold XLA compile averaged into thousands of 10 ms
    warm passes reads as "15 ms mean"); the snapshot keeps the legacy
    total/count/mean keys and adds buckets + estimated quantiles."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._timers: dict[str, LatencyHistogram] = {}

    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            hist = self._timers.get(name)
            if hist is None:
                hist = self._timers[name] = LatencyHistogram()
            hist.observe(seconds)

    class _Timer:
        def __init__(self, metrics: "Metrics", name: str) -> None:
            self._m, self._name = metrics, name

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._m.observe(self._name, time.perf_counter() - self._t0)
            return False

    def timer(self, name: str) -> "_Timer":
        return self._Timer(self, name)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "timings": {
                    name: hist.snapshot() for name, hist in self._timers.items()
                },
            }
