"""Permit extension point (host-side).

The reference wraps Permit plugins and records each plugin's status plus
its wait timeout onto the pod's ``permit-result`` /
``permit-result-timeout`` annotations (reference
simulator/scheduler/plugin/wrappedplugin.go:582-611: success ->
"success", wait -> "wait", otherwise the status message; the timeout is
recorded as Go's ``time.Duration.String()``).  The upstream framework
then parks a Wait pod until every waiting plugin allows it, rejects it
when any plugin rejects, and times each plugin's wait out individually
(k8s.io/kubernetes pkg/scheduler/framework/runtime waitingPodsMap).

Permit plugins here are host-side objects (the decision is per selected
(pod, node) AFTER scoring — nothing to batch), declared by giving a
plugin object a ``permit(pod, node_name) -> PermitResult`` method; the
scheduler service runs them post-selection and owns the waiting-pod map
(allow/reject API + timeout enforcement).
"""

from __future__ import annotations

from dataclasses import dataclass

SUCCESS = "success"
WAIT = "wait"
REJECT = "reject"

# Upstream maxTimeout for Permit waits (framework/runtime: 15 minutes).
MAX_WAIT_SECONDS = 15 * 60


@dataclass(frozen=True)
class PermitResult:
    """One Permit plugin's verdict for (pod, node).

    status: "success" allows immediately; "wait" parks the pod for up to
    ``timeout_seconds``; anything else rejects with ``message`` recorded
    (upstream non-success non-wait statuses: Unschedulable / Error).
    """

    status: str = SUCCESS
    timeout_seconds: float = 0.0
    message: str = ""

    @classmethod
    def allow(cls) -> "PermitResult":
        return cls(SUCCESS)

    @classmethod
    def wait(cls, timeout_seconds: float) -> "PermitResult":
        return cls(WAIT, min(timeout_seconds, MAX_WAIT_SECONDS))

    @classmethod
    def reject(cls, message: str = "") -> "PermitResult":
        return cls(REJECT, 0.0, message)


def go_duration_str(seconds: float) -> str:
    """Go ``time.Duration.String()`` for a non-negative duration —
    byte-compatible with what the reference records in
    ``permit-result-timeout`` (store.go:549-560 ``timeout.String()``)."""
    ns = round(seconds * 1e9)
    if ns == 0:
        return "0s"
    neg = ns < 0
    ns = abs(ns)
    if ns < 1000:
        s = f"{ns}ns"
    elif ns < 1000_000:
        s = _frac(ns, 1000) + "µs"
    elif ns < 1000_000_000:
        s = _frac(ns, 1000_000) + "ms"
    else:
        total_s, frac_ns = divmod(ns, 1000_000_000)
        sec_part = (
            str(total_s % 60)
            if frac_ns == 0
            else _frac((total_s % 60) * 1000_000_000 + frac_ns, 1000_000_000)
        )
        s = sec_part + "s"
        minutes = total_s // 60
        if minutes:
            s = f"{minutes % 60}m" + s
            hours = minutes // 60
            if hours:
                s = f"{hours}h" + s
    return ("-" + s) if neg else s


def _frac(value: int, unit: int) -> str:
    """Integer + trimmed fraction, Go fmtFrac style (e.g. 1500/1000 ->
    "1.5")."""
    whole, rem = divmod(value, unit)
    if rem == 0:
        return str(whole)
    frac = str(rem).rjust(len(str(unit)) - 1, "0").rstrip("0")
    return f"{whole}.{frac}"
