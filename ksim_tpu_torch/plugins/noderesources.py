"""NodeResourcesFit and NodeResourcesBalancedAllocation on torch tensors.

Semantics mirror upstream kube-scheduler v1.30:

- Fit filter: ``noderesources/fit.go`` fitsRequest — "Too many pods"
  first, then per-resource ``podRequest > allocatable - requested``
  checks; base resources (cpu/memory/ephemeral-storage) are always
  checked once the pod requests anything at all, extended resources only
  when the pod requests them.
- LeastAllocated score: ``(c - r) * 100 // c`` per resource (0 when
  overcommitted), weight-averaged with integer division, skipping
  zero-allocatable resources; ``r`` uses the *non-zero* request
  accumulation.
- MostAllocated score: ``min(r, c) * 100 // c``, same weighted average.
- RequestedToCapacityRatio score: utilization ``r * 100 // c``
  (overcommit or zero capacity evaluate at 100) fed through the
  broken-linear shape function (Go truncating division), shape scores
  pre-scaled x10; only resources with a POSITIVE score count toward the
  weight sum; the final average is math.Round, exact as
  ``(2n + d) // (2d)``.
- BalancedAllocation score: ``noderesources/balanced_allocation.go`` —
  fractions clamped to 1, ``std`` of the fractions, ``int64((1 - std) *
  100)``.

Modes (``exact`` on Engine): exact mode computes the two-resource
balanced score as an exact rational floor in int64
(``100 - ceil(50*|r1*c2 - r2*c1| / (c1*c2))``); f32 mode, and any other
resource count, takes the float32 path with a +1e-4 floor nudge.

Every integer division below has non-negative operands (the masked-off
branches are clamped first), so floor division equals the kernels'
truncating division; ``floordiv_nonneg`` checks it.
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.plugins.base import (
    MAX_NODE_SCORE,
    FilterOutput,
    NodeStateView,
    PodView,
    floordiv_nonneg,
)
from ksim_tpu_torch.state.resources import BASE_RESOURCES

# Reason-bit layout for Fit: bit 0 = "Too many pods", bit 1+r = resource r.
TOO_MANY_PODS_BIT = 0
RESOURCE_BIT_BASE = 1
MAX_RESOURCE_BITS = 30

FIT_NAME = "NodeResourcesFit"
BALANCED_NAME = "NodeResourcesBalancedAllocation"

STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")


class NodeResourcesFit:
    """Filter + scoring strategy (upstream defaults: LeastAllocated over
    cpu=1, memory=1)."""

    name = FIT_NAME

    def __init__(
        self,
        resources: tuple[str, ...],
        *,
        score_resources: tuple[tuple[str, int], ...] = (("cpu", 1), ("memory", 1)),
        base_resource_count: int = len(BASE_RESOURCES),
        strategy: str = "LeastAllocated",
        shape: tuple[tuple[int, int], ...] = (),
    ) -> None:
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown NodeResourcesFit scoring strategy {strategy!r}")
        if strategy == "RequestedToCapacityRatio":
            if not shape:
                raise ValueError(
                    "RequestedToCapacityRatio requires a non-empty shape "
                    "(upstream validation: at least one UtilizationShapePoint)"
                )
            utils = [u for u, _ in shape]
            if utils != sorted(set(utils)):
                raise ValueError(
                    "RequestedToCapacityRatio shape utilization must be "
                    "strictly increasing (upstream validation)"
                )
        self._resources = resources
        self._base_count = min(base_resource_count, len(resources))
        self._strategy = strategy
        # Shape scores arrive 0..10 and scale x10 to MaxNodeScore
        # (upstream requestedToCapacityRatioScorer).
        self._shape = tuple((int(u), int(s) * 10) for u, s in shape)
        idx = {r: i for i, r in enumerate(resources)}
        self._score_spec = tuple((idx[r], w) for r, w in score_resources if r in idx)
        # Bit 0 = "Too many pods", bit 1+r per resource (capped): the
        # engine downcasts result tensors when all widths fit (core.py).
        self.reason_bit_width = 1 + min(len(resources), MAX_RESOURCE_BITS)
        self.final_score_bound = 100  # all strategies are 0..MaxNodeScore

    def static_sig(self) -> tuple:
        return (FIT_NAME, self._base_count, self._score_spec, self._strategy, self._shape)

    def failure_unresolvable(self, bits: int) -> bool:
        # Upstream returns Unschedulable: preempting pods frees resources.
        return False

    # -- filter -------------------------------------------------------------

    def filter(self, state: NodeStateView, pods: PodView, aux=None) -> FilterOutput:
        free = (state.allocatable - state.requested)[None]  # [1, N, R]
        podr = pods.requests  # [B, R]
        r_axis = torch.arange(podr.shape[1], device=podr.device)
        checked = (r_axis[None, :] < self._base_count) | (podr > 0)  # [B, R]
        # Upstream fitsRequest early-exits only when cpu/memory/ephemeral
        # are all zero AND no scalar-resource key exists — the featurizer
        # computes that predicate host-side (PodView.has_requests).
        insufficient = (
            checked[:, None, :]
            & (podr[:, None, :] > free)
            & pods.has_requests[:, None, None]
        )  # [B, N, R]
        too_many = state.pod_count + 1 > state.allowed_pods  # [N]
        bits = torch.where(too_many, 1 << TOO_MANY_PODS_BIT, 0).to(torch.int32)[None, :]
        # Resources past MAX_RESOURCE_BITS share a saturated bit: or them.
        for r in range(podr.shape[1]):
            bit = 1 << min(r + RESOURCE_BIT_BASE, MAX_RESOURCE_BITS)
            bits = bits | torch.where(insufficient[:, :, r], bit, 0).to(torch.int32)
        return FilterOutput(ok=bits == 0, reason_bits=bits)

    def decode_reasons(self, bits: int) -> list[str]:
        """Reason bitmask -> upstream status reasons, in upstream order."""
        out = []
        if bits & (1 << TOO_MANY_PODS_BIT):
            out.append("Too many pods")
        for i, r in enumerate(self._resources):
            if bits & (1 << min(i + RESOURCE_BIT_BASE, MAX_RESOURCE_BITS)):
                out.append(f"Insufficient {r}")
        return out

    # -- score (strategy dispatch) -------------------------------------------

    def raw_dtype(self, exact: bool) -> torch.dtype:
        return torch.int32

    def score(self, state: NodeStateView, pods: PodView, aux=None, ok=None, *, exact=True):
        req = state.nonzero_requested[None] + pods.nonzero_requests[:, None, :]  # [B, N, R]
        if self._strategy == "RequestedToCapacityRatio":
            return self._score_rtcr(state, req)
        node_score = torch.zeros(req.shape[:2], dtype=torch.int32, device=req.device)
        weight_sum = torch.zeros_like(node_score)
        most = self._strategy == "MostAllocated"
        for ri, w in self._score_spec:
            c = state.allocatable[None, :, ri]
            r = req[:, :, ri]
            has = c > 0
            if most:
                # mostRequestedScore: min(r, c) * 100 // c.
                s = floordiv_nonneg(torch.minimum(r, c) * MAX_NODE_SCORE, c.clamp_min(1))
                s = torch.where(has, s, 0)
            else:
                # leastRequestedScore: (c - r) * 100 // c, 0 when overcommitted.
                s = floordiv_nonneg((c - r).clamp_min(0) * MAX_NODE_SCORE, c.clamp_min(1))
                s = torch.where(has & (r <= c), s, 0)
            node_score = node_score + s.to(torch.int32) * w
            weight_sum = weight_sum + torch.where(has, w, 0).to(torch.int32)
        avg = floordiv_nonneg(node_score, weight_sum.clamp_min(1))
        return torch.where(weight_sum > 0, avg, 0).to(torch.int32)

    def _score_rtcr(self, state: NodeStateView, req: torch.Tensor) -> torch.Tensor:
        """requested_to_capacity_ratio.go: broken-linear over integer
        utilization; zero-capacity/overcommit evaluate at maxUtilization;
        only positive per-resource scores count toward the weight sum;
        final average is math.Round (exact integer (2n + d) // (2d))."""
        node_score = torch.zeros(req.shape[:2], dtype=torch.int32, device=req.device)
        weight_sum = torch.zeros_like(node_score)
        for ri, w in self._score_spec:
            c = state.allocatable[None, :, ri]
            r = req[:, :, ri]
            has = c > 0
            util = torch.where(
                has & (r <= c),
                floordiv_nonneg(r * MAX_NODE_SCORE, c.clamp_min(1)),
                MAX_NODE_SCORE,
            )
            s = self._broken_linear(util)
            # allocable==0 resources are skipped entirely; zero scores are
            # computed but excluded from the weight sum (upstream quirk).
            counts = has & (s > 0)
            node_score = node_score + torch.where(counts, s, 0).to(torch.int32) * w
            weight_sum = weight_sum + torch.where(counts, w, 0).to(torch.int32)
        d = weight_sum.clamp_min(1)
        rounded = floordiv_nonneg(2 * node_score + d, 2 * d)
        return torch.where(weight_sum > 0, rounded, 0).to(torch.int32)

    def _broken_linear(self, p: torch.Tensor) -> torch.Tensor:
        """helper/shape_score.go BuildBrokenLinearFunction with Go's
        truncating integer division (segment slopes may be negative, so
        the sign is split off before the non-negative division), unrolled
        over the static shape."""
        shape = self._shape
        res = torch.full_like(p, shape[-1][1])
        for i in range(len(shape) - 1, -1, -1):
            u_i, s_i = shape[i]
            if i == 0:
                expr = torch.full_like(p, s_i)
            else:
                u_p, s_p = shape[i - 1]
                num = (s_i - s_p) * (p - u_p)
                den = u_i - u_p
                q = torch.where(
                    num >= 0,
                    floordiv_nonneg(num.clamp_min(0), den),
                    -floordiv_nonneg((-num).clamp_min(0), den),
                )
                expr = s_p + q
            res = torch.where(p <= u_i, expr, res)
        return res


class NodeResourcesBalancedAllocation:
    """Balanced-allocation score (upstream defaults: cpu, memory)."""

    final_score_bound = 100  # post-normalize max (MaxNodeScore)
    name = BALANCED_NAME

    def __init__(
        self,
        resources: tuple[str, ...],
        *,
        score_resources: tuple[str, ...] = ("cpu", "memory"),
    ) -> None:
        idx = {r: i for i, r in enumerate(resources)}
        self._spec = tuple(idx[r] for r in score_resources if r in idx)

    def static_sig(self) -> tuple:
        return (BALANCED_NAME, self._spec)

    def filter(self, state: NodeStateView, pods: PodView, aux=None) -> FilterOutput:
        shape = (pods.index.shape[0], state.pod_count.shape[0])
        dev = state.pod_count.device
        return FilterOutput(
            ok=torch.ones(shape, dtype=torch.bool, device=dev),
            reason_bits=torch.zeros(shape, dtype=torch.int32, device=dev),
        )

    def raw_dtype(self, exact: bool) -> torch.dtype:
        return torch.int32

    def score(self, state: NodeStateView, pods: PodView, aux=None, ok=None, *, exact=True):
        req = state.nonzero_requested[None] + pods.nonzero_requests[:, None, :]
        if len(self._spec) == 2 and exact:
            return self._score_exact2(state, req)
        return self._score_float(state, req)

    def _score_exact2(self, state: NodeStateView, req: torch.Tensor) -> torch.Tensor:
        """Exact rational floor for the two-resource case, int64."""
        i1, i2 = self._spec
        c1 = state.allocatable[None, :, i1].to(torch.int64)
        c2 = state.allocatable[None, :, i2].to(torch.int64)
        r1 = torch.minimum(req[:, :, i1].to(torch.int64), c1)
        r2 = torch.minimum(req[:, :, i2].to(torch.int64), c2)
        both = (c1 > 0) & (c2 > 0)
        # Skip zero-allocatable resources (upstream `continue`): with fewer
        # than two fractions std == 0 and the score is exactly 100.
        n = (r1 * c2 - r2 * c1).abs() * 50
        d = (c1 * c2).clamp_min(1)
        score = MAX_NODE_SCORE - floordiv_nonneg(n + d - 1, d)
        return torch.where(both, score, MAX_NODE_SCORE).to(torch.int32)

    def _score_float(self, state: NodeStateView, req: torch.Tensor) -> torch.Tensor:
        """float32, in the reference's operation order: fractions, their
        sum in resource order, mean, squared deviations summed in order,
        / count, sqrt, then floor((1 - std) * 100 + 1e-4)."""
        f32 = torch.float32
        fracs = []
        present = []
        for ri in self._spec:
            c = state.allocatable[None, :, ri].to(f32)
            r = req[:, :, ri].to(f32)
            f = torch.where(c > 0, r / c.clamp_min(1.0), 0.0).clamp_max(1.0)
            fracs.append(f)
            present.append((c > 0).expand_as(f))
        count = torch.zeros(req.shape[:2], dtype=torch.int32, device=req.device)
        total = torch.zeros(req.shape[:2], dtype=f32, device=req.device)
        for f, p in zip(fracs, present):
            count = count + p.to(torch.int32)
            total = total + torch.where(p, f, 0.0)
        count = count.to(f32)
        safe_count = count.clamp_min(1.0)
        mean = total / safe_count
        sq = torch.zeros_like(total)
        for f, p in zip(fracs, present):
            d = f - mean
            sq = sq + torch.where(p, d * d, 0.0)
        var = sq / safe_count
        # Upstream's two-fraction special case |f1 - f2| / 2 equals
        # sqrt(variance) for two points, so sqrt(var) covers all counts.
        std = torch.where(count >= 2, torch.sqrt(var), 0.0)
        # +1e-4 nudge: floor() of a float32 value that is exactly integral
        # in exact arithmetic can otherwise land one below.
        score = torch.floor((1.0 - std) * MAX_NODE_SCORE + 1e-4)
        return score.to(torch.int32)
