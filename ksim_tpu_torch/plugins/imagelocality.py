"""ImageLocality score plugin.

Upstream kube-scheduler v1.30 ``plugins/imagelocality/image_locality.go``:

- per container image present on the node, ``scaledImageScore`` =
  ``int64(size * numNodes / totalNodes)`` (image-spread discount);
- ``calculatePriority``: clamp the sum to [23MB, 1000MB * containers] and
  map linearly onto [0, MaxNodeScore] with int64 truncation.

No NormalizeScore (upstream registers Score only).  Exact mode computes
in float64, which matches Go; f32 mode in float32.  The per-node sum over
images runs sequentially in image-index order in both modes (a different
order can move a float32 sum across the integer boundary that ``trunc``
cuts at).  Encoding: state/extras.py.
"""

from __future__ import annotations

import torch

from ksim_tpu_torch.plugins.base import MAX_NODE_SCORE, NodeStateView, PodView
from ksim_tpu_torch.state.extras import ImageTensors

NAME = "ImageLocality"

MB = 1024 * 1024
MIN_THRESHOLD = 23 * MB
MAX_CONTAINER_THRESHOLD = 1000 * MB


class ImageLocality:
    # Static reason-bit width: result tensors downcast when every
    # filter plugin's bits fit a narrower dtype (engine/core.py).
    reason_bit_width = 1
    final_score_bound = 100  # post-normalize max (MaxNodeScore)
    name = NAME

    def __init__(self, img: ImageTensors) -> None:
        del img  # all state flows through aux

    def static_sig(self) -> tuple:
        return (NAME,)

    # Score-only plugin: every registration site disables the filter
    # point, so no filter method exists.

    def raw_dtype(self, exact: bool) -> torch.dtype:
        return torch.int32

    def score(self, state: NodeStateView, pods: PodView, aux, ok=None, *, exact=True):
        a = aux["imagelocality"]
        ft = torch.float64 if exact else torch.float32
        # scaledImageScore per vocab image (int64 truncation per image).
        spread = a["image_num_nodes"].to(ft) / a["total_nodes_f"].to(ft)
        scaled = torch.trunc(a["image_size"].to(ft) * spread)  # [I]
        weights = scaled[None, :] * a["pod_image_count"][pods.index].to(ft)  # [B, I]
        has = a["node_has_image"].to(ft)  # [N, I]
        sum_scores = torch.zeros(
            (weights.shape[0], has.shape[0]), dtype=ft, device=has.device
        )
        for i in range(has.shape[1]):
            sum_scores = sum_scores + has[None, :, i] * weights[:, i, None]
        n_cont = a["pod_num_containers"][pods.index].to(ft)[:, None]
        max_threshold = n_cont * MAX_CONTAINER_THRESHOLD
        clamped = torch.minimum(
            sum_scores.clamp_min(MIN_THRESHOLD), max_threshold.clamp_min(MIN_THRESHOLD)
        )
        val = (MAX_NODE_SCORE * (clamped - MIN_THRESHOLD)) / (
            max_threshold - MIN_THRESHOLD
        ).clamp_min(1.0)
        return torch.trunc(val).to(torch.int32)
