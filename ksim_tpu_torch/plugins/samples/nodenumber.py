"""NodeNumber sample plugin + the external-data-provider capability.

Two demonstrations of out-of-tree score plugins (reference
simulator/pkg/nodenumber — the UPSTREAM-ORIGINAL semantics kept at
simulator/docs/sample/nodenumber/plugin.go:1-149: score 10 when the pod
name's trailing digit equals the node name's trailing digit, optional
``reverse``; pods/nodes without a digit suffix score 0):

- ``NodeNumber``: the suffix-digit scorer as a batched kernel — suffix
  extraction happens host-side at featurize time (encode_node_number),
  the kernel is one equality compare.
- ``DataProviderScore``: the fork's "renewable-energy-aware" idea done
  right — a *capability*, not hardcoded third-party URLs (SURVEY.md
  fork-specific caution: the fork performs live HTTP calls inside the
  scoring hot path, simulator/pkg/nodenumber/plugin.go:98-138).  The
  provider is any callable ``nodes -> per-node score array``; it runs
  ONCE per featurization on the host (fetch your API there if you like),
  and the kernel just reads the resulting tensor.

Both register through the out-of-tree Builder registry
(scheduler/profile.py) — the WithPlugin analogue.

The port of ``ksim_tpu/plugins/samples/nodenumber.py``: the scores below
are the plain versions, over a block of pods ([B, N] like every plugin
of the port); the kernels score both in csrc/plugin_chain.cuh
``sample_scores``.  Neither has a normalize: final = raw x weight."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ksim_tpu_torch.engine.core import ScoredPlugin
from ksim_tpu_torch.plugins.base import NodeStateView, PodView
from ksim_tpu_torch.state.resources import JSON, name_of

NAME = "NodeNumber"


def _suffix_digit(name: str) -> int:
    return int(name[-1]) if name and name[-1].isdigit() else -1


@dataclass
class NodeNumberTensors:
    """Trailing-digit codes (-1 = no digit suffix)."""

    AXES = {"node_digit": "node", "pod_digit": "pod"}

    node_digit: np.ndarray  # i32 [N]
    pod_digit: np.ndarray  # i32 [P]


def encode_node_number(
    nodes: Sequence[JSON], pods: Sequence[JSON], n_padded: int, p_padded: int
) -> NodeNumberTensors:
    nd = np.full(n_padded, -1, dtype=np.int32)
    pd = np.full(p_padded, -1, dtype=np.int32)
    for i, n in enumerate(nodes):
        nd[i] = _suffix_digit(name_of(n))
    for j, p in enumerate(pods):
        pd[j] = _suffix_digit(name_of(p))
    return NodeNumberTensors(node_digit=nd, pod_digit=pd)


class NodeNumber:
    """Score 10 on suffix-digit match (0 otherwise; reversed if asked)."""

    name = NAME

    def __init__(self, tensors: NodeNumberTensors, *, reverse: bool = False) -> None:
        del tensors  # flows through aux
        self._reverse = reverse

    def static_sig(self) -> tuple:
        return (NAME, self._reverse)

    @property
    def reverse(self) -> bool:
        return self._reverse

    def raw_dtype(self, exact: bool) -> torch.dtype:
        return torch.int32

    def score(self, state: NodeStateView, pods: PodView, aux, ok=None, *, exact=True) -> torch.Tensor:
        a = aux["nodenumber"]
        pod_digit = a["pod_digit"][pods.index][:, None]
        node_digit = a["node_digit"][None, :]
        match = (node_digit == pod_digit) & (pod_digit >= 0) & (node_digit >= 0)
        hit, miss = (0, 10) if self._reverse else (10, 0)
        return torch.where(match, hit, miss).to(torch.int32)


# nodes -> float/int array of per-node scores (any external data source;
# called host-side, once per featurization).
DataProvider = Callable[[Sequence[JSON]], np.ndarray]


@dataclass
class ProvidedTensors:
    AXES = {"provided_score": "node"}

    provided_score: np.ndarray  # i32 [N]


class DataProviderScore:
    """Score nodes by an externally-provided per-node value."""

    def __init__(self, name: str, tensors: ProvidedTensors) -> None:
        self.name = name
        del tensors  # flows through aux

    def static_sig(self) -> tuple:
        return ("DataProviderScore", self.name)

    def raw_dtype(self, exact: bool) -> torch.dtype:
        return torch.int32

    def score(self, state: NodeStateView, pods: PodView, aux, ok=None, *, exact=True) -> torch.Tensor:
        score = aux[f"provider:{self.name}"]["provided_score"].to(torch.int32)
        return score[None, :].expand(pods.index.shape[0], -1)


def node_number_builder(*, reverse: bool = False, weight: int = 1):
    """Out-of-tree Builder for the profile registry:
    ``registry={"NodeNumber": node_number_builder()}`` — the reference's
    ``debuggablescheduler.WithPlugin`` analogue.  Registers its encoder
    through the featurizer's extra-encoder hook."""

    def build(feats, args):
        return ScoredPlugin(
            NodeNumber(feats.aux["nodenumber"], reverse=bool(
                (args or {}).get("reverse", reverse))),
            weight=weight,
            filter_enabled=False,
        )

    return build


def provider_encoder(provider: DataProvider):
    """Featurizer extra-encoder wrapping a data provider: the provider
    runs here, host-side, once per featurization."""

    def encode(nodes, pods, n_padded, p_padded) -> ProvidedTensors:
        values = np.asarray(provider(nodes))
        out = np.zeros(n_padded, dtype=np.int32)
        out[: len(values)] = values.astype(np.int32)
        return ProvidedTensors(provided_score=out)

    return encode


def data_provider_builder(name: str, provider: DataProvider, *, weight: int = 1):
    """Out-of-tree Builder wiring an external data source into a score
    plugin (the capability the fork's renewable-energy scorer needed)."""

    def build(feats, args):
        return ScoredPlugin(
            DataProviderScore(name, feats.aux[f"provider:{name}"]),
            weight=weight,
            filter_enabled=False,
        )

    return build


# Ready-made config-plugin import target: enable NodeNumber purely from a
# KubeSchedulerConfiguration (no code changes to the scheduler binary),
# the reference's wasm-plugin capability (scheduler/config/wasm.go:14-58):
#
#   pluginConfig:
#     - name: NodeNumber
#       args:
#         builderImport: "ksim_tpu_torch.plugins.samples.nodenumber:NODE_NUMBER_PLUGIN"
NODE_NUMBER_PLUGIN = {
    "builder": node_number_builder(),
    "extra_encoders": {"nodenumber": encode_node_number},
}
