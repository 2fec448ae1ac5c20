"""Sample out-of-tree plugins (the reference's pkg/nodenumber analogue).

The port of ``ksim_tpu/plugins/samples``: the two score samples run in
the kernels' shared chain (csrc/plugin_chain.cuh ``sample_scores``), the
lifecycle samples on the host."""

from ksim_tpu_torch.plugins.samples.nodenumber import (
    DataProviderScore,
    NodeNumber,
    data_provider_builder,
    encode_node_number,
    node_number_builder,
    provider_encoder,
)

__all__ = [
    "DataProviderScore",
    "NodeNumber",
    "data_provider_builder",
    "encode_node_number",
    "node_number_builder",
    "provider_encoder",
]
