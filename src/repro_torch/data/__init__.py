from repro_torch.data.lm_data import NodeTokenData, make_node_token_shards
from repro_torch.data.pipeline import NodeDataPipeline
from repro_torch.data.synthetic import (
    RegressionData,
    make_heterogeneous_regression,
    make_homogeneous_regression,
)

__all__ = [
    "NodeTokenData",
    "make_node_token_shards",
    "NodeDataPipeline",
    "RegressionData",
    "make_heterogeneous_regression",
    "make_homogeneous_regression",
]
