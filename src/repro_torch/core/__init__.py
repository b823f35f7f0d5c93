from repro_torch.core.engine import LAYOUTS, WalkEngine, ragged_edge_cdf
from repro_torch.core.graphs import (
    BucketedCSRGraph,
    CSRGraph,
    DegreeBucket,
    Graph,
    RaggedCSRGraph,
    barabasi_albert,
    dumbbell,
    erdos_renyi,
    from_edges,
    grid2d,
    ring,
    sbm,
)
from repro_torch.core.transition import MHLJParams

__all__ = [
    "LAYOUTS",
    "WalkEngine",
    "ragged_edge_cdf",
    "BucketedCSRGraph",
    "CSRGraph",
    "DegreeBucket",
    "Graph",
    "RaggedCSRGraph",
    "barabasi_albert",
    "dumbbell",
    "erdos_renyi",
    "from_edges",
    "grid2d",
    "ring",
    "sbm",
    "MHLJParams",
]
