from repro_torch.core.engine import WalkEngine, ragged_edge_cdf
from repro_torch.core.graphs import (
    CSRGraph,
    Graph,
    RaggedCSRGraph,
    barabasi_albert,
    dumbbell,
    from_edges,
    ring,
)
from repro_torch.core.transition import MHLJParams

__all__ = [
    "WalkEngine",
    "ragged_edge_cdf",
    "CSRGraph",
    "Graph",
    "RaggedCSRGraph",
    "barabasi_albert",
    "dumbbell",
    "from_edges",
    "ring",
    "MHLJParams",
]
