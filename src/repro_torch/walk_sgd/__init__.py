from repro_torch.walk_sgd.fleet import WalkFleet, run_fleet, sample_initial_nodes
from repro_torch.walk_sgd.trainer import run_rw_sgd, run_rw_sgd_multi

__all__ = [
    "WalkFleet",
    "run_fleet",
    "sample_initial_nodes",
    "run_rw_sgd",
    "run_rw_sgd_multi",
]
