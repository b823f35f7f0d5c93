from repro_torch.walk_sgd.comm_model import (
    CommModel,
    comm_report,
    fleet_averaging_traffic,
)
from repro_torch.walk_sgd.fleet import (
    WalkFleet,
    fleet_average,
    load_fleet_checkpoint,
    migrate_walk_nodes,
    run_fleet,
    sample_initial_nodes,
    save_fleet_checkpoint,
)
from repro_torch.walk_sgd.graph_learning import (
    DadaResult,
    personalize_models,
    run_dada,
    similarity_edges,
)
from repro_torch.walk_sgd.trainer import (
    MultiRWSGDResult,
    RWSGDResult,
    run_rw_sgd,
    run_rw_sgd_multi,
)

__all__ = [
    "CommModel",
    "comm_report",
    "fleet_averaging_traffic",
    "WalkFleet",
    "fleet_average",
    "load_fleet_checkpoint",
    "migrate_walk_nodes",
    "run_fleet",
    "sample_initial_nodes",
    "save_fleet_checkpoint",
    "DadaResult",
    "personalize_models",
    "run_dada",
    "similarity_edges",
    "MultiRWSGDResult",
    "RWSGDResult",
    "run_rw_sgd",
    "run_rw_sgd_multi",
]
