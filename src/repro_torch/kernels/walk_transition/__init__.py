from repro_torch.kernels.walk_transition.kernel import (
    walk_transition,
    walk_transition_bucketed,
    walk_transition_bucketed_compacted,
    walk_transition_ragged,
    walk_transition_sparse,
)
from repro_torch.kernels.walk_transition.ops import (
    mhlj_step_batched,
    mhlj_step_bucketed,
    mhlj_step_dense,
    mhlj_step_oracle,
    mhlj_step_ragged,
    mhlj_step_sparse,
)
from repro_torch.kernels.walk_transition.ref import (
    walk_transition_bucketed_compacted_ref,
    walk_transition_bucketed_ref,
    walk_transition_ragged_ref,
    walk_transition_ref,
    walk_transition_sparse_ref,
)

__all__ = [
    "walk_transition",
    "walk_transition_sparse",
    "walk_transition_bucketed",
    "walk_transition_bucketed_compacted",
    "walk_transition_ragged",
    "walk_transition_ref",
    "walk_transition_sparse_ref",
    "walk_transition_bucketed_ref",
    "walk_transition_bucketed_compacted_ref",
    "walk_transition_ragged_ref",
    "mhlj_step_batched",
    "mhlj_step_sparse",
    "mhlj_step_dense",
    "mhlj_step_bucketed",
    "mhlj_step_ragged",
    "mhlj_step_oracle",
]
