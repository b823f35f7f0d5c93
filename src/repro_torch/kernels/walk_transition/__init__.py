from repro_torch.kernels.walk_transition.kernel import walk_transition_ragged
from repro_torch.kernels.walk_transition.ref import walk_transition_ragged_ref

__all__ = ["walk_transition_ragged", "walk_transition_ragged_ref"]
