from repro_torch.optim.base import (GradientTransformation, OptState,
                                    apply_updates, chain, global_norm,
                                    identity)
from repro_torch.optim.sgd import sgd, momentum
from repro_torch.optim.adam import adam, adamw
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.transforms import (add_weight_decay,
                                          clip_by_global_norm, scale,
                                          scale_by_schedule)
from repro_torch.optim.schedules import (constant_lr, cosine_decay,
                                         inverse_sqrt, warmup_cosine)

__all__ = [
    "GradientTransformation", "OptState", "chain", "identity",
    "apply_updates", "global_norm",
    "sgd", "momentum", "adam", "adamw", "adafactor",
    "clip_by_global_norm", "add_weight_decay", "scale", "scale_by_schedule",
    "constant_lr", "cosine_decay", "warmup_cosine", "inverse_sqrt",
]
