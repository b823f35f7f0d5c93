"""Mamba2-370M [arXiv:2405.21060] — SSD, attention-free.

48L, d_model 1024, vocab 50280, d_state 128, head_dim 64, expand 2
(d_inner 2048 -> 32 SSD heads), conv kernel 4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    use_rope=False,
)
