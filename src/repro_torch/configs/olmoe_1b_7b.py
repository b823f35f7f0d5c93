"""OLMoE-1B-7B [arXiv:2409.02060].

16L, d_model 2048, 16 heads (kv=16), expert d_ff 1024, vocab 50304,
64 experts top-8, no shared experts, all layers MoE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    moe_d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
)
