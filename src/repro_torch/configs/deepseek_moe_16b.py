"""DeepSeekMoE-16B [arXiv:2401.06066]: fine-grained experts.

28L, d_model 2048, 16 heads (MHA kv=16), expert d_ff 1408, vocab 102400,
64 routed experts top-6 + 2 shared experts, first layer dense (d_ff 10944).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    dense_d_ff=10944,
    vocab_size=102400,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    first_dense_layers=1,
)
