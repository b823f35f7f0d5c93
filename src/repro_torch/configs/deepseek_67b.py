"""DeepSeek-67B [arXiv:2401.02954] — llama architecture.

95L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 102400.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    source="arXiv:2401.02954",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
)
