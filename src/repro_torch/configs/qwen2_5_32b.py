"""Qwen2.5-32B [hf:Qwen/Qwen2.5-0.5B card family].

64L, d_model 5120, 40 heads (GQA kv=8), d_ff 27648, vocab 152064, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
)
