"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887].

72L, d_model 8192, 64 heads (GQA kv=8), d_ff 24576, vocab 65536;
Mamba:attention 7:1 (one attn layer per period of 8, at offset 4);
MoE every 2 layers: 16 experts top-2.  No RoPE (mamba provides position).
Adafactor optimizer (Adam state would exceed per-chip HBM — DESIGN.md §5).

NOTE: mixer SSM implemented as mamba2-style SSD (d_state 128, head_dim 64);
Jamba ships mamba1 (d_state 16) — recorded as a TPU-native adaptation.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    moe_d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_period=8,
    attn_offset=4,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=8,
    use_rope=False,
    optimizer="adafactor",
)
