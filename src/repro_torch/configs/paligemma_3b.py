"""PaliGemma-3B language backbone [arXiv:2407.07726] — SigLIP tower stubbed.

Gemma-2B decoder: 18L, d_model 2048, 8 heads with MQA (kv=1), head_dim 256,
d_ff 16384, vocab 257216; prefix-LM over 256 image tokens.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    is_prefix_lm=True,
    num_prefix_tokens=256,
    tie_embeddings=True,
)
