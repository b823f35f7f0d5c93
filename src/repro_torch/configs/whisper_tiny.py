"""Whisper-tiny [arXiv:2212.04356] — enc-dec; conv frontend stubbed.

4L encoder + 4L decoder, d_model 384, 6 heads (kv=6), d_ff 1536,
vocab 51865, encoder length 1500 frames (stub supplies frame embeddings).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    num_encoder_layers=4,
    encoder_len=1500,
    use_rope=False,
    act="gelu",
)
