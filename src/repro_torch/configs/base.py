"""Architecture config schema + input-shape suite.

Every assigned architecture gets one ``<id>.py`` in this package exporting
``CONFIG`` (exact assigned numbers, source cited) and the framework builds the
model from it.  ``reduced()`` derives the CPU smoke-test variant (<=2 layers,
d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ArchConfig", "ShapeConfig", "INPUT_SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str  # citation
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (assigned d_ff for moe archs)
    moe_every: int = 1  # MoE FFN every k-th layer (jamba: 2)
    first_dense_layers: int = 0  # deepseek-moe: layer 0 is dense
    dense_d_ff: int = 0  # FFN dim of the dense layers in a MoE stack
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_kernel: int = 4
    ssd_chunk: int = 256
    attn_period: int = 0  # hybrid: one attention layer per `attn_period` layers
    attn_offset: int = 0  # position of the attn layer within the period
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    gqa_repeat_kv: bool = False  # §Perf: Megatron-style kv repeat (attention.py)
    use_kernels: bool = False  # the CUDA kernels (flash attention / SSD) in layers
    sliding_window: int = 0  # 0 = full attention; >0 = window (long_500k variant)
    # --- enc-dec (audio) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_len: int = 0  # whisper: 1500 frames
    # --- vlm ---
    is_prefix_lm: bool = False
    num_prefix_tokens: int = 0  # paligemma: 256 image tokens
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "swiglu"  # swiglu | gelu
    use_rope: bool = True
    optimizer: str = "adamw"  # adamw | adafactor (jamba-398b: memory)
    remat: str = "full"  # full | dots | none  (activation checkpoint policy)
    loss_chunks: int = 8

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, v = self.d_model, self.vocab_size
        n_emb = v * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads * 2 + self.num_kv_heads * 2)
        dense_ffn = 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
        moe_ffn = (
            self.num_experts * 3 * d * self.moe_d_ff
            + self.num_shared_experts * 3 * d * self.moe_d_ff
            + d * self.num_experts
        )
        mamba = (
            d * (self.d_inner * 2 + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads)
            + self.d_inner * d
        )
        total = n_emb
        for layer in range(self.num_layers):
            if self.family in ("ssm",):
                total += mamba
                continue
            is_attn = True
            if self.attn_period:
                is_attn = layer % self.attn_period == self.attn_offset
            total += attn if is_attn else (mamba if self.family == "hybrid" else 0)
            if self.num_experts and layer >= self.first_dense_layers and (
                (layer - self.first_dense_layers) % self.moe_every == 0 or self.moe_every == 1
            ):
                total += moe_ffn
            elif self.family != "ssm":
                total += dense_ffn if not self.num_experts else 3 * d * (self.dense_d_ff or self.d_ff)
        if self.is_encoder_decoder:
            enc = self.num_encoder_layers * (attn + dense_ffn)
            total += enc + self.num_layers * attn  # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        inactive_per_moe_layer = (
            (self.num_experts - self.experts_per_token) * 3 * d * self.moe_d_ff
        )
        n_moe_layers = sum(
            1
            for layer in range(self.num_layers)
            if layer >= self.first_dense_layers
            and ((layer - self.first_dense_layers) % self.moe_every == 0 or self.moe_every == 1)
        )
        return int(full - n_moe_layers * inactive_per_moe_layer)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts, small vocab."""
    d_model = min(cfg.d_model, 256)
    num_heads = min(cfg.num_heads, 4)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads, 2))
    num_layers = min(cfg.num_layers, 2 if not cfg.attn_period else cfg.attn_period)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        dense_d_ff=min(cfg.dense_d_ff, 512) if cfg.dense_d_ff else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_len=min(cfg.encoder_len, 64) if cfg.encoder_len else 0,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 16) if cfg.num_prefix_tokens else 0,
        ssd_chunk=32,
        loss_chunks=1,
        attn_period=min(cfg.attn_period, num_layers) if cfg.attn_period else 0,
        attn_offset=min(cfg.attn_offset, num_layers - 1) if cfg.attn_period else 0,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
    )
