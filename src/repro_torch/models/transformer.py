"""Dense decoder-only transformer LM (llama/qwen/gemma families) plus the
prefix-LM variant (vlm): prefix embeddings occupy the first
``num_prefix_tokens`` positions and the mask is bidirectional over them.

Covers deepseek-7b, deepseek-67b, minitron-8b, qwen2.5-32b (qkv_bias) and
paligemma-3b's language backbone (is_prefix_lm).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import Model, Stack
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import embedding as emb_mod
from repro_torch.models.layers import mlp as mlp_mod
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_init
from repro_torch.models.model_utils import ParamGroup, scan_layers

__all__ = ["DenseLM", "build_dense_model"]


def _dims(cfg: ArchConfig) -> attn_mod.AttnDims:
    return attn_mod.AttnDims(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope,
        repeat_kv=cfg.gqa_repeat_kv,
    )


class DenseLM(Model):
    """Embedding, ``num_layers`` x (rmsnorm -> attention -> residual,
    rmsnorm -> SwiGLU -> residual), final rmsnorm; tied unembedding."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__(cfg)
        self.dims = _dims(cfg)
        gen = dict(dtype=dtype, device=device, generator=generator)
        self.embedding = ParamGroup(
            **emb_mod.embedding_init(cfg.vocab_size, cfg.d_model, **gen))
        self.layers = Stack(
            nn.ModuleDict({
                "ln1": ParamGroup(**rmsnorm_init(cfg.d_model, device)),
                "attn": ParamGroup(**attn_mod.attn_init(self.dims, **gen)),
                "ln2": ParamGroup(**rmsnorm_init(cfg.d_model, device)),
                "mlp": ParamGroup(**mlp_mod.swiglu_init(cfg.d_model, cfg.d_ff, **gen)),
            })
            for _ in range(cfg.num_layers)
        )
        self.ln_f = ParamGroup(**rmsnorm_init(cfg.d_model, device))

    def _trunk(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        x = emb_mod.embed(self.embedding, batch["tokens"])
        if cfg.is_prefix_lm:
            prefix = batch["prefix_embeddings"].to(x.dtype)
            x = x.clone()
            x[:, : prefix.shape[1]] = prefix
        mode = "prefix" if cfg.is_prefix_lm else "causal"
        prefix_len = cfg.num_prefix_tokens if cfg.is_prefix_lm else 0

        def body(lp, x):
            x = x + attn_mod.attention_full(
                lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), self.dims,
                mode=mode, window=cfg.sliding_window, prefix_len=prefix_len,
                use_flash=cfg.use_kernels,
            )
            return x + mlp_mod.swiglu(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))

        x = scan_layers(body, self.layers, x, remat=cfg.remat)
        return rmsnorm(self.ln_f, x, cfg.norm_eps)

    @torch.no_grad()
    def apply(self, batch: dict) -> torch.Tensor:
        return self._trunk(batch)

    def loss(self, batch: dict) -> tuple:
        x = self._trunk(batch)
        ce = emb_mod.chunked_softmax_xent(
            self.embedding["table"], x, batch["labels"], self.cfg.loss_chunks
        )
        return ce, {"xent": ce}

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        cfg = self.cfg
        window = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                  else cache_len)
        return {"layers": [
            attn_mod.init_kv_cache(batch_size, window, cfg.num_kv_heads,
                                   cfg.resolved_head_dim, self.dtype, self.device)
            for _ in range(cfg.num_layers)
        ]}

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, pos) -> tuple:
        """One token per row of ``tokens`` (B, 1) at absolute position
        ``pos``; updates the KV cache in place.  Returns ``(logits (B, V)
        float32, cache)``."""
        cfg = self.cfg
        x = emb_mod.embed(self.embedding, tokens)  # (B,1,D)
        layer_caches = []
        for lp, layer_cache in zip(self.layers, cache["layers"]):
            h, layer_cache = attn_mod.attention_decode(
                lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), layer_cache,
                pos, self.dims,
            )
            layer_caches.append(layer_cache)
            x = x + h
            x = x + mlp_mod.swiglu(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        logits = emb_mod.unembed_logits(self.embedding, x)[:, 0]
        return logits, {"layers": layer_caches}


def build_dense_model(cfg: ArchConfig, dtype=torch.bfloat16, *, device="cuda",
                      generator=None) -> DenseLM:
    return DenseLM(cfg, dtype, device, generator)
