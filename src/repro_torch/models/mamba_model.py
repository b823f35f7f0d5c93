"""Mamba-2 attention-free LM (mamba2-370m [arXiv:2405.21060]).

A stack of (rmsnorm -> mamba2 mixer -> residual) with no separate FFN.
Decode carries (conv, ssm-state) caches — O(1) per token.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import Model, Stack
from repro_torch.models.layers import embedding as emb_mod
from repro_torch.models.layers import mamba2 as mamba_mod
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_init
from repro_torch.models.model_utils import ParamGroup, scan_layers

__all__ = ["MambaLM", "build_mamba_model", "mamba_dims_from_cfg"]


def mamba_dims_from_cfg(cfg: ArchConfig) -> mamba_mod.MambaDims:
    return mamba_mod.MambaDims(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        num_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim,
        num_groups=cfg.ssm_groups,
        conv_kernel=cfg.conv_kernel,
        chunk=cfg.ssd_chunk,
    )


class MambaLM(Model):
    """Embedding, ``num_layers`` x (rmsnorm -> mixer -> residual), final
    rmsnorm; tied unembedding."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__(cfg)
        self.mdims = mamba_dims_from_cfg(cfg)
        gen = dict(dtype=dtype, device=device, generator=generator)
        self.embedding = ParamGroup(
            **emb_mod.embedding_init(cfg.vocab_size, cfg.d_model, **gen))
        self.layers = Stack(
            nn.ModuleDict({
                "ln": ParamGroup(**rmsnorm_init(cfg.d_model, device)),
                "mixer": ParamGroup(**mamba_mod.mamba_init(self.mdims, **gen)),
            })
            for _ in range(cfg.num_layers)
        )
        self.ln_f = ParamGroup(**rmsnorm_init(cfg.d_model, device))

    def _trunk(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        x = emb_mod.embed(self.embedding, batch["tokens"])

        def body(lp, x):
            return x + mamba_mod.mamba_apply(
                lp["mixer"], rmsnorm(lp["ln"], x, cfg.norm_eps), self.mdims,
                use_kernel=cfg.use_kernels,
            )

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
        del cache_len  # the SSM state is O(1) in sequence length
        return {"layers": [
            mamba_mod.init_mamba_cache(batch_size, self.mdims, self.dtype, self.device)
            for _ in range(self.cfg.num_layers)
        ]}

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, pos) -> tuple:
        """One token per row of ``tokens`` (B, 1).  Returns ``(logits (B, V)
        float32, new cache)``."""
        cfg = self.cfg
        x = emb_mod.embed(self.embedding, tokens)
        layer_caches = []
        for lp, layer_cache in zip(self.layers, cache["layers"]):
            h, layer_cache = mamba_mod.mamba_decode(
                lp["mixer"], rmsnorm(lp["ln"], x, cfg.norm_eps), layer_cache,
                self.mdims,
            )
            layer_caches.append(layer_cache)
            x = x + h
        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        logits = emb_mod.unembed_logits(self.embedding, x)[:, 0]
        return logits, {"layers": layer_caches}


def build_mamba_model(cfg: ArchConfig, dtype=torch.bfloat16, *, device="cuda",
                      generator=None) -> MambaLM:
    return MambaLM(cfg, dtype, device, generator)
