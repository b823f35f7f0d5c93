"""MoE decoder-only transformer (DeepSeekMoE-16B, OLMoE-1B-7B).

DeepSeekMoE structure [arXiv:2401.06066]: fine-grained experts (64 routed,
top-6) + 2 shared experts, first layer dense (d_ff 10944).  OLMoE
[arXiv:2409.02060]: 64 routed top-8, no shared experts, all layers MoE.

The leading dense layers are the reference's Python list
(``dense_layers/0/...``), the MoE stack its stacked leaves
(``moe_layers/...``).  Attention takes the einsum path whatever
``use_kernels`` says, as in the JAX package, whose MoE bodies call
``attention_full`` without ``use_flash``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import Model, Stack
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import embedding as emb_mod
from repro_torch.models.layers import mlp as mlp_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_init
from repro_torch.models.model_utils import (ParamGroup, layer_params,
                                            scan_layers, scan_layers_aux)
from repro_torch.models.transformer import _dims

__all__ = ["MoELM", "build_moe_model", "moe_dims"]


def moe_dims(cfg: ArchConfig) -> moe_mod.MoEDims:
    return moe_mod.MoEDims(
        d_model=cfg.d_model,
        num_experts=cfg.num_experts,
        experts_per_token=cfg.experts_per_token,
        d_expert=cfg.moe_d_ff,
        num_shared_experts=cfg.num_shared_experts,
        capacity_factor=cfg.capacity_factor,
    )


class MoELM(Model):
    """Embedding, ``first_dense_layers`` x (attention, SwiGLU), then the MoE
    stack (attention, MoE FFN), final rmsnorm; tied unembedding.  The loss
    adds 0.01 x the layers' mean load-balance loss (``aux["moe_aux"]``)."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__(cfg)
        self.dims, self.mdims = _dims(cfg), moe_dims(cfg)
        gen = dict(dtype=dtype, device=device, generator=generator)
        n_dense = cfg.first_dense_layers
        d_ff = cfg.dense_d_ff or cfg.d_ff
        self.embedding = ParamGroup(
            **emb_mod.embedding_init(cfg.vocab_size, cfg.d_model, **gen))
        self.moe_layers = Stack(
            nn.ModuleDict({
                "ln1": ParamGroup(**rmsnorm_init(cfg.d_model, device)),
                "attn": ParamGroup(**attn_mod.attn_init(self.dims, **gen)),
                "ln2": ParamGroup(**rmsnorm_init(cfg.d_model, device)),
                "moe": ParamGroup(**moe_mod.moe_init(self.mdims, **gen)),
            })
            for _ in range(cfg.num_layers - n_dense)
        )
        self.ln_f = ParamGroup(**rmsnorm_init(cfg.d_model, device))
        self.dense_layers = nn.ModuleList(
            nn.ModuleDict({
                "ln1": ParamGroup(**rmsnorm_init(cfg.d_model, device)),
                "attn": ParamGroup(**attn_mod.attn_init(self.dims, **gen)),
                "ln2": ParamGroup(**rmsnorm_init(cfg.d_model, device)),
                "mlp": ParamGroup(**mlp_mod.swiglu_init(cfg.d_model, d_ff, **gen)),
            })
            for _ in range(n_dense)
        )

    def _attend(self, lp, x):
        cfg = self.cfg
        return x + attn_mod.attention_full(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), self.dims,
            mode="causal", window=cfg.sliding_window,
        )

    def _trunk(self, batch: dict) -> tuple:
        cfg = self.cfg
        x = emb_mod.embed(self.embedding, batch["tokens"])

        def dense_body(lp, x):
            x = self._attend(lp, x)
            return x + mlp_mod.swiglu(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))

        def moe_body(lp, x):
            x = self._attend(lp, x)
            h, aux = moe_mod.moe_apply(lp["moe"], rmsnorm(lp["ln2"], x, cfg.norm_eps),
                                       self.mdims)
            return x + h, aux["moe_aux_loss"]

        x = scan_layers(dense_body, self.dense_layers, x, remat=cfg.remat,
                        guard=False)
        x, aux = scan_layers_aux(moe_body, self.moe_layers, x, remat=cfg.remat)
        return rmsnorm(self.ln_f, x, cfg.norm_eps), aux

    @torch.no_grad()
    def apply(self, batch: dict) -> torch.Tensor:
        return self._trunk(batch)[0]

    def loss(self, batch: dict) -> tuple:
        x, aux = self._trunk(batch)
        ce = emb_mod.chunked_softmax_xent(
            self.embedding["table"], x, batch["labels"], self.cfg.loss_chunks
        )
        return ce + 0.01 * aux, {"xent": ce, "moe_aux": aux}

    def init_cache(self, batch_size: int, cache_len: int) -> dict:
        cfg = self.cfg
        window = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                  else cache_len)

        def one():
            return attn_mod.init_kv_cache(batch_size, window, cfg.num_kv_heads,
                                          cfg.resolved_head_dim, self.dtype,
                                          self.device)

        return {"moe_layers": [one() for _ in self.moe_layers],
                "dense_layers": [one() for _ in self.dense_layers]}

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, pos) -> tuple:
        """One token per row of ``tokens`` (B, 1) at absolute position
        ``pos``; updates the KV caches in place.  Returns ``(logits (B, V)
        float32, cache)``."""
        cfg = self.cfg
        x = emb_mod.embed(self.embedding, tokens)
        new_cache = {}
        for name in ("dense_layers", "moe_layers"):
            caches = []
            for layer, layer_cache in zip(getattr(self, name), cache[name]):
                lp = layer_params(layer)
                h, layer_cache = attn_mod.attention_decode(
                    lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), layer_cache,
                    pos, self.dims,
                )
                caches.append(layer_cache)
                x = x + h
                normed = rmsnorm(lp["ln2"], x, cfg.norm_eps)
                if name == "moe_layers":
                    h, _ = moe_mod.moe_apply(lp["moe"], normed, self.mdims)
                else:
                    h = mlp_mod.swiglu(lp["mlp"], normed)
                x = x + h
            new_cache[name] = caches
        x = rmsnorm(self.ln_f, x, cfg.norm_eps)
        logits = emb_mod.unembed_logits(self.embedding, x)[:, 0]
        return logits, new_cache


def build_moe_model(cfg: ArchConfig, dtype=torch.bfloat16, *, device="cuda",
                    generator=None) -> MoELM:
    return MoELM(cfg, dtype, device, generator)
