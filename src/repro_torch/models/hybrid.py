"""Hybrid Mamba+Attention+MoE LM — Jamba-1.5-Large [arXiv:2403.19887].

Jamba block structure: periods of ``attn_period`` (=8) layers with ONE
attention layer (at ``attn_offset``) and 7 mamba layers; an FFN follows every
mixer, alternating dense / MoE (``moe_every``=2, MoE on odd layers).  No RoPE:
position information comes from the mamba mixers (Jamba convention).

Each period holds its kinds' stacks (``periods.{p}.mamba.{j}``, ...), the
reference's ``(P, n, ...)`` leaves (``models.base.tree_of``).  The mamba
mixers take ``use_kernel=cfg.use_kernels`` (the CUDA ``ssd_scan``); the
attention mixer takes the einsum path, as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import Model, Stack
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import embedding as emb_mod
from repro_torch.models.layers import mamba2 as mamba_mod
from repro_torch.models.layers import mlp as mlp_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers.norms import rmsnorm, rmsnorm_init
from repro_torch.models.mamba_model import mamba_dims_from_cfg
from repro_torch.models.model_utils import ParamGroup, layer_params, scan_layers_aux
from repro_torch.models.moe_transformer import moe_dims
from repro_torch.models.transformer import _dims

__all__ = ["HybridLM", "build_hybrid_model", "period_structure"]


def period_structure(cfg: ArchConfig) -> tuple:
    """Static per-period layout: ``[(mixer, mixer index, ffn, ffn index)]``
    per sublayer, and the count of each kind."""
    layout = []
    counters = {"mamba": 0, "moe": 0, "mlp": 0}
    for i in range(cfg.attn_period):
        mixer = "attn" if i == cfg.attn_offset else "mamba"
        mixer_idx = counters["mamba"] if mixer == "mamba" else 0
        if mixer == "mamba":
            counters["mamba"] += 1
        ffn = "moe" if (cfg.num_experts and i % cfg.moe_every == cfg.moe_every - 1) else "mlp"
        ffn_idx = counters[ffn]
        counters[ffn] += 1
        layout.append((mixer, mixer_idx, ffn, ffn_idx))
    return layout, counters


class HybridLM(Model):
    """Embedding, ``num_layers / attn_period`` periods, final rmsnorm; tied
    unembedding.  The loss adds 0.01 x the periods' mean of each period's
    MoE aux averaged over its MoE sublayers (``aux["moe_aux"]``)."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__(cfg)
        if cfg.num_layers % cfg.attn_period != 0:
            raise ValueError("hybrid num_layers must be divisible by attn_period")
        self.layout, self.counts = period_structure(cfg)
        self.adims, self.mdims, self.edims = (_dims(cfg), mamba_dims_from_cfg(cfg),
                                              moe_dims(cfg))
        gen = dict(dtype=dtype, device=device, generator=generator)

        def norm():
            return ParamGroup(**rmsnorm_init(cfg.d_model, device))

        def stack(n, name, init):
            return Stack(
                nn.ModuleDict({"ln": norm(), name: ParamGroup(**init())})
                for _ in range(n))

        self.embedding = ParamGroup(
            **emb_mod.embedding_init(cfg.vocab_size, cfg.d_model, **gen))
        self.periods = Stack(
            nn.ModuleDict({
                "mamba": stack(self.counts["mamba"], "mixer",
                               lambda: mamba_mod.mamba_init(self.mdims, **gen)),
                "attn": nn.ModuleDict({
                    "ln": norm(),
                    "attn": ParamGroup(**attn_mod.attn_init(self.adims, **gen))}),
                "moe": stack(self.counts["moe"], "moe",
                             lambda: moe_mod.moe_init(self.edims, **gen)),
                "mlp": stack(self.counts["mlp"], "mlp",
                             lambda: mlp_mod.swiglu_init(cfg.d_model, cfg.d_ff, **gen)),
            })
            for _ in range(cfg.num_layers // cfg.attn_period)
        )
        self.ln_f = ParamGroup(**rmsnorm_init(cfg.d_model, device))

    def _ffn(self, pp, ffn, f_idx, x) -> tuple:
        """The sublayer's FFN with its residual, and its MoE aux (or None)."""
        eps = self.cfg.norm_eps
        lp = pp[ffn][f_idx]
        if ffn == "moe":
            h, aux = moe_mod.moe_apply(lp["moe"], rmsnorm(lp["ln"], x, eps),
                                       self.edims)
            return x + h, aux["moe_aux_loss"]
        return x + mlp_mod.swiglu(lp["mlp"], rmsnorm(lp["ln"], x, eps)), None

    def _trunk(self, batch: dict) -> tuple:
        cfg = self.cfg
        eps = cfg.norm_eps

        def period_body(pp, x):
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
            for mixer, m_idx, ffn, f_idx in self.layout:
                if mixer == "attn":
                    lp = pp["attn"]
                    h = attn_mod.attention_full(
                        lp["attn"], rmsnorm(lp["ln"], x, eps), self.adims,
                        mode="causal", window=cfg.sliding_window,
                    )
                else:
                    lp = pp["mamba"][m_idx]
                    h = mamba_mod.mamba_apply(
                        lp["mixer"], rmsnorm(lp["ln"], x, eps), self.mdims,
                        use_kernel=cfg.use_kernels,
                    )
                x, aux = self._ffn(pp, ffn, f_idx, x + h)
                if aux is not None:
                    aux_total = aux_total + aux
            return x, aux_total / max(self.counts["moe"], 1)

        x = emb_mod.embed(self.embedding, batch["tokens"])
        x, aux = scan_layers_aux(period_body, self.periods, x, remat=cfg.remat)
        return rmsnorm(self.ln_f, x, eps), aux

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
        """Per period: one attention KV cache and a mamba cache per mamba
        sublayer."""
        cfg = self.cfg
        window = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                  else cache_len)
        return {"periods": [{
            "attn": attn_mod.init_kv_cache(batch_size, window, cfg.num_kv_heads,
                                           cfg.resolved_head_dim, self.dtype,
                                           self.device),
            "mamba": [mamba_mod.init_mamba_cache(batch_size, self.mdims, self.dtype,
                                                 self.device)
                      for _ in range(self.counts["mamba"])],
        } for _ in self.periods]}

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, pos) -> tuple:
        """One token per row of ``tokens`` (B, 1) at absolute position
        ``pos``.  Returns ``(logits (B, V) float32, new cache)``."""
        eps = self.cfg.norm_eps
        x = emb_mod.embed(self.embedding, tokens)
        new_periods = []
        for period, pc in zip(self.periods, cache["periods"]):
            pp = layer_params(period)
            new = {"attn": None, "mamba": list(pc["mamba"])}
            for mixer, m_idx, ffn, f_idx in self.layout:
                if mixer == "attn":
                    lp = pp["attn"]
                    h, new["attn"] = attn_mod.attention_decode(
                        lp["attn"], rmsnorm(lp["ln"], x, eps), pc["attn"], pos,
                        self.adims,
                    )
                else:
                    lp = pp["mamba"][m_idx]
                    h, new["mamba"][m_idx] = mamba_mod.mamba_decode(
                        lp["mixer"], rmsnorm(lp["ln"], x, eps), pc["mamba"][m_idx],
                        self.mdims,
                    )
                x, _ = self._ffn(pp, ffn, f_idx, x + h)
            new_periods.append(new)
        x = rmsnorm(self.ln_f, x, eps)
        logits = emb_mod.unembed_logits(self.embedding, x)[:, 0]
        return logits, {"periods": new_periods}


def build_hybrid_model(cfg: ArchConfig, dtype=torch.bfloat16, *, device="cuda",
                       generator=None) -> HybridLM:
    return HybridLM(cfg, dtype, device, generator)
