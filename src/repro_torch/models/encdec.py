"""Encoder-decoder audio backbone — Whisper [arXiv:2212.04356].

The mel-spectrogram + conv frontend is a stub, as in the JAX package: the
batch's ``frames`` are post-conv frame embeddings (B, encoder_len,
d_model).  Downstream: a sinusoidal-position encoder with bidirectional
attention, a decoder with causal self-attention, cross-attention and GELU
MLPs, LayerNorms (whisper convention) and learned decoder positions (8192
rows, wrapped).  Every attention takes the einsum path, as in the JAX
package: ``use_kernels`` changes nothing here.

Decode path: the decoder's self-attention KV ring caches and the cross K/V,
computed once per request from the encoder's output
(``init_cache(..., frames=...)``) or zeros (what ``ServeEngine`` passes).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.base import Model, Stack
from repro_torch.models.layers import attention as attn_mod
from repro_torch.models.layers import embedding as emb_mod
from repro_torch.models.layers import mlp as mlp_mod
from repro_torch.models.layers.norms import layernorm, layernorm_init
from repro_torch.models.model_utils import (ParamGroup, layer_params, normal,
                                            scan_layers)

__all__ = ["EncDecLM", "build_encdec_model", "sinusoid"]

DEC_POSITIONS = 8192


def sinusoid(length: int, dim: int, device=None) -> torch.Tensor:
    """(length, dim) float32: sin on even columns, cos on odd ones."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    / dim)
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class EncDecLM(Model):
    """Encoder (``num_encoder_layers``), ``ln_enc``, decoder
    (``num_layers``), ``ln_f``; tied unembedding."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__(cfg)
        self.dims = attn_mod.AttnDims(
            d_model=cfg.d_model,
            num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim,
            qkv_bias=True,  # whisper uses biases
            use_rope=False,  # absolute positions, whisper convention
        )
        gen = dict(dtype=dtype, device=device, generator=generator)

        def ln():
            return ParamGroup(**layernorm_init(cfg.d_model, device))

        def mlp():
            return ParamGroup(**mlp_mod.gelu_mlp_init(cfg.d_model, cfg.d_ff, **gen))

        self.embedding = ParamGroup(
            **emb_mod.embedding_init(cfg.vocab_size, cfg.d_model, **gen))
        self.dec_pos = nn.Parameter(
            normal((DEC_POSITIONS, cfg.d_model), 0.01, dtype, device, generator))
        self.encoder = Stack(
            nn.ModuleDict({"ln1": ln(),
                           "attn": ParamGroup(**attn_mod.attn_init(self.dims, **gen)),
                           "ln2": ln(), "mlp": mlp()})
            for _ in range(cfg.num_encoder_layers))
        self.ln_enc = ln()
        self.decoder = Stack(
            nn.ModuleDict({
                "ln1": ln(),
                "self_attn": ParamGroup(**attn_mod.attn_init(self.dims, **gen)),
                "ln_x": ln(),
                "cross_attn": ParamGroup(**attn_mod.cross_attn_init(self.dims, **gen)),
                "ln2": ln(), "mlp": mlp()})
            for _ in range(cfg.num_layers))
        self.ln_f = ln()

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, T, D) -> encoder memory (B, T, D)."""

        def body(lp, x):
            x = x + attn_mod.attention_full(lp["attn"], layernorm(lp["ln1"], x),
                                            self.dims, mode="bidir")
            return x + mlp_mod.gelu_mlp(lp["mlp"], layernorm(lp["ln2"], x))

        dtype = self.dtype
        x = frames.to(dtype) + sinusoid(frames.shape[1], self.cfg.d_model,
                                        frames.device).to(dtype)
        x = scan_layers(body, self.encoder, x, remat=self.cfg.remat)
        return layernorm(self.ln_enc, x)

    def _trunk(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if "frames" not in batch:
            raise KeyError("the audio family's batch needs 'frames' (B, "
                           "encoder_len, d_model): the encoder's input")
        memory = self.encode(batch["frames"])
        tokens = batch["tokens"]
        x = emb_mod.embed(self.embedding, tokens)
        pos_ids = torch.arange(tokens.shape[1], device=tokens.device) % DEC_POSITIONS
        x = x + self.dec_pos[pos_ids][None]

        def body(lp, x):
            x = x + attn_mod.attention_full(
                lp["self_attn"], layernorm(lp["ln1"], x), self.dims,
                mode="causal", window=cfg.sliding_window,
            )
            mem_kv = attn_mod.precompute_cross_kv(lp["cross_attn"], memory, self.dims)
            x = x + attn_mod.cross_attention(lp["cross_attn"], layernorm(lp["ln_x"], x),
                                             mem_kv, self.dims)
            return x + mlp_mod.gelu_mlp(lp["mlp"], layernorm(lp["ln2"], x))

        x = scan_layers(body, self.decoder, x, remat=cfg.remat, guard=False)
        return layernorm(self.ln_f, x)

    @torch.no_grad()
    def apply(self, batch: dict) -> torch.Tensor:
        return self._trunk(batch)

    def loss(self, batch: dict) -> tuple:
        x = self._trunk(batch)
        ce = emb_mod.chunked_softmax_xent(
            self.embedding["table"], x, batch["labels"], self.cfg.loss_chunks
        )
        return ce, {"xent": ce}

    @torch.no_grad()
    def init_cache(self, batch_size: int, cache_len: int, frames=None) -> dict:
        """Per decoder layer a self-attention KV cache and the cross K/V:
        ``precompute_cross_kv`` of the encoder's output on ``frames`` (B,
        encoder_len, d_model) with the model's weights, or zeros without
        ``frames`` (the reference's ``init_cache`` without params and
        frames)."""
        cfg = self.cfg
        window = (min(cache_len, cfg.sliding_window) if cfg.sliding_window
                  else cache_len)
        kv_shape = (batch_size, cfg.encoder_len, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
        if frames is not None:
            memory = self.encode(frames)
            cross = [attn_mod.precompute_cross_kv(layer["cross_attn"], memory,
                                                  self.dims)
                     for layer in self.decoder]
        else:
            cross = [{"k": torch.zeros(kv_shape, dtype=self.dtype, device=self.device),
                      "v": torch.zeros(kv_shape, dtype=self.dtype, device=self.device)}
                     for _ in self.decoder]
        return {
            "self": [attn_mod.init_kv_cache(batch_size, window, cfg.num_kv_heads,
                                            cfg.resolved_head_dim, self.dtype,
                                            self.device)
                     for _ in self.decoder],
            "cross": cross,
        }

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, pos) -> tuple:
        """One token per row of ``tokens`` (B, 1) at absolute position
        ``pos``; updates the self-attention caches in place.  Returns
        ``(logits (B, V) float32, cache)``."""
        x = emb_mod.embed(self.embedding, tokens)
        p = int(pos) % DEC_POSITIONS
        x = x + self.dec_pos[p:p + 1][None]
        new_self = []
        for layer, sc, mem_kv in zip(self.decoder, cache["self"], cache["cross"]):
            lp = layer_params(layer)
            h, sc = attn_mod.attention_decode(
                lp["self_attn"], layernorm(lp["ln1"], x), sc, pos, self.dims)
            new_self.append(sc)
            x = x + h
            x = x + attn_mod.cross_attention(lp["cross_attn"], layernorm(lp["ln_x"], x),
                                             mem_kv, self.dims)
            x = x + mlp_mod.gelu_mlp(lp["mlp"], layernorm(lp["ln2"], x))
        x = layernorm(self.ln_f, x)
        logits = emb_mod.unembed_logits(self.embedding, x)[:, 0]
        return logits, {"self": new_self, "cross": cache["cross"]}


def build_encdec_model(cfg: ArchConfig, dtype=torch.bfloat16, *, device="cuda",
                       generator=None) -> EncDecLM:
    return EncDecLM(cfg, dtype, device, generator)
