"""Multi-head attention: GQA/MQA, RoPE, causal/prefix/bidirectional/sliding
masks, a ring-buffer KV cache for decode, and the encoder-decoder's
cross-attention.

The full-sequence path is einsum attention in PyTorch; with ``use_flash``
and a causal or bidirectional mask it goes through the hand-written CUDA
flash-attention kernel (``repro_torch.kernels.flash_attention.ops.mha``;
its plain version on the CPU).  A 'prefix' mask always takes the einsum
path, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.layers.rotary import apply_rope
from repro_torch.models.model_utils import normal
from repro_torch.sharding.constraints import (
    aligned_to, constrain, is_dtensor, local_call, placements_of, shard_offset,
)
from repro_torch.utils.kernel_bounds import flash_bound
from repro_torch.utils.op_cost import priced

__all__ = [
    "AttnDims",
    "attn_init",
    "make_mask",
    "attention_full",
    "attention_decode",
    "init_kv_cache",
    "cross_attn_init",
    "precompute_cross_kv",
    "cross_attention",
]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    # repeat kv heads to num_heads before the score einsum (the JAX
    # package's Megatron-style GQA sharding option); same values
    repeat_kv: bool = False


def attn_init(dims: AttnDims, dtype, device, generator) -> dict:
    d, n, k, h = dims.d_model, dims.num_heads, dims.num_kv_heads, dims.head_dim
    scale = d**-0.5
    params = {
        "wq": normal((d, n, h), scale, dtype, device, generator),
        "wk": normal((d, k, h), scale, dtype, device, generator),
        "wv": normal((d, k, h), scale, dtype, device, generator),
        "wo": normal((n, h, d), (n * h) ** -0.5, dtype, device, generator),
    }
    if dims.qkv_bias:
        params["bq"] = torch.zeros((n, h), dtype=dtype, device=device)
        params["bk"] = torch.zeros((k, h), dtype=dtype, device=device)
        params["bv"] = torch.zeros((k, h), dtype=dtype, device=device)
    return params


def _project_qkv(params, x, dims: AttnDims, positions):
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"])
    k = torch.einsum("bsd,dkh->bskh", x, params["wk"])
    v = torch.einsum("bsd,dkh->bskh", x, params["wv"])
    if dims.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if dims.use_rope:
        q = apply_rope(q, positions, dims.rope_theta)
        k = apply_rope(k, positions, dims.rope_theta)
    return q, k, v


def _grouped_scores(q, k, dims: AttnDims):
    """(B,S,N,h) x (B,T,K,h) -> float32 (B,K,G,S,T), G = N/K query groups."""
    b, s, n, h = q.shape
    kk = dims.num_kv_heads
    qg = q.reshape(b, s, kk, n // kk, h)
    return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())


def _grouped_out(probs, v, dims: AttnDims):
    b, kk, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, kk * g, -1)


def _repeated_scores(q, k, dims: AttnDims):
    """repeat_kv path: kv repeated to N heads."""
    k = k.repeat_interleave(dims.num_heads // dims.num_kv_heads, dim=2)
    k = constrain(k, ("data", None, "model", None))
    return torch.einsum("bsnh,btnh->bnst", q.float(), k.float())


def _repeated_out(probs, v, dims: AttnDims):
    v = v.repeat_interleave(dims.num_heads // dims.num_kv_heads, dim=2)
    v = constrain(v, ("data", None, "model", None))
    return torch.einsum("bnst,btnh->bsnh", probs.to(v.dtype), v)


def make_mask(
    seq_len: int,
    mode: str,
    *,
    window: int = 0,
    prefix_len: int = 0,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Additive (S, S) mask.  mode: 'causal' | 'prefix' | 'bidir'.

    ``window > 0`` restricts causal attention to the last ``window`` keys.
    'prefix' is the prefix-LM mask: full attention within the first
    ``prefix_len`` positions, causal after.
    """
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    if mode == "bidir":
        allowed = torch.ones((seq_len, seq_len), dtype=torch.bool, device=device)
    elif mode == "causal":
        allowed = j <= i
    elif mode == "prefix":
        allowed = (j <= i) | ((i < prefix_len) & (j < prefix_len))
    else:
        raise ValueError(f"unknown mask mode {mode!r}")
    if window > 0 and mode != "bidir":
        allowed = allowed & (j > i - window)
    return torch.zeros((seq_len, seq_len), dtype=dtype, device=device).masked_fill_(
        ~allowed, NEG_INF)


def attention_full(
    params,
    x: torch.Tensor,  # (B, S, D)
    dims: AttnDims,
    *,
    mode: str = "causal",
    window: int = 0,
    prefix_len: int = 0,
    positions: Optional[torch.Tensor] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, dims, positions)
    if mode in ("causal", "bidir"):
        out = _attend_local(q, k, v, dims, mode, window, use_flash)
    else:  # 'prefix' always takes the einsum path
        out = _attend(q, k, v, dims, mode, window, prefix_len, False)
    return torch.einsum("bsnh,nhd->bsd", out, params["wo"])


def _attend(q, k, v, dims: AttnDims, mode, window, prefix_len, use_flash):
    """Attention outputs (B, S, N, h): the CUDA flash-attention kernel
    (model layout, GQA folded inside) or the einsum path."""
    if use_flash:
        from repro_torch.kernels.flash_attention.ops import mha

        return mha(
            q.contiguous(), k.to(q.dtype).contiguous(),
            v.to(q.dtype).contiguous(), causal=mode == "causal", window=window,
        ).to(q.dtype)
    s = q.shape[1]
    mask = make_mask(s, mode, window=window, prefix_len=prefix_len,
                     device=q.device)
    if dims.repeat_kv:
        q = constrain(q, ("data", None, "model", None))
        scores = _repeated_scores(q, k, dims) * (dims.head_dim**-0.5)
        probs = torch.softmax(scores + mask, dim=-1)
        return constrain(_repeated_out(probs, v, dims),
                         ("data", None, "model", None))
    scores = _grouped_scores(q, k, dims) * (dims.head_dim**-0.5)
    probs = torch.softmax(scores + mask, dim=-1)
    return _grouped_out(probs, v, dims)


def _attend_priced(q, k, v, dims: AttnDims, mode, window, use_flash):
    """:func:`_attend` as one priced call (``repro_torch.utils.op_cost``):
    the flash kernel's work whichever path runs."""
    b, s, n, h = q.shape
    t, kh = k.shape[1], k.shape[2]
    causal = mode == "causal"
    return priced(
        "attention",
        lambda: flash_bound(b, s, t, n, kh, h, q.element_size(), causal,
                            window if causal else 0),
        lambda: _attend(q, k, v, dims, mode, window, 0, use_flash),
        lambda: torch.empty(q.shape, dtype=q.dtype, device=q.device), q, k, v)


def _attend_local(q, k, v, dims: AttnDims, mode, window, use_flash):
    """:func:`_attend_priced` on each device's batch and heads on a mesh.
    Where q's heads are split and k's cannot be (fewer kv heads than the
    axis), k and v are repeated to q's heads first, as the reference's
    repeated-kv layout does, so each device attends its own heads."""
    if not is_dtensor(q):
        return _attend_priced(q, k, v, dims, mode, window, use_flash)
    pq = placements_of(q, (0, 2))
    if pq != placements_of(k, (0, 2)):
        rep = dims.num_heads // dims.num_kv_heads
        k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        dims = dataclasses.replace(dims, num_kv_heads=dims.num_heads)
    return local_call(
        lambda ql, kl, vl: _attend_priced(
            ql, kl, vl, dataclasses.replace(
                dims, num_heads=ql.shape[2], num_kv_heads=kl.shape[2]),
            mode, window, use_flash),
        (q, k, v), (pq, pq, pq), pq, tuple(q.shape))


# ---------------------------------------------------------------------------
# Decode path: ring-buffer KV cache (window = full cache_len or sliding)
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, window: int, num_kv_heads: int, head_dim: int,
                  dtype, device=None) -> dict:
    return {
        "k": torch.zeros((batch, window, num_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, window, num_kv_heads, head_dim), dtype=dtype,
                         device=device),
        # absolute position held by each slot, -1 = empty
        "slot_pos": torch.full((window,), -1, dtype=torch.int32, device=device),
    }


def attention_decode(
    params,
    x: torch.Tensor,  # (B, 1, D) current token hidden
    cache: dict,
    pos: int,  # absolute position of this token
    dims: AttnDims,
) -> tuple:
    """One token.  Writes k, v and ``slot_pos`` into slot ``pos % window``
    of ``cache`` in place (the cache is the caller's buffer, as the JAX
    engine donates it) and returns ``(y (B, 1, D), cache)``."""
    pos = int(pos)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, dims, positions)

    window = cache["k"].shape[1]
    slot = pos % window
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    k[:, slot] = k_new[:, 0].to(k.dtype)
    v[:, slot] = v_new[:, 0].to(v.dtype)
    slot_pos[slot] = pos

    valid = (slot_pos >= 0) & (slot_pos <= pos)
    out = _decode_local(q, k, v, valid, dims)  # (B,1,N,h)
    y = torch.einsum("bsnh,nhd->bsd", out, params["wo"])
    return y, cache


def _decode_core(q, k, v, valid, dims: AttnDims):
    scores = _grouped_scores(q, k, dims) * (dims.head_dim**-0.5)  # (B,K,G,1,W)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_out(probs, v, dims)


def _decode_local(q, k, v, valid, dims: AttnDims):
    """:func:`_decode_core` on each device's batch and heads on a mesh: a
    device whose q heads are split while the cache's kv heads are whole
    reads the kv heads of its own query groups."""
    if not is_dtensor(q):
        return _decode_core(q, k, v, valid, dims)
    pq = placements_of(q, (0, 2))
    split_q = pq != placements_of(q, (0,))
    whole = aligned_to(pq, {0: 0})  # the cache's batch follows q's
    kv_split = placements_of(k, (0, 2)) != placements_of(k, (0,))
    pkv = pq if split_q and kv_split else whole
    n, kh = dims.num_heads, dims.num_kv_heads
    lo = shard_offset(q.device_mesh, pq, n, 2) * kh // n

    def core(ql, kl, vl, vd):
        nl = ql.shape[2]
        if split_q and pkv == whole:  # the kv heads of this device's groups
            kl, vl = (t[:, :, lo:lo + max(1, nl * kh // n)] for t in (kl, vl))
        return _decode_core(ql, kl, vl, vd, dataclasses.replace(
            dims, num_heads=nl, num_kv_heads=kl.shape[2]))

    return local_call(core, (q, k, v, valid),
                      (pq, pkv, pkv, placements_of(valid, ())), pq,
                      tuple(q.shape))


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder -> encoder memory); einsum attention, as
# in the JAX package, which has no kernel for it
# ---------------------------------------------------------------------------


def cross_attn_init(dims: AttnDims, dtype, device, generator) -> dict:
    return attn_init(dims, dtype, device, generator)


def precompute_cross_kv(params, memory: torch.Tensor, dims: AttnDims) -> dict:
    """Encoder memory (B, T, D) -> ``{"k", "v"}`` (B, T, K, h), once per
    request (no RoPE on the cross path)."""
    k = torch.einsum("btd,dkh->btkh", memory, params["wk"])
    v = torch.einsum("btd,dkh->btkh", memory, params["wv"])
    if dims.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    return {"k": k, "v": v}


def cross_attention(params, x: torch.Tensor, memory_kv: dict,
                    dims: AttnDims) -> torch.Tensor:
    """Decoder states (B, S, D) attending over every key of ``memory_kv``."""
    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"])
    if dims.qkv_bias:
        q = q + params["bq"]
    scores = _grouped_scores(q, memory_kv["k"], dims) * (dims.head_dim**-0.5)
    probs = torch.softmax(scores, dim=-1)
    out = _grouped_out(probs, memory_kv["v"], dims)
    return torch.einsum("bsnh,nhd->bsd", out, params["wo"])
