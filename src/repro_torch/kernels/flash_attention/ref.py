"""Plain PyTorch version of the flash-attention kernel."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, N, S, h)
    k: torch.Tensor,  # (B, K, T, h)
    v: torch.Tensor,  # (B, K, T, h)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Softmax attention with the kv heads repeated to N (GQA), float32
    scores and softmax, the causal and sliding-window masks (``window``
    only with ``causal``); output in ``q``'s dtype, (B, N, S, h)."""
    n, s, h = q.shape[1], q.shape[2], q.shape[3]
    rep = n // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bnsh,bnth->bnst", q.float(), k.float()) * (h**-0.5)
    if causal:
        row = torch.arange(s, device=q.device)[:, None]
        col = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = col <= row
        if window > 0:
            mask = mask & (col > row - window)
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnst,bnth->bnsh", probs, v.float()).to(q.dtype)


def mha_ref(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """:func:`attention_ref` in the model layout (B, S, N, h)."""
    return attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window,
    ).transpose(1, 2)
