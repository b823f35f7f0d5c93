"""Token embedding / unembedding and the chunked cross-entropy.

The chunked cross-entropy never holds the full (B, S, V) logits: it loops
over sequence chunks, computing each chunk's float32 logits, logsumexp and
label gather.
"""
from __future__ import annotations

import torch

from repro_torch.models.model_utils import grad_dtype_guard, normal
from repro_torch.sharding.constraints import lookup_rows, pick_last

__all__ = ["embedding_init", "embed", "unembed_logits", "chunked_softmax_xent"]


def embedding_init(vocab_size: int, d_model: int, dtype, device, generator) -> dict:
    return {"table": normal((vocab_size, d_model), 0.02, dtype, device, generator)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return lookup_rows(params["table"], tokens)


def _logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """float32 logits ``x @ table^T`` from exact products of the inputs."""
    return x.float() @ table.float().T


def unembed_logits(params, x: torch.Tensor) -> torch.Tensor:
    """Full float32 logits (B, S, V) — the decode path (S=1)."""
    return _logits(x, params["table"])


def chunked_softmax_xent(
    table: torch.Tensor,  # (V, D)
    x: torch.Tensor,  # (B, S, D) final hidden states
    labels: torch.Tensor,  # (B, S) integer; negative labels are masked out
    num_chunks: int = 8,
) -> torch.Tensor:
    """Mean token cross-entropy over unmasked positions, looped over S chunks."""
    x = grad_dtype_guard(x)
    b, s, d = x.shape
    if s % num_chunks != 0:
        num_chunks = 1
    chunk = s // num_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        xx, ll = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        mask = (ll >= 0).float()
        safe = ll.clamp(min=0).long()
        logits = _logits(xx, table)
        lse = torch.logsumexp(logits, dim=-1)
        picked = pick_last(logits, safe)
        total = total + ((lse - picked) * mask).sum()
        count = count + mask.sum()
    return total / count.clamp(min=1.0)
