"""Per-node synthetic LM token shards with controllable heterogeneity.

Decentralized setting: each graph node is a data silo holding a token shard.
Heterogeneity is produced by giving each silo its own Zipf-like unigram
distribution over a silo-specific vocabulary slice; "hard" silos draw from a
flatter (higher-entropy) distribution over rarer tokens, which empirically
yields larger gradient norms — the LLM analogue of the paper's sigma_H^2
nodes.  Sequences get structure from a deterministic n-gram mixing rule so the
loss is learnable (not pure noise).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["NodeTokenData", "make_node_token_shards"]


@dataclasses.dataclass(frozen=True)
class NodeTokenData:
    """Token shards for all nodes: tokens[v] is a (shard_len,) int32 stream."""

    tokens: np.ndarray  # (n, shard_len) int32
    hard_mask: np.ndarray  # (n,) bool — high-heterogeneity silos
    vocab_size: int

    @property
    def n(self) -> int:
        return int(self.tokens.shape[0])

    def batch(self, node: int, batch_size: int, seq_len: int, seed: int) -> dict:
        """Sample a (batch, seq_len+1) window batch from node's shard."""
        rng = np.random.default_rng(seed)
        shard = self.tokens[node]
        max_start = len(shard) - seq_len - 1
        starts = rng.integers(0, max_start, size=batch_size)
        windows = np.stack([shard[s : s + seq_len + 1] for s in starts])
        return {"tokens": windows[:, :-1].astype(np.int32),
                "labels": windows[:, 1:].astype(np.int32)}


def make_node_token_shards(
    n: int,
    vocab_size: int,
    shard_len: int = 4096,
    p_hard: float = 0.05,
    seed: int = 0,
    force_min_hard: int = 1,
) -> NodeTokenData:
    rng = np.random.default_rng(seed)
    hard = rng.random(n) < p_hard
    if hard.sum() < force_min_hard:
        hard[rng.choice(n, size=force_min_hard - int(hard.sum()), replace=False)] = True

    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    tokens = np.empty((n, shard_len), dtype=np.int32)
    for v in range(n):
        # silo-specific vocab rotation + Zipf exponent (hard silos flatter)
        alpha = 0.6 if hard[v] else 1.3
        probs = ranks ** (-alpha)
        probs /= probs.sum()
        rot = int(rng.integers(0, vocab_size))
        stream = rng.choice(vocab_size, size=shard_len, p=probs)
        stream = (stream + rot) % vocab_size
        # inject learnable bigram structure: every odd position repeats a
        # deterministic function of its predecessor half the time
        mix = rng.random(shard_len) < 0.5
        shifted = (stream * 31 + 7) % vocab_size
        stream = np.where(mix & (np.arange(shard_len) % 2 == 1), shifted, stream)
        tokens[v] = stream.astype(np.int32)
    return NodeTokenData(tokens=tokens, hard_mask=hard, vocab_size=vocab_size)
