"""Node-indexed data pipeline feeding the walk-orchestrated training loop.

The walk decides which node's shard produces the next batch; the pipeline
materializes that batch (host numpy, the reference's bit for bit, its
``_counter`` seeding included) and the train step copies it to the device.

For small-scale training (regression), nodes' data lives on the device and
selection is a gather — see ``walk_sgd.trainer``.
"""
from __future__ import annotations

from typing import Iterator

from repro_torch.data.lm_data import NodeTokenData

__all__ = ["NodeDataPipeline"]


class NodeDataPipeline:
    """Stateful host-side pipeline: next_batch(node) -> {tokens, labels}."""

    def __init__(
        self,
        data: NodeTokenData,
        batch_size: int,
        seq_len: int,
        seed: int = 0,
    ) -> None:
        self.data = data
        self.batch_size = batch_size
        self.seq_len = seq_len
        self._counter = seed

    def next_batch(self, node: int) -> dict:
        self._counter += 1
        return self.data.batch(int(node), self.batch_size, self.seq_len, self._counter)

    def stream(self, nodes: Iterator[int]) -> Iterator[dict]:
        for v in nodes:
            yield self.next_batch(v)
