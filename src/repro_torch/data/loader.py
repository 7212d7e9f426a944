"""Resumable sharded data loader. Port of ``repro/data/loader.py`` (numpy
over the port's ``data.synthetic``): the batches are bit-identical to the
reference's.

Determinism contract: batch contents are a pure function of (seed,
shard_id, num_shards, step), so any host can recompute any other host's
shard after a failure, and resuming from a checkpointed ``step`` replays
the exact stream.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.synthetic import synthetic_tokens


@dataclass
class LoaderState:
    step: int = 0


class ShardedLoader:
    def __init__(self, vocab: int, batch_size: int, seq_len: int, *,
                 num_shards: int = 1, shard_id: int = 0, seed: int = 0,
                 num_domains: int = 4, table_seed: int = 0):
        assert batch_size % num_shards == 0, (batch_size, num_shards)
        self.vocab = vocab
        self.batch = batch_size
        self.local_batch = batch_size // num_shards
        self.seq = seq_len
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self.num_domains = num_domains
        self.table_seed = table_seed
        self.state = LoaderState()

    def _batch_at(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32 tokens of ``step``: sequence i
        is the stream with the globally unique, recomputable id step *
        batch + shard_id * local_batch + i."""
        per_seq = self.seq + 1
        out = np.empty((self.local_batch, per_seq), np.int32)
        for i in range(self.local_batch):
            stream = (step * self.batch +
                      self.shard_id * self.local_batch + i)
            out[i] = synthetic_tokens(
                self.vocab, per_seq, seed=self.seed * 7919 + stream,
                num_domains=self.num_domains, table_seed=self.table_seed)
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        tokens = self._batch_at(self.state.step)
        self.state.step += 1
        return {"tokens": tokens}

    # -- checkpointable state --
    def state_dict(self) -> dict:
        return {"step": self.state.step}

    def load_state_dict(self, d: dict) -> None:
        self.state.step = int(d["step"])
