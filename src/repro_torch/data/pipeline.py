"""Deterministic, shardable, checkpointable data pipeline — the port's own
copy of ``repro/data/pipeline.py`` (numpy only; ``batch_at`` gives the
reference's batches bitwise).

``batch_at(step)`` is a pure function of (corpus seed/file, step, dp_rank,
dp_size), so (1) every data-parallel worker reads only its shard, (2)
restart after preemption is exact — the training loop checkpoint only
needs the step counter, and (3) elastic rescale (dp_size change) re-shards
the stream deterministically from the next step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticCorpus", "FileCorpus", "DataPipeline"]


class SyntheticCorpus:
    """Zipfian token stream with local structure (bigram-ish repeats) so a
    ~100M-param model shows a real learning curve on it."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 num_codebooks: int = 1):
        self.vocab_size = vocab_size
        self.seed = seed
        self.num_codebooks = num_codebooks

    def tokens_at(self, index: int, length: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        shape = (length,) if self.num_codebooks == 1 else (length,
                                                           self.num_codebooks)
        ranks = rng.zipf(1.3, size=shape)
        toks = np.minimum(ranks, self.vocab_size - 1).astype(np.int32)
        # inject repeated spans: next-token becomes predictable locally
        n_rep = max(1, length // 64)
        for r in range(n_rep):
            start = int(rng.integers(0, max(length - 16, 1)))
            span = toks[start:start + 8]
            end = min(start + 16, length)
            toks[start + 8:end] = span[:end - start - 8]
        return toks


class FileCorpus:
    """Flat binary token file (np.memmap) — the production path."""

    def __init__(self, path: str, vocab_size: int, dtype=np.int32):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size
        self.num_codebooks = 1

    def tokens_at(self, index: int, length: int) -> np.ndarray:
        n = len(self.tokens)
        start = (index * length) % max(n - length - 1, 1)
        return np.asarray(self.tokens[start:start + length], np.int32)


@dataclasses.dataclass
class DataPipeline:
    corpus: object
    seq_len: int
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1

    def __post_init__(self):
        if self.global_batch % self.dp_size:
            raise ValueError("global_batch must divide by dp_size")
        self.local_batch = self.global_batch // self.dp_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step: the worker's local shard of the global
        batch, with next-token labels."""
        seqs = []
        for b in range(self.local_batch):
            global_idx = (step * self.global_batch
                          + self.dp_rank * self.local_batch + b)
            seqs.append(self.corpus.tokens_at(global_idx, self.seq_len + 1))
        arr = np.stack(seqs)                          # [B, S+1(, nb)]
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    # -- checkpointing --------------------------------------------------------
    def state_dict(self, step: int) -> Dict[str, int]:
        return {"step": step, "dp_rank": self.dp_rank, "dp_size": self.dp_size}

    @staticmethod
    def resume_step(state: Dict[str, int]) -> int:
        return int(state["step"])
