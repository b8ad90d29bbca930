"""Deterministic, sharded, resumable data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy and hashlib only;
nothing imported from the JAX package): the same seeds give byte-identical
token batches in both packages, so a train step of either sees the same
data.

Design requirements (large-scale runnability):
  * deterministic: batch t is a pure function of (seed, step, view) — any
    worker can reproduce any step, which is what makes elastic re-sharding
    and restart-from-watermark trivial (the checkpoint stores only the
    step counter, never iterator state);
  * sharded: each data-parallel rank materializes only its slice;
  * source-agnostic: synthetic token streams for tests/benches, or a
    memory-mapped token file for real corpora.

The re-shard rule on a view change mirrors virtual synchrony (DESIGN.md):
the new view's ranks re-partition the same deterministic stream, so no
example is lost or double-counted beyond the rolled-back watermark window.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    kind: str = "synthetic"        # synthetic | lm_file | mixture
    path: Optional[str] = None     # token file (np.uint16/uint32 memmap)
    # synthetic stream structure (so loss can actually go down):
    n_patterns: int = 512
    pattern_len: int = 64


def _rng_for(cfg: DataConfig, sequence_index: int) -> np.random.Generator:
    """One generator per GLOBAL sequence index — rank-independent, so any
    re-partitioning of ranks yields byte-identical global batches."""
    key = f"{cfg.seed}:{sequence_index}".encode()
    seed = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "little")
    return np.random.default_rng(seed)


class TokenSource:
    """Deterministic random-access token source."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.kind == "lm_file":
            assert cfg.path, "lm_file needs path"
            self._mm = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        elif cfg.kind == "synthetic":
            rng = np.random.default_rng(cfg.seed)
            # a bank of repeated patterns + noise: predictable structure
            self._patterns = rng.integers(
                0, cfg.vocab_size, size=(cfg.n_patterns, cfg.pattern_len),
                dtype=np.int32)

    def sequence(self, index: int, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        if self._mm is not None:
            n = len(self._mm) - cfg.seq_len - 1
            off = int(index * 2654435761 % max(n, 1))
            return np.asarray(self._mm[off:off + cfg.seq_len],
                              dtype=np.int32)
        # synthetic: tile patterns chosen by index, 10% noise tokens
        picks = rng.integers(0, cfg.n_patterns,
                             size=cfg.seq_len // cfg.pattern_len + 1)
        seq = self._patterns[picks].reshape(-1)[: cfg.seq_len].copy()
        noise = rng.random(cfg.seq_len) < 0.1
        seq[noise] = rng.integers(0, cfg.vocab_size, size=int(noise.sum()))
        return seq.astype(np.int32)


@dataclasses.dataclass
class ShardedLoader:
    """Batch t for data-parallel rank r of R ranks."""

    cfg: DataConfig
    rank: int
    n_ranks: int

    def __post_init__(self):
        assert self.cfg.global_batch % self.n_ranks == 0, \
            (self.cfg.global_batch, self.n_ranks)
        self.local_batch = self.cfg.global_batch // self.n_ranks
        self.source = TokenSource(self.cfg)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        base = step * self.cfg.global_batch + self.rank * self.local_batch
        toks = np.stack([
            self.source.sequence(base + i, _rng_for(self.cfg, base + i))
            for i in range(self.local_batch)])
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def global_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The full global batch (single-process training / tests)."""
    loader = ShardedLoader(cfg, rank=0, n_ranks=1)
    return loader.batch(step)


def reshard(cfg: DataConfig, old_ranks: int, new_ranks: int):
    """A view change re-partitions the SAME stream: loader construction is
    all that changes.  Returns a factory for the new view's loaders."""
    del old_ranks
    return lambda rank: ShardedLoader(cfg, rank=rank, n_ranks=new_ranks)
