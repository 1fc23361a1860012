"""Deterministic synthetic token pipeline (port of
``repro/data/pipeline.py``: numpy only, kept as its own copy; batches
equal the reference's for every ``(seed, step, shard, n_shards)``).

Production shape: a sharded, stateless, deterministic-by-(seed, step) source
so every DP shard regenerates exactly its slice after a restart — the data
side of fault tolerance (no iterator state in checkpoints beyond `step`).

The token stream is a mixture of Zipfian unigrams and deterministic n-gram
"motifs" so models actually learn (loss decreases) in the examples.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.5


class SyntheticLM:
    """Stateless: batch(step) is a pure function of (config, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._motifs = rng.integers(
            0, cfg.vocab_size, (cfg.n_motifs, cfg.motif_len))

    def batch(self, step: int, *, shard: int = 0, n_shards: int = 1):
        cfg = self.cfg
        assert cfg.global_batch % n_shards == 0
        b_local = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed, step, shard))
        # zipf unigrams, clipped into vocab
        toks = rng.zipf(cfg.zipf_a, (b_local, cfg.seq_len + 1))
        toks = np.minimum(toks - 1, cfg.vocab_size - 1)
        # overlay deterministic motifs (learnable structure)
        n_spots = int(cfg.seq_len * cfg.motif_prob / cfg.motif_len)
        for r in range(b_local):
            ids = rng.integers(0, cfg.n_motifs, n_spots)
            starts = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len,
                                  n_spots)
            for m, s in zip(ids, starts):
                toks[r, s:s + cfg.motif_len] = self._motifs[m]
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
