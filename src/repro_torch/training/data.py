"""Deterministic, resumable synthetic data pipeline for LM training (a copy
of ``repro/training/data.py``: numpy only, so ``SyntheticLM.batch_at`` is
bitwise the reference's).

Production shape: shard-aware iteration (each DP shard reads its slice),
deterministic from (seed, step) so a restore at step k regenerates the exact
stream — the checkpoint only needs to record the step.  Swap `synthetic_lm`
for a tokenized-file reader in a real deployment; the iterator contract
(shape, dtype, determinism, resume) is what the trainer depends on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # fraction of tokens masked out of the loss (simulates padding/doc joins)
    mask_fraction: float = 0.05


class SyntheticLM:
    """Zipf-distributed token stream with next-token labels."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        B, S = cfg.global_batch, cfg.seq_len
        # zipf-ish: heavy head, long tail, clipped to vocab
        raw = rng.zipf(1.3, size=(B, S + 1))
        tokens = np.clip(raw, 1, cfg.vocab_size - 1).astype(np.int32)
        mask = (rng.random((B, S)) > cfg.mask_fraction).astype(np.float32)
        return {
            "tokens": tokens[:, :S],
            "labels": tokens[:, 1:],
            "loss_mask": mask,
        }

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1
