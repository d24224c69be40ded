"""Deterministic, resumable synthetic data pipeline — a copy of the JAX
package's ``repro/data/pipeline.py`` (numpy only), so both packages draw
the same token stream from the same seed.

Token streams have LEARNABLE structure (a fixed random bigram/Markov chain
over the vocabulary plus 10% random jumps), so losses genuinely decrease.
Batches are a pure function of (seed, step): a run resumed at step k
replays the exact stream.  ``batch`` returns the global batch as host
tensors; ``dp_rows`` cuts a data rank's rows from it; ``place`` moves
them to the run's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    markov_states: int = 64


def dp_rows(batch: dict, index: int, count: int) -> dict:
    """Rows ``[index * B/count, (index + 1) * B/count)`` of every array of
    a global batch: the shard of data rank ``index`` of ``count``, in the
    order the JAX package shards the batch's dim 0 over ``("pod",
    "data")``."""
    if count == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % count:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {count} data ranks")
        rows = v.shape[0] // count
        out[k] = v[index * rows:(index + 1) * rows]
    return out


class SyntheticLM:
    """Markov-chain token stream (decoder-only token frontend)."""

    def __init__(self, dc: DataConfig, cfg=None):
        if cfg is not None and (cfg.family == "encdec"
                                or cfg.frontend is not None):
            raise NotImplementedError(
                f"{cfg.name}: frame / patch batches come with the "
                "encoder-decoder and frontend slices of the port")
        self.dc = dc
        self.cfg = cfg
        root = np.random.default_rng(dc.seed)
        v = dc.vocab_size
        k = min(dc.markov_states, v)
        # sparse-ish transition structure: each state prefers ~8 successors
        self._prefs = root.integers(0, v, size=(k, 8))
        self._state_of = root.integers(0, k, size=v)

    def _tokens(self, rng, b, s):
        v = self.dc.vocab_size
        out = np.empty((b, s), np.int64)
        cur = rng.integers(0, v, size=b)
        for t in range(s):
            out[:, t] = cur
            st = self._state_of[cur]
            choice = rng.integers(0, 8, size=b)
            nxt = self._prefs[st, choice]
            # 10% random jumps keep entropy nonzero
            jump = rng.random(b) < 0.1
            cur = np.where(jump, rng.integers(0, v, size=b), nxt)
        return out

    def batch(self, step: int) -> dict:
        """Pure function of step: host tensors tokens / labels (B, S) int64
        and mask (B, S) f32."""
        dc = self.dc
        rng = np.random.default_rng((dc.seed, step))
        b, s = dc.global_batch, dc.seq_len
        toks = self._tokens(rng, b, s + 1)
        return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                "labels": torch.from_numpy(toks[:, 1:].copy()),
                "mask": torch.ones((b, s), dtype=torch.float32)}

    @staticmethod
    def place(batch: dict, device) -> dict:
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}
