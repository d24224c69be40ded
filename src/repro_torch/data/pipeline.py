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


def _bf16(a: np.ndarray) -> torch.Tensor:
    """f64 normals -> bf16 as the JAX package's ``jnp.asarray(a,
    jnp.bfloat16)`` rounds them (through f32, x64 off)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def split_positions(cfg, seq_len: int) -> tuple:
    """(stub key, stub positions, token positions) of a sequence of
    ``seq_len`` under ``cfg``'s frontend, as the JAX package splits it: an
    encoder-decoder's ``frames`` take half (its encoder's input) and the
    tokens the other half; a patch frontend's ``frontend_tokens``
    ``patches`` go in front of ``seq_len`` less that many tokens; no
    frontend (or no ``cfg``): (None, 0, seq_len)."""
    if cfg is not None and cfg.family == "encdec":
        return "frames", seq_len // 2, seq_len // 2
    if cfg is not None and cfg.frontend == "patches":
        return "patches", cfg.frontend_tokens, seq_len - cfg.frontend_tokens
    return None, 0, seq_len


class SyntheticLM:
    """Markov-chain token stream, with the frontend stubs of ``cfg``: an
    encoder-decoder's frame embeddings, a patch frontend's patch
    embeddings (standard normals in bf16, drawn after the tokens)."""

    def __init__(self, dc: DataConfig, cfg=None):
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
        """Pure function of step: host tensors tokens / labels (B, S_tok)
        int64 and mask (B, S_tok) f32; an encoder-decoder's ``frames`` (B,
        S/2, D) with S_tok = S/2, a patch frontend's ``patches`` (B, T, D)
        with S_tok = S - T (both bf16).  The generator's draws come in the
        JAX package's order, so both packages' batches are equal bit for
        bit."""
        dc, cfg = self.dc, self.cfg
        rng = np.random.default_rng((dc.seed, step))
        b = dc.global_batch
        key, n_stub, s_tok = split_positions(cfg, dc.seq_len)
        toks = self._tokens(rng, b, s_tok + 1)
        batch = {}
        if key is not None:
            batch[key] = _bf16(rng.normal(0, 1, (b, n_stub, cfg.d_model)))
        batch["tokens"] = torch.from_numpy(toks[:, :-1].copy())
        batch["labels"] = torch.from_numpy(toks[:, 1:].copy())
        batch["mask"] = torch.ones((b, s_tok), dtype=torch.float32)
        return batch

    @staticmethod
    def place(batch: dict, device) -> dict:
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}
