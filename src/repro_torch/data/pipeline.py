"""Deterministic synthetic data pipeline, replayable from (seed, step).

The JAX package's ``data/pipeline.py``: :class:`DataConfig`, :func:`_mix`
and :class:`SyntheticLMData` are pure numpy and copied as they are, so both
packages draw the same bits for every step.  A batch is a dict of numpy
arrays; the trainer moves it to its device.  :func:`make_batch_struct`
gives a batch's shapes and dtypes as storage-less ``meta`` tensors.

Fault-tolerance contract: batches are a pure function of (seed, step), so a
restart from step k reproduces the exact stream without any pipeline
checkpoint.  The stream is a structured Markov-ish sequence (token t+1
depends on token t and a per-dataset key), so a small model trained for a
few hundred steps shows a cleanly decreasing loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.frontends import feature_dim


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0


def _mix(state: np.ndarray, key: np.ndarray, vocab: int) -> np.ndarray:
    """Cheap integer hash step: next = h(cur, key) mod vocab."""
    x = (state.astype(np.uint64) * np.uint64(6364136223846793005)
         + key.astype(np.uint64) + np.uint64(1442695040888963407))
    x ^= x >> np.uint64(33)
    return (x % np.uint64(vocab)).astype(np.int32)


class SyntheticLMData:
    """Iterable of {"tokens", "labels"} with exact (seed, step) replay (a
    vision model's batches add "patches", an audio model's take "frames"
    in place of "tokens")."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(np.uint64(c.seed) * np.uint64(1_000_003)
                                    + np.uint64(step))
        # ONE successor key per dataset (seed), shared by all sequences and
        # steps: the (token -> successor) table is globally learnable (a
        # noisy bigram LM), so short training runs show real loss movement
        key = np.full((c.global_batch, 1),
                      (c.seed * 2_654_435_761 + 97) % (2**31), np.int64)
        toks = np.empty((c.global_batch, c.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, c.vocab, size=c.global_batch)
        # structured stream: 75% deterministic successor, 25% resample
        noise = rng.random((c.global_batch, c.seq_len)) < 0.25
        fresh = rng.integers(0, c.vocab, size=(c.global_batch, c.seq_len),
                             dtype=np.int64)
        for t in range(c.seq_len):
            nxt = _mix(toks[:, t], key[:, 0], c.vocab)
            toks[:, t + 1] = np.where(noise[:, t], fresh[:, t], nxt)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        mc = self.model_cfg
        if mc is not None and mc.frontend == "vision":
            batch["patches"] = rng.standard_normal(
                (c.global_batch, mc.n_prefix_embed, feature_dim(mc)),
                dtype=np.float32)
        if mc is not None and mc.frontend == "audio":
            batch.pop("tokens")
            batch["frames"] = rng.standard_normal(
                (c.global_batch, c.seq_len, feature_dim(mc)),
                dtype=np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_struct(cfg: DataConfig, model_cfg: Optional[ModelConfig] = None
                      ) -> Dict[str, torch.Tensor]:
    """One batch's shapes and dtypes as ``meta`` tensors."""
    b, s = cfg.global_batch, cfg.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {"tokens": meta((b, s), torch.int32),
           "labels": meta((b, s), torch.int32)}
    mc = model_cfg
    if mc is not None and mc.frontend == "vision":
        out["patches"] = meta((b, mc.n_prefix_embed, feature_dim(mc)),
                              torch.float32)
    if mc is not None and mc.frontend == "audio":
        out.pop("tokens")
        out["frames"] = meta((b, s, feature_dim(mc)), torch.float32)
    return out
