"""Synthetic LM data pipeline: a copy of the JAX package's
``training/data.py`` (numpy only), so a seed gives the reference's batches
bit for bit. The training loop moves each numpy batch to its device.

Deterministic, seekable, host-shardable token streams with learnable
structure: a mixture of (a) order-2 Markov chains over a Zipf-distributed
vocabulary and (b) verbatim repeats of earlier context — so a few hundred
training steps measurably reduce loss (examples/train_tiny.py). VLM/audio
configs get matching stub modality inputs (precomputed embeddings per the
assignment's frontend carve-out).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0
    zipf_a: float = 1.2
    repeat_prob: float = 0.3


class SyntheticLM:
    """Infinite iterator of {tokens, labels, (extras)} numpy batches."""

    def __init__(self, cfg: ModelConfig, data: DataConfig,
                 host_id: int = 0, num_hosts: int = 1):
        self.cfg = cfg
        self.data = data
        self.rng = np.random.default_rng(
            np.random.SeedSequence([data.seed, host_id]))
        self.num_hosts = num_hosts
        V = cfg.vocab_size
        # order-2 Markov structure: next token = f(prev, pos%P) + noise
        r = np.random.default_rng(data.seed + 7)
        self._mix = r.integers(0, V, size=(997,), dtype=np.int64)
        # Zipf weights over a capped support for cheap sampling
        support = min(V, 4096)
        w = 1.0 / np.arange(1, support + 1) ** data.zipf_a
        self._zipf_p = w / w.sum()
        self._support = support

    def _sequence(self) -> np.ndarray:
        d = self.data
        V = self.cfg.vocab_size
        n = d.seq_len + 1
        base = self.rng.choice(self._support, size=n, p=self._zipf_p)
        seq = np.empty(n, dtype=np.int64)
        seq[0] = base[0]
        for t in range(1, n):
            # deterministic structure most of the time, noise otherwise
            if self.rng.random() < 0.8:
                seq[t] = self._mix[(seq[t - 1] * 31 + t) % 997] % V
            else:
                seq[t] = base[t]
        if self.rng.random() < d.repeat_prob and n > 32:
            # verbatim repeat: copy an earlier span forward (induction heads)
            span = self.rng.integers(8, 17)
            src = self.rng.integers(0, n - 2 * span)
            dst = self.rng.integers(src + span, n - span)
            seq[dst:dst + span] = seq[src:src + span]
        return seq

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        d, cfg = self.data, self.cfg
        seqs = np.stack([self._sequence() for _ in range(d.batch_size)])
        batch: Dict[str, np.ndarray] = {
            "tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32),
        }
        if cfg.arch_type == "vlm":
            batch["patch_embeds"] = self.rng.standard_normal(
                (d.batch_size, cfg.num_patch_tokens, cfg.d_model),
                dtype=np.float32) * 0.02
        if cfg.is_encdec:
            batch["frames"] = self.rng.standard_normal(
                (d.batch_size, cfg.encoder_seq_len, cfg.d_model),
                dtype=np.float32) * 0.02
        return batch


__all__ = ["DataConfig", "SyntheticLM"]
