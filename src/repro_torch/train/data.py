"""Deterministic, shard-aware token streams (numpy copies of
``repro.train.data``'s ``SyntheticLM`` and ``TokenBinLoader``; their
batches are bit-identical to the JAX package's).

Every (step, rank) slice of the synthetic stream is derived by
counter-based hashing, so a checkpoint that stores only the step
resumes the identical stream, and each data-parallel rank generates
exactly its slice.  :func:`add_modality_stubs` attaches the frontends'
stub embeddings: vision (internvl2) and audio frames (whisper).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


@dataclasses.dataclass
class SyntheticLM:
    """Counter-based synthetic token stream."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, rank: int = 0, world: int = 1
                 ) -> Dict[str, np.ndarray]:
        assert self.global_batch % world == 0
        local = self.global_batch // world
        rows = np.arange(local) + rank * local
        cols = np.arange(self.seq_len + 1)
        ctr = (np.uint64(self.seed) << np.uint64(40)
               ^ (np.uint64(step) << np.uint64(20))[None, None]
               ^ (rows[:, None].astype(np.uint64) << np.uint64(12))
               ^ cols[None, :].astype(np.uint64))
        toks = (_mix64(ctr) % np.uint64(self.vocab_size)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, :-1]}

    def iter(self, start_step: int = 0, rank: int = 0, world: int = 1
             ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step, rank, world)
            step += 1


@dataclasses.dataclass
class TokenBinLoader:
    """Memmap-backed loader over a flat int32 token file with the same
    (step, rank) cursor determinism as SyntheticLM."""
    path: str
    seq_len: int
    global_batch: int

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._tokens_per_step = self.global_batch * (self.seq_len + 1)

    @property
    def num_steps(self) -> int:
        return len(self._data) // self._tokens_per_step

    def batch_at(self, step: int, rank: int = 0, world: int = 1
                 ) -> Dict[str, np.ndarray]:
        local = self.global_batch // world
        base = (step % max(self.num_steps, 1)) * self._tokens_per_step
        off = base + rank * local * (self.seq_len + 1)
        chunk = np.asarray(self._data[off: off + local * (self.seq_len + 1)])
        toks = chunk.reshape(local, self.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, :-1]}


def add_modality_stubs(batch: Dict[str, np.ndarray], cfg,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """Attach deterministic frontend-stub embeddings, the JAX package's:
    for vlm archs ``vision_embeds`` (B, vision_tokens, d_model), for
    encoder-decoders ``audio_frames`` (B, encoder_seq_len, d_model),
    float32, from one generator seeded with ``seed`` that draws vision
    before audio, as there."""
    b = batch["tokens"].shape[0]
    rng = np.random.default_rng(seed)
    if cfg.vision_tokens:
        batch = dict(batch)
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model), dtype=np.float32) * 0.02
    if cfg.is_encdec:
        batch = dict(batch)
        batch["audio_frames"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32) * 0.02
    return batch
