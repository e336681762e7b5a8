"""Synthetic LM data pipeline.

Deterministic, seekable token streams (Markov-ish bigram mixture so the
loss actually decreases during the example runs), with the modality-stub
inputs for VLM/audio families.  The pipeline is an iterator of
fixed-shape numpy batches — the launcher shards them across the mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.config import ModelConfig


@dataclass
class SyntheticLM:
    """Infinite synthetic corpus with learnable bigram structure."""
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    n_states: int = 64          # low-rank bigram structure

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.cfg.vocab
        k = min(self.n_states, V)
        # each state prefers a small set of next tokens
        self._emit = rng.integers(0, V, size=(k, 8))
        self._trans = rng.integers(0, k, size=(k, 8))
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self._step))
        self._step += 1
        B, S = self.batch, self.seq
        toks = np.zeros((B, S + 1), np.int32)
        state = rng.integers(0, self._emit.shape[0], size=B)
        for t in range(S + 1):
            choice = rng.integers(0, 8, size=B)
            toks[:, t] = self._emit[state, choice]
            state = self._trans[state, choice]
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        cfg = self.cfg
        if cfg.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (B, cfg.vlm.n_img_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            out["audio_embeds"] = rng.standard_normal(
                (B, cfg.encdec.n_audio_frames, cfg.d_model)
            ).astype(np.float32)
        return out
