"""Batching pipeline: deterministic, stateless epoch iterators.

The port's own copy of ``repro/data/pipeline.py`` (numpy only): batches
are numpy arrays; the trainer moves them to its device at the step.

Kept numpy-side (host) with device transfer at the step boundary. Shapes
are static (pad to ``max_len``), so every client's batch has one shape.
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

from repro_torch.data.synthetic import Example, encode_sft
from repro_torch.data.tokenizer import ByteTokenizer


class SFTBatcher:
    def __init__(self, examples: Sequence[Example], tok: ByteTokenizer,
                 max_len: int, batch_size: int, seed: int = 0):
        self.data = encode_sft(list(examples), tok, max_len)
        self.n = len(examples)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def sample(self) -> Dict[str, np.ndarray]:
        """Random batch with replacement (paper: 'randomly sample b data')."""
        idx = self.rng.integers(0, self.n, size=self.batch_size)
        return {"tokens": self.data["tokens"][idx],
                "loss_mask": self.data["loss_mask"][idx]}

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        perm = self.rng.permutation(self.n)
        for i in range(0, self.n - self.batch_size + 1, self.batch_size):
            idx = perm[i:i + self.batch_size]
            yield {"tokens": self.data["tokens"][idx],
                   "loss_mask": self.data["loss_mask"][idx]}

    def few_shot(self, k: int) -> Dict[str, np.ndarray]:
        """Fixed few-shot set Q for the AdaFusion objective (Eq. 8)."""
        idx = np.arange(min(k, self.n))
        return {"tokens": self.data["tokens"][idx],
                "loss_mask": self.data["loss_mask"][idx]}
