"""Dirichlet non-IID partitioning (the paper's federated data setup).

The port's own copy of ``repro/data/partition.py`` (numpy only).

Each client's class mixture is drawn from Dir(α): small α ⇒ heavily skewed
(strong non-IID), large α ⇒ approaches IID. Matches the setup of
Lin et al. 2020 / Ma et al. 2022 cited by the paper; default α = 0.5.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import Example


def dirichlet_partition(examples: Sequence[Example], n_clients: int,
                        alpha: float, rng: np.random.Generator,
                        min_per_client: int = 4) -> List[List[Example]]:
    """Split by class with per-class Dirichlet proportions over clients."""
    classes = sorted({ex.cls for ex in examples})
    by_cls: Dict[int, List[Example]] = {c: [] for c in classes}
    for ex in examples:
        by_cls[ex.cls].append(ex)
    clients: List[List[Example]] = [[] for _ in range(n_clients)]
    for c in classes:
        items = by_cls[c]
        rng.shuffle(items)
        props = rng.dirichlet([alpha] * n_clients)
        counts = (props * len(items)).astype(int)
        counts[-1] = len(items) - counts[:-1].sum()
        idx = 0
        for i, k in enumerate(counts):
            clients[i].extend(items[idx:idx + k])
            idx += k
    # guarantee a minimum so every client can form batches
    pool = [ex for cl in clients for ex in cl]
    for cl in clients:
        while len(cl) < min_per_client:
            cl.append(pool[int(rng.integers(len(pool)))])
    for cl in clients:
        rng.shuffle(cl)
    return clients


def train_test_split(examples: Sequence[Example], test_frac: float,
                     rng: np.random.Generator) -> Tuple[List[Example], List[Example]]:
    """The paper's per-client 8:2 split; test stays local (same distribution)."""
    items = list(examples)
    rng.shuffle(items)
    k = max(1, int(len(items) * (1 - test_frac)))
    return items[:k], items[k:] if k < len(items) else items[-1:]
