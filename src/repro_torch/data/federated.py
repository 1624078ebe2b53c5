"""Federated splits: carve a dataset into n client shards (numpy; a copy
of ``repro.data.federated``, which the port does not import).

``dirichlet_split`` produces the standard heterogeneous label split
(Dirichlet(alpha) over classes per client) used by Karimireddy et al. (2021)
and the paper's Fig. 2 MNIST experiments.  ``federated_shards`` is the
homogeneous equal-shard split (paper footnote 6 assumes equal local dataset
sizes, which we enforce by truncation).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["federated_shards", "dirichlet_split"]


def federated_shards(features: np.ndarray, labels: np.ndarray, n_clients: int):
    """Equal-size IID shards: returns (n, m, ...) stacked arrays."""
    n_total = features.shape[0]
    m = n_total // n_clients
    idx = np.random.RandomState(0).permutation(n_total)[: m * n_clients]
    f = features[idx].reshape((n_clients, m) + features.shape[1:])
    l = labels[idx].reshape((n_clients, m) + labels.shape[1:])
    return f, l


def dirichlet_split(
    features: np.ndarray,
    labels: np.ndarray,
    n_clients: int,
    alpha: float = 0.5,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Heterogeneous label split; every client gets exactly m = N//n samples
    (equal sizes, re-sampling with replacement inside a client if its
    Dirichlet allocation runs short)."""
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    n_total = features.shape[0]
    m = n_total // n_clients
    by_class = {c: np.where(labels == c)[0] for c in classes}
    for c in classes:
        rng.shuffle(by_class[c])
    # Dirichlet proportions: rows = clients, cols = classes
    props = rng.dirichlet([alpha] * len(classes), size=n_clients)
    client_idx = []
    for i in range(n_clients):
        want = (props[i] / props[i].sum() * m).astype(int)
        want[-1] = m - want[:-1].sum()
        take = []
        for c_i, c in enumerate(classes):
            pool = by_class[c]
            k = want[c_i]
            if k <= 0:
                continue
            if k <= len(pool):
                take.append(pool[:k])
                by_class[c] = pool[k:]
            else:  # pool exhausted: sample with replacement
                extra = rng.choice(pool, k - len(pool)) if len(pool) else rng.choice(
                    np.arange(n_total), k
                )
                take.append(np.concatenate([pool, extra]).astype(np.int64))
                by_class[c] = pool[:0]
        idx = np.concatenate(take) if take else rng.choice(n_total, m)
        if len(idx) < m:
            idx = np.concatenate([idx, rng.choice(n_total, m - len(idx))])
        client_idx.append(idx[:m])
    ci = np.stack(client_idx)
    return features[ci], labels[ci]
