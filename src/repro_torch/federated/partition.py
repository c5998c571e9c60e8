"""Non-IID client partitioning (reference: ``repro/federated/partition.py``,
numpy only): Dirichlet(α) label skew and the pathological 1–2-labels-per-
client split of FedAvg [McMahan et al. 2017] (paper §V)."""

from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.nonzero(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[cid].extend(part.tolist())
        sizes = [len(x) for x in idx_per_client]
        if min(sizes) >= min_size:
            break
    return [np.array(sorted(x), dtype=np.int64) for x in idx_per_client]


def pathological_partition(labels: np.ndarray, n_clients: int,
                           labels_per_client: int = 2,
                           seed: int = 0) -> list[np.ndarray]:
    """Each client holds shards from only 1–2 labels (severe skew)."""
    rng = np.random.default_rng(seed)
    n_shards = n_clients * labels_per_client
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_shards)
    shard_ids = rng.permutation(n_shards)
    out = []
    for cid in range(n_clients):
        ids = shard_ids[cid * labels_per_client:(cid + 1) * labels_per_client]
        out.append(np.sort(np.concatenate([shards[s] for s in ids])))
    return out


def iid_partition(labels: np.ndarray, n_clients: int,
                  seed: int = 0) -> list[np.ndarray]:
    """A uniform random split: every client holds about the same share of
    every label (the fused runner's tests and chip checks use it so that no
    client is smaller than one batch)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    return [np.sort(x) for x in np.array_split(order, n_clients)]
