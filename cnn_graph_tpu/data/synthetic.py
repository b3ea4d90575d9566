"""Synthetic datasets for demos, tests and benchmarks.

``community_classification`` reproduces the usage.ipynb demo scenario
(cells 3-9): Gaussian features with community structure, a noisy
non-linear scalar target thresholded into 3 classes, a kNN feature graph,
coarsening, and permuted splits — the CPU-runnable end-to-end parity
target (BASELINE.md).  ``synthetic_flow`` fabricates a HumanTraffic-style
region-graph flow matrix for exercising the forecasting stack without the
(unshipped) .mat datasets.
"""

from __future__ import annotations

import numpy as np

from cnn_graph_tpu.graphs import coarsening, construction

__all__ = ["community_classification", "synthetic_flow", "city_graph"]


def community_classification(
    n: int = 10000,
    d: int = 100,
    n_communities: int = 5,
    knn: int = 10,
    coarsening_levels: int = 3,
    seed: int = 0,
):
    """Returns ``(splits, graphs, perm)`` where splits is a dict with
    train/val/test data and labels (usage.ipynb cells 3-9 semantics:
    50/10/40 split, kNN graph built on the training features)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, d)).astype(np.float32)
    X += np.linspace(0, 1, n_communities).repeat(d // n_communities)

    w = rng.normal(0, 0.02, d)
    t = np.tanh(X @ w + rng.normal(0, 0.001, n))
    y = np.ones(n, np.int32)
    y[t > t.mean() + 0.4 * t.std()] = 0
    y[t < t.mean() - 0.4 * t.std()] = 2

    n_train, n_val = n // 2, n // 10
    X_train = X[:n_train]

    dist, idx = construction.knn(X_train.T, k=knn)
    A = construction.adjacency(dist, idx).astype(np.float32)
    graphs, perm = coarsening.coarsen(
        A, levels=coarsening_levels, seed=seed, verbose=False
    )

    splits = {
        "train_data": coarsening.perm_data(X_train, perm),
        "val_data": coarsening.perm_data(X[n_train : n_train + n_val], perm),
        "test_data": coarsening.perm_data(X[n_train + n_val :], perm),
        "train_labels": y[:n_train],
        "val_labels": y[n_train : n_train + n_val],
        "test_labels": y[n_train + n_val :],
    }
    return splits, graphs, perm


def synthetic_flow(
    n_nodes: int = 64,
    n_steps: int = 1344,
    period: int = 48,
    seed: int = 0,
):
    """Fabricated in/out-flow matrices ``[M, T]`` with daily periodicity +
    graph-correlated noise, plus a random sparse symmetric edge matrix —
    shaped like the HumanTraffic ``ln_data.mat`` inputs
    (nips2016/humantraffic.py:38-48)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_steps)
    base = 50 + 30 * np.sin(2 * np.pi * t / period)[None, :]
    node_scale = rng.uniform(0.5, 2.0, (n_nodes, 1))
    in_matrix = node_scale * base + rng.normal(0, 5, (n_nodes, n_steps))
    out_matrix = node_scale * np.roll(base, period // 4, axis=1) + rng.normal(
        0, 5, (n_nodes, n_steps)
    )
    in_matrix = np.clip(in_matrix, 0, None)
    out_matrix = np.clip(out_matrix, 0, None)

    edges = rng.uniform(0, 1000, (n_nodes, n_nodes))
    edges = np.triu(edges * (rng.random((n_nodes, n_nodes)) < 0.15), k=1)
    edge_matrix = edges + edges.T
    return in_matrix, out_matrix, edge_matrix


def city_graph(side: int, k: int = 8, seed: int = 0, jitter: float = 0.3,
               normalized: bool = True):
    """Planar city-like graph: a jittered ``side x side`` grid, k-NN
    adjacency, RCM-ordered (bandable), normalized Laplacian.

    The shared recipe behind the production-scale benchmark and the
    smoke run (bench.py, chip_smoke.py) — one definition so they always
    measure the same graph.  Returns
    ``(L, positions)`` with positions in RCM order.
    """
    import numpy as np

    from cnn_graph_tpu.graphs import construction as gc

    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    z = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    z += rng.normal(0, jitter, z.shape).astype(np.float32)
    dist, idx = gc.knn(z, k=k, algorithm="auto")
    W = gc.adjacency(dist, idx)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return gc.laplacian(W, normalized=normalized), z[perm]
