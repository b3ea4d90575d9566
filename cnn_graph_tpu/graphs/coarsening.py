"""Multilevel Graclus graph coarsening and binary-tree pooling permutations.

Host-side precompute with capability parity with the reference's
``lib/coarsening.py`` (coarsen :5, metis :34, metis_one_level :119,
compute_perm :167, perm_data :219, perm_adjacency :242).  The outputs feed
the device models: ``graphs[i]`` become the per-pooling-level Laplacians and
``perm`` reorders node signals so that size-p max/avg pooling over
contiguous groups implements pooling on the coarsening tree
(see ``cnn_graph_tpu.ops.pooling``).

All randomness is explicit: pass ``seed`` for reproducible coarsenings
(the reference used the global ``np.random`` state, coarsening.py:56).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse

__all__ = [
    "coarsen",
    "graclus",
    "graclus_pairing",
    "compute_perm",
    "perm_data",
    "perm_adjacency",
]


def coarsen(A: scipy.sparse.spmatrix, levels: int, self_connections: bool = False,
            seed: int | None = None, verbose: bool = True):
    """Coarsen adjacency ``A`` over ``levels`` levels.

    Returns ``(graphs, perm)``: ``graphs[i]`` is the level-i adjacency
    (CSR, fake nodes added, rows/cols permuted for binary-tree pooling)
    and ``perm`` reorders level-0 node signals accordingly (``None`` when
    ``levels == 0``).  Parity with ``coarsening.coarsen``
    (lib/coarsening.py:5-31).
    """
    graphs, parents = graclus(A, levels, seed=seed)
    perms = compute_perm(parents)

    for i, g in enumerate(graphs):
        M = g.shape[0]
        if not self_connections:
            g = g.tolil()
            g.setdiag(0)
        if i < levels:
            g = perm_adjacency(g, perms[i])
        g = g.tocsr()
        g.eliminate_zeros()
        graphs[i] = g
        if verbose:
            Mnew = g.shape[0]
            print(
                f"Layer {i}: M_{i} = |V| = {Mnew} nodes ({Mnew - M} added),"
                f"|E| = {g.nnz // 2} edges"
            )

    return graphs, perms[0] if levels > 0 else None


def graclus(W: scipy.sparse.spmatrix, levels: int, rid: np.ndarray | None = None,
            seed: int | None = None):
    """Multilevel randomized heavy-edge matching (Graclus/METIS style).

    Returns ``(graphs, parents)`` where ``graphs[0]`` is the input and
    ``parents[i]`` maps level-i vertices to their level-(i+1) cluster.
    Parity with ``coarsening.metis`` (lib/coarsening.py:34-115): Graclus
    normalized-cut weights ``w_ij (1/d_i + 1/d_j)``, coarse weights by
    cluster-summing, next visit order by ascending coarse degree.
    """
    N = W.shape[0]
    if rid is None:
        rid = np.random.default_rng(seed).permutation(N)

    graphs = [W]
    parents = []
    # Pairing weights: degrees without self-loops at the finest level.
    degree = np.asarray(W.sum(axis=0)).ravel() - W.diagonal()

    for _ in range(levels):
        csr = W.tocsr()
        weights = np.asarray(degree).ravel()
        # Native C++ matching when available (identical algorithm; the
        # Python loop is latency-bound on multi-million-edge graphs).
        from cnn_graph_tpu import native

        cluster = native.graclus_one_level_native(
            csr.indptr, csr.indices, csr.data, rid, weights
        )
        if cluster is None:
            cluster = graclus_pairing(
                csr.indptr, csr.indices, csr.data, rid, weights
            )
        parents.append(cluster)

        # Coarse graph: sum edge weights over cluster pairs (duplicate
        # (row, col) entries are accumulated by the sparse constructor).
        coo = W.tocoo()
        n_coarse = int(cluster.max()) + 1
        W = scipy.sparse.csr_matrix(
            (coo.data, (cluster[coo.row], cluster[coo.col])),
            shape=(n_coarse, n_coarse),
        )
        W.eliminate_zeros()
        graphs.append(W)

        # Next pass: visit lowest-degree vertices first; pairing weights
        # include self-loops (matches the reference's level>0 behavior).
        degree = np.asarray(W.sum(axis=0)).ravel()
        rid = np.argsort(degree)

    return graphs, parents


def graclus_pairing(indptr, indices, data, rid, weights) -> np.ndarray:
    """One level of greedy matching over a CSR graph.

    Visits vertices in ``rid`` order; each unmatched vertex grabs the
    unmatched neighbour maximizing the Graclus gain
    ``w_ij * (1/d_i + 1/d_j)`` (strictly positive), else stays a singleton.
    Parity with ``coarsening.metis_one_level`` (lib/coarsening.py:119-165),
    rewritten over CSR ``indptr`` instead of a hand-built row index.
    """
    N = len(indptr) - 1
    matched = np.zeros(N, dtype=bool)
    cluster = np.zeros(N, dtype=np.int32)
    n_clusters = 0

    for tid in rid:
        if matched[tid]:
            continue
        matched[tid] = True
        best_gain = 0.0
        best = -1
        for e in range(indptr[tid], indptr[tid + 1]):
            nid = indices[e]
            if matched[nid]:
                continue
            gain = data[e] * (1.0 / weights[tid] + 1.0 / weights[nid])
            if gain > best_gain:
                best_gain = gain
                best = nid
        cluster[tid] = n_clusters
        if best >= 0:
            cluster[best] = n_clusters
            matched[best] = True
        n_clusters += 1

    return cluster


def compute_perm(parents: list[np.ndarray]) -> list[list[int]]:
    """Node orderings (finest first) that lay each coarse node's children
    out contiguously, appending fake singleton children as needed, so that
    pooling is a reshape+reduce over groups of 2 per level.

    Parity with ``coarsening.compute_perm`` (lib/coarsening.py:167-214),
    including its import-time test vector (kept as a unit test in
    tests/test_coarsening.py rather than a module-level assert).
    """
    orderings: list[list[int]] = []
    if parents:
        coarsest = int(max(parents[-1])) + 1
        orderings.append(list(range(coarsest)))

    for parent in parents[::-1]:
        next_fake = len(parent)  # fake nodes get ids past the real ones
        layer: list[int] = []
        for cluster_id in orderings[-1]:
            children = list(np.where(parent == cluster_id)[0])
            assert 0 <= len(children) <= 2
            if len(children) == 1:
                # Singleton: pair it with a fresh fake node.
                children.append(next_fake)
                next_fake += 1
            elif len(children) == 0:
                # The parent itself is fake: both children are fake.
                children = [next_fake, next_fake + 1]
                next_fake += 2
            layer.extend(children)
        orderings.append(layer)

    # Invariants: each layer doubles and is a permutation of range(M).
    if parents:
        for i, layer in enumerate(orderings):
            assert sorted(layer) == list(range(coarsest * 2**i))

    return orderings[::-1]


def perm_data(x: np.ndarray, indices: list[int] | None) -> np.ndarray:
    """Reorder node signals by ``indices``; fake vertices get zeros so the
    max-pool over {real, fake} groups selects the real value.

    ``x`` is ``(N, M)`` or ``(N, M, F)`` (the reference's perm_data,
    lib/coarsening.py:219-240, handles only 2-D).  Zero + max-pool is the
    fake-node contract (coarsening.py:236-239); preserved exactly, ReLU
    interaction included.
    """
    if indices is None:
        return x
    M = x.shape[1]
    Mnew = len(indices)
    assert Mnew >= M
    idx = np.asarray(indices)
    out_shape = (x.shape[0], Mnew) + x.shape[2:]
    xnew = np.zeros(out_shape, dtype=x.dtype)
    real = idx < M
    xnew[:, np.nonzero(real)[0]] = x[:, idx[real]]
    return xnew


def perm_adjacency(A: scipy.sparse.spmatrix, indices: list[int] | None):
    """Reorder adjacency rows/cols by ``indices``, first growing the matrix
    with isolated fake vertices.  Parity with ``coarsening.perm_adjacency``
    (lib/coarsening.py:242-269)."""
    if indices is None:
        return A
    A = A.tocoo()
    M = A.shape[0]
    Mnew = len(indices)
    assert Mnew >= M

    # Position of each old vertex id in the new ordering.
    new_pos = np.argsort(indices)
    return scipy.sparse.coo_matrix(
        (A.data, (new_pos[A.row], new_pos[A.col])), shape=(Mnew, Mnew)
    )
