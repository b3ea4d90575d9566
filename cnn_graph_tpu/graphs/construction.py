"""Host-side graph construction: grids, kNN graphs, Laplacians, spectra.

Pure NumPy/SciPy precompute that runs once per experiment on the host; the
resulting Laplacian is shipped to the accelerator as a device operator (see
``cnn_graph_tpu.ops.laplacian``).  Capability parity with the reference's
``lib/graph.py`` (grid :10, distance_* :22-52, adjacency :57, laplacian :117,
lmax :139, fourier :148, lanczos :184, rescale_L :232, chebyshev :241,
replace_random_edges :86), re-designed as deterministic, seedable functions
that never mutate their inputs.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph
import scipy.sparse.linalg
import scipy.spatial
import scipy.spatial.distance

__all__ = [
    "grid",
    "knn",
    "adjacency",
    "knn_graph",
    "replace_random_edges",
    "laplacian",
    "lmax",
    "fourier",
    "rescale_laplacian",
    "chebyshev_basis",
    "lanczos_basis",
    "bandwidth_reducing_permutation",
]


def grid(m: int, dtype=np.float32) -> np.ndarray:
    """Coordinates of an m x m grid embedded in [0, 1]^2.

    Returns ``z`` of shape ``(m*m, 2)``; row ``i*m + j`` is the point
    ``(j/(m-1), i/(m-1))`` — identical embedding to the reference's
    ``graph.grid`` (lib/graph.py:10) so grid Laplacians match.
    """
    ticks = np.linspace(0, 1, m, dtype=dtype)
    cols, rows = np.meshgrid(ticks, ticks)  # 'xy' indexing
    return np.stack([cols.ravel(), rows.ravel()], axis=1).astype(dtype)


def knn(z: np.ndarray, k: int = 4, metric: str = "euclidean",
        algorithm: str = "dense"):
    """k-nearest-neighbour distances.

    Parity with ``graph.distance_scipy_spatial``/``distance_sklearn_metrics``
    (lib/graph.py:22-41) plus a scalable path replacing the reference's
    approximate ``distance_lshforest`` (graph.py:44-52): ``algorithm=
    'dense'`` materializes the full distance matrix (exact, O(M^2)
    memory, any SciPy metric); ``'auto'``/``'kd_tree'``/``'ball_tree'``
    query a ``scipy.spatial.cKDTree`` (exact, scales to millions of
    points; Minkowski metrics only).  Returns ``(dist, idx)`` of shape
    ``(M, k)`` excluding self.
    """
    if algorithm == "dense":
        d = scipy.spatial.distance.squareform(
            scipy.spatial.distance.pdist(z, metric=metric)
        )
        order = np.argsort(d, axis=1)[:, 1 : k + 1]
        dist = np.take_along_axis(d, order, axis=1)
        return dist, order
    if algorithm not in ("auto", "kd_tree", "ball_tree"):
        raise ValueError(f"unknown kNN algorithm {algorithm!r}")
    p = {"euclidean": 2, "minkowski": 2, "manhattan": 1, "cityblock": 1,
         "chebyshev": np.inf}.get(metric)
    if p is None:
        raise ValueError(
            f"metric {metric!r} needs algorithm='dense' (the tree path "
            "supports Minkowski metrics)"
        )
    dist, idx = scipy.spatial.cKDTree(z).query(z, k=k + 1, p=p)
    return dist[:, 1:], idx[:, 1:]


def adjacency(dist: np.ndarray, idx: np.ndarray) -> scipy.sparse.csr_matrix:
    """Gaussian-kernel weighted adjacency of a kNN graph.

    ``W_ij = exp(-d_ij^2 / sigma^2)`` with ``sigma = mean(k-th NN distance)``,
    symmetrised with the elementwise maximum, zero diagonal, CSR output.
    Parity with ``graph.adjacency`` (lib/graph.py:57-83).
    """
    M, k = dist.shape
    assert idx.shape == (M, k)
    assert dist.min() >= 0

    sigma2 = np.mean(dist[:, -1]) ** 2
    vals = np.exp(-(dist**2) / sigma2).ravel()
    rows = np.repeat(np.arange(M), k)
    cols = idx.ravel()

    # Drop self-edges (degenerate duplicate points can produce them).
    keep = rows != cols
    W = scipy.sparse.coo_matrix(
        (vals[keep], (rows[keep], cols[keep])), shape=(M, M)
    ).tocsr()

    # Undirected graph: keep the larger of the two directed weights.
    W = W.maximum(W.T)
    W.eliminate_zeros()

    assert W.nnz % 2 == 0
    assert np.abs(W - W.T).sum() < 1e-8
    return W


def knn_graph(
    z: np.ndarray, k: int = 8, metric: str = "euclidean"
) -> scipy.sparse.csr_matrix:
    """Convenience: points -> Gaussian kNN adjacency in one call."""
    dist, idx = knn(z, k=k, metric=metric)
    return adjacency(dist, idx)


def replace_random_edges(
    A: scipy.sparse.spmatrix, noise_level: float, seed: int | None = None
) -> scipy.sparse.csr_matrix:
    """Replace a fraction of edges with uniformly random unit-weight edges.

    Graph-perturbation robustness tool; parity with
    ``graph.replace_random_edges`` (lib/graph.py:86-114) but seedable.
    """
    M, _ = A.shape
    n = int(noise_level * A.nnz // 2)
    rng = np.random.default_rng(seed)

    upper = scipy.sparse.triu(A, format="coo")
    assert upper.nnz == A.nnz // 2
    assert upper.nnz >= n

    victims = rng.permutation(upper.nnz)[:n]
    new_rows = rng.integers(0, M, n)
    new_cols = rng.integers(0, M, n)

    A = A.tolil()
    for v, r, c in zip(victims, new_rows, new_cols):
        A[upper.row[v], upper.col[v]] = 0
        A[upper.col[v], upper.row[v]] = 0
        A[r, c] = 1
        A[c, r] = 1
    A.setdiag(0)
    A = A.tocsr()
    A.eliminate_zeros()
    return A


def laplacian(
    W: scipy.sparse.spmatrix, normalized: bool = True
) -> scipy.sparse.csr_matrix:
    """Graph Laplacian ``D - W`` or the symmetric-normalized
    ``I - D^-1/2 W D^-1/2``.  Parity with ``graph.laplacian``
    (lib/graph.py:117-136), including the epsilon degree guard for
    isolated vertices."""
    W = W.tocsr()
    d = np.asarray(W.sum(axis=0)).ravel()
    if not normalized:
        L = scipy.sparse.diags(d) - W
    else:
        d = d + np.spacing(np.array(0, W.dtype))
        inv_sqrt = scipy.sparse.diags(1.0 / np.sqrt(d))
        L = scipy.sparse.identity(d.size, dtype=W.dtype) - inv_sqrt @ W @ inv_sqrt
    L = L.tocsr()
    L.eliminate_zeros()
    return L


def lmax(L: scipy.sparse.spmatrix, normalized: bool = True) -> float:
    """Upper bound on the Laplacian spectrum: 2 for the normalized Laplacian,
    otherwise the largest-magnitude eigenvalue (lib/graph.py:139-145)."""
    if normalized:
        return 2.0
    return float(
        scipy.sparse.linalg.eigsh(L, k=1, which="LM", return_eigenvectors=False)[0]
    )


def fourier(L: scipy.sparse.spmatrix, algo: str = "eigh", k: int = 1):
    """Graph Fourier basis: eigendecomposition of the Laplacian, eigenvalues
    ascending.  Parity with ``graph.fourier`` (lib/graph.py:148-166)."""

    def _sorted(lamb, U):
        order = lamb.argsort()
        return lamb[order], U[:, order]

    if algo == "eig":
        return _sorted(*np.linalg.eig(L.toarray()))
    if algo == "eigh":
        return np.linalg.eigh(L.toarray())
    if algo == "eigs":
        return _sorted(*scipy.sparse.linalg.eigs(L, k=k, which="SM"))
    if algo == "eigsh":
        return scipy.sparse.linalg.eigsh(L, k=k, which="SM")
    raise ValueError(f"unknown EVD algorithm {algo!r}")


def rescale_laplacian(
    L: scipy.sparse.spmatrix, lmax: float = 2.0
) -> scipy.sparse.csr_matrix:
    """Map the spectrum of L from [0, lmax] to [-1, 1]: ``2 L / lmax - I``.

    Unlike the reference's ``graph.rescale_L`` (lib/graph.py:232-238), which
    mutates its argument in place (forcing callers to copy defensively,
    e.g. models.py:174), this returns a fresh matrix.
    """
    M = L.shape[0]
    return (
        L * (2.0 / lmax) - scipy.sparse.identity(M, format="csr", dtype=L.dtype)
    ).tocsr()


def chebyshev_basis(L: scipy.sparse.spmatrix, X: np.ndarray, K: int) -> np.ndarray:
    """NumPy oracle for the Chebyshev recurrence: returns ``T_k(L) X`` for
    k < K, shape ``(K, M, N)``.  ``L`` must already be rescaled to [-1, 1].
    Semantics of ``graph.chebyshev`` (lib/graph.py:241-258); used as the
    golden reference for the device filter paths."""
    M, N = X.shape
    Xt = np.empty((K, M, N), X.dtype)
    Xt[0] = X
    if K > 1:
        Xt[1] = L @ X
    for k in range(2, K):
        Xt[k] = 2 * (L @ Xt[k - 1]) - Xt[k - 2]
    return Xt


def lanczos_basis(L: scipy.sparse.spmatrix, X: np.ndarray, K: int) -> np.ndarray:
    """Per-signal K-step Lanczos filter basis, shape ``(K, M, N)``.

    Alternative to the Chebyshev basis; parity with ``graph.lanczos``
    (lib/graph.py:184-229): runs Lanczos on each column of X, diagonalizes
    the tridiagonal H, and returns the rotated basis scaled back by the
    original column norms.
    """
    M, N = X.shape
    norms = np.linalg.norm(X, axis=0)

    a = np.empty((K, N), X.dtype)
    b = np.zeros((K, N), X.dtype)
    V = np.empty((K, M, N), X.dtype)
    V[0] = X / norms
    for k in range(K - 1):
        W = L @ V[k]
        a[k] = np.sum(W * V[k], axis=0)
        W = W - a[k] * V[k] - (b[k] * V[k - 1] if k > 0 else 0)
        b[k + 1] = np.linalg.norm(W, axis=0)
        V[k + 1] = W / b[k + 1]
    a[K - 1] = np.sum((L @ V[K - 1]) * V[K - 1], axis=0)

    # Assemble and diagonalize the N tridiagonal matrices H (K x K each).
    H = np.zeros((N, K, K), a.dtype)
    rows = np.arange(K)
    H[:, rows, rows] = a.T
    H[:, rows[1:], rows[:-1]] = b[1:].T
    Q = np.linalg.eigh(H, UPLO="L")[1]  # (N, K, K)

    # Xt[k, m, n] = sum_j Q[n, j, k] V[j, m, n], scaled by Q[n, 0, k] * |x_n|.
    Xt = np.einsum("njk,jmn->kmn", Q, V)
    Xt *= Q[:, 0, :].T[:, np.newaxis, :]
    Xt *= norms
    return Xt


def bandwidth_reducing_permutation(W: scipy.sparse.spmatrix) -> np.ndarray:
    """Node ordering that clusters each row's neighbours near the diagonal
    (reverse Cuthill-McKee).  Precompute with no reference counterpart:
    applied before block tiling so that the 128x128 Laplacian blocks are
    dense near the diagonal and empty elsewhere — the banded format of
    ops/laplacian.py."""
    perm = scipy.sparse.csgraph.reverse_cuthill_mckee(W.tocsr(), symmetric_mode=True)
    return np.asarray(perm)
