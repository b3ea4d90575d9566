"""Node-dimension (tensor) parallelism: edge-partitioned Laplacian SpMM.

The Chebyshev recurrence's hot op is ``L @ X`` over the node axis.  To
scale past one device's memory we row-partition L over the mesh's ``nodes``
axis: each shard owns the Laplacian rows (all columns) and the activation
rows for M/n nodes.  Per hop, each shard all-gathers the activation rows
it lacks and contracts its local row block:

    X_full  = all_gather(X_local, 'nodes')        # [Mp, C] on every shard
    Y_local = L_rows_local @ X_full               # [Mp/n, C]

This is the all-gather formulation — communication-optimal when the graph
has no exploitable cut structure and always correct.  (A halo-exchange
variant that ships only boundary nodes per hop is the planned
optimization for graphs whose edge-cut << M; see SURVEY.md §2.3.)

Batch axes stay under GSPMD control (``auto={'data'}``), so the same
operator composes with data parallelism in one jitted train step.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse

from cnn_graph_tpu.ops.laplacian import ChebyHopMixin
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cnn_graph_tpu.graphs.construction import rescale_laplacian

__all__ = ["NodeShardedLaplacian", "node_sharded_laplacian"]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["mat"],
    meta_fields=["mesh", "m", "m_padded", "nnz"],
)
@dataclasses.dataclass(frozen=True)
class NodeShardedLaplacian(ChebyHopMixin):
    """Rescaled Laplacian, rows sharded over the mesh's ``nodes`` axis.

    Drop-in for the single-chip operators in ops/laplacian.py: exposes the
    same ``matmul([Mp, C]) -> [Mp, C]`` used by ops.filters.cheby_basis.
    """

    mat: jax.Array  # [Mp, Mp], sharding P('nodes', None)
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int

    @property
    def compute_dtype(self):
        return self.mat.dtype

    def matmul(self, x: jax.Array) -> jax.Array:
        def local_matmul(L_rows, x_local):
            x_full = jax.lax.all_gather(
                x_local, "nodes", axis=0, tiled=True
            )  # [Mp, C]
            return jnp.dot(
                L_rows, x_full, preferred_element_type=x.dtype
            )  # [Mp/n, C]

        # Only 'nodes' is manual; batch axes stay under GSPMD ('data' auto).
        return jax.shard_map(
            local_matmul,
            mesh=self.mesh,
            in_specs=(P("nodes", None), P("nodes", None)),
            out_specs=P("nodes", None),
            axis_names={"nodes"},
            check_vma=False,
        )(self.mat, x)


def node_sharded_laplacian(
    L: scipy.sparse.spmatrix,
    mesh: Mesh,
    lmax: float = 2.0,
    rescale: bool = True,
    dtype=jnp.float32,
) -> NodeShardedLaplacian:
    """Build a row-sharded dense Laplacian operator on ``mesh``.

    Node count is padded so every shard holds a 128-aligned row block.
    """
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    m = L.shape[0]
    n_shards = mesh.shape["nodes"]
    tile = 8 * n_shards
    mp = -(-m // tile) * tile

    dense = np.zeros((mp, mp), np.float32)
    dense[:m, :m] = L.toarray()
    mat = jax.device_put(
        jnp.asarray(dense, dtype=dtype),
        NamedSharding(mesh, P("nodes", None)),
    )
    return NodeShardedLaplacian(
        mat=mat, mesh=mesh, m=m, m_padded=mp, nnz=int(L.nnz)
    )
