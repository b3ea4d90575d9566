"""Halo-exchange node parallelism: ship only boundary nodes per hop.

The all-gather operator (parallel/node_sharded.py) moves every shard's
full activation block to every device each hop — O(M * C) bytes of
interconnect traffic per hop.  For graphs with a small edge cut under a contiguous (e.g. RCM)
node ordering, each shard's rows only reference a thin halo of remote
nodes; this module precomputes the exchange plan on the host and runs the
hop as

    send_buf = gather(x_local, send_idx)        # boundary rows, per peer
    recv     = all_to_all(send_buf, 'nodes')    # one exchange
    y_local  = L_ext @ concat([x_local, recv])  # local matmul

moving only O(halo * C) bytes.  This is the framework's custom
communication layer (SURVEY.md §2.3: the reference has no distributed
execution at all; this is the framework's scale-out path for the
Chebyshev SpMM).

The plan is SPMD-uniform: per-peer halos are padded to the maximum pair
halo so every shard runs the same program.
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

__all__ = [
    "HaloShardedLaplacian",
    "halo_sharded_laplacian",
    "build_halo_plan",
    "halo_exchange_columns",
]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["mat_ext", "send_idx"],
    meta_fields=["mesh", "m", "m_padded", "nnz", "halo", "rows_per_shard"],
)
@dataclasses.dataclass(frozen=True)
class HaloShardedLaplacian(ChebyHopMixin):
    """Row-sharded Laplacian whose local blocks reference
    ``[local rows | halo slots]`` columns.

    ``mat_ext``: [Mp, Ms + n*H] — shard s's rows against its extended
    column space (sharded P('nodes', None)).
    ``send_idx``: [n, n, H] int32 — ``send_idx[s, t]`` are shard-s-local
    row positions to send to shard t (padded with 0; padded slots are
    never referenced by any ``mat_ext`` column).
    """

    mat_ext: jax.Array
    send_idx: jax.Array
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int

    @property
    def compute_dtype(self):
        return self.mat_ext.dtype

    def matmul(self, x: jax.Array) -> jax.Array:
        """``L @ x`` for ``x`` [Mp, C] sharded P('nodes', None)."""
        n = self.mesh.shape["nodes"]
        H = self.halo

        def local_matmul(L_ext, send_idx_local, x_local):
            x_ext = halo_exchange_columns(x_local, send_idx_local, n, H)
            return jnp.dot(L_ext, x_ext, preferred_element_type=x.dtype)

        return jax.shard_map(
            local_matmul,
            mesh=self.mesh,
            in_specs=(P("nodes", None), P("nodes", None, None),
                      P("nodes", None)),
            out_specs=P("nodes", None),
            axis_names={"nodes"},
            check_vma=False,
        )(self.mat_ext, self.send_idx, x)


def build_halo_plan(L: scipy.sparse.spmatrix, n: int, tile: int = 8):
    """Compute the halo-exchange plan for a contiguous n-way row partition.

    Returns ``(Lp, mp, ms, need, send_idx, H)``: the zero-padded matrix,
    padded size, rows per shard, per-pair needed remote columns, the
    SPMD-uniform send-index tensor [n, n, H], and the pair-halo width.
    Shared by the dense (HaloShardedLaplacian) and block-sparse
    (parallel.sparse_halo) operators.
    """
    m = L.shape[0]
    step = tile * n
    mp = -(-m // step) * step
    ms = mp // n

    Lp = scipy.sparse.csr_matrix((L.data, L.indices, L.indptr), shape=(m, mp))
    Lp.resize(mp, mp)

    need = [[np.array([], np.int64) for _ in range(n)] for _ in range(n)]
    for s in range(n):
        block = Lp[s * ms : (s + 1) * ms]
        cols = np.unique(block.indices)
        remote = cols[(cols < s * ms) | (cols >= (s + 1) * ms)]
        owners = remote // ms
        for t in range(n):
            need[s][t] = remote[owners == t]

    H = max((len(need[s][t]) for s in range(n) for t in range(n)), default=0)
    H = max(H, 1)  # keep shapes non-degenerate

    send_idx = np.zeros((n, n, H), np.int32)
    for s in range(n):
        for t in range(n):
            cols = need[s][t]
            send_idx[t, s, : len(cols)] = cols - t * ms
    return Lp, mp, ms, need, send_idx, H


def halo_exchange_columns(x_local, send_idx_local, n: int, H: int):
    """The per-hop exchange: gather boundary rows per peer, one
    ``all_to_all``, return ``[local | halo]`` extended rows.  Runs inside
    shard_map over the ``nodes`` axis; shared by both halo operators."""
    sidx = send_idx_local[0]  # [n, H]
    send_buf = jnp.take(x_local, sidx.reshape(-1), axis=0)
    send_buf = send_buf.reshape(n, H, x_local.shape[1])
    recv = jax.lax.all_to_all(
        send_buf, "nodes", split_axis=0, concat_axis=0, tiled=False
    )
    return jnp.concatenate(
        [x_local, recv.reshape(n * H, x_local.shape[1])], axis=0
    )


def halo_sharded_laplacian(
    L: scipy.sparse.spmatrix,
    mesh: Mesh,
    lmax: float = 2.0,
    rescale: bool = True,
    dtype=jnp.float32,
) -> HaloShardedLaplacian:
    """Build the halo-exchange operator: contiguous row partition over the
    mesh's ``nodes`` axis, per-peer boundary index plan, and local
    extended-column blocks.

    Use a bandwidth-reducing node ordering first
    (graphs.construction.bandwidth_reducing_permutation) — halo size is
    the edge cut of the contiguous partition.
    """
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    m = L.shape[0]
    n = mesh.shape["nodes"]
    Lp, mp, ms, need, send_idx, H = build_halo_plan(L, n)

    # Extended-column local blocks: columns [0, ms) local, then for each
    # peer t a slot range [ms + t*H, ms + t*H + len(need[s][t])).
    mat_ext = np.zeros((mp, ms + n * H), np.float32)
    for s in range(n):
        block = Lp[s * ms : (s + 1) * ms].tocoo()
        # Map global col -> extended-local col.
        col_map = {}
        for c in range(s * ms, (s + 1) * ms):
            col_map[c] = c - s * ms
        for t in range(n):
            for slot, c in enumerate(need[s][t]):
                col_map[int(c)] = ms + t * H + slot
        ext_cols = np.array([col_map[int(c)] for c in block.col], np.int64)
        mat_ext[s * ms + block.row, ext_cols] = block.data

    mat_dev = jax.device_put(
        jnp.asarray(mat_ext, dtype=dtype), NamedSharding(mesh, P("nodes", None))
    )
    sidx_dev = jax.device_put(
        jnp.asarray(send_idx), NamedSharding(mesh, P("nodes", None, None))
    )
    return HaloShardedLaplacian(
        mat_ext=mat_dev,
        send_idx=sidx_dev,
        mesh=mesh,
        m=m,
        m_padded=mp,
        nnz=int(L.nnz),
        halo=H,
        rows_per_shard=ms,
    )
