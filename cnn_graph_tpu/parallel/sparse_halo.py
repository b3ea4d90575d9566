"""Block-sparse halo-exchange operator: edge-partitioned SpMM at scales
where the dense per-shard matrix is impossible.

The dense halo operator (parallel/halo.py) stores each shard's rows as a
dense ``[Ms, Ms + n*H]`` block — fine to ~10k nodes/shard, hopeless at
ogbn-papers100M scale (BASELINE.json config 5).  This operator keeps the
same exchange plan but stores each shard's extended-column matrix as
128 x 128 block-sparse rows in the grouped layout of
``ops.laplacian.pack_bsr_groups``, with one static group list for all
shards so every shard runs one SPMD program:

    x_ext   = [local rows | halo recv]           (one all_to_all per hop)
    y_local[r] = sum_k blocks[r, k] @ x_ext[cols[r, k]]   (dense tiles)

A shard's j-th longest block row is padded to the longest j-th row
among shards (rounded to a tile-count level), so shards of similar
degree profile store under 1.5x their nonzero tiles, and none stores
more than padding every row to the longest would; per-hop halo traffic
is O(edge cut) — the multi-device scale path for the Chebyshev
recurrence.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cnn_graph_tpu.graphs.construction import rescale_laplacian
from cnn_graph_tpu.ops.backend import band_kernel
from cnn_graph_tpu.ops.laplacian import (
    ChebyHopMixin,
    QuantOpMixin,
    global_int8,
    bsr_windows,
    pack_block_sparse,
    pack_bsr_groups,
    quant_emit,
)
from cnn_graph_tpu.parallel.halo import build_halo_plan, halo_exchange_columns

__all__ = ["SparseHaloLaplacian", "BandedSparseHaloLaplacian",
           "QuantSparseHaloLaplacian", "QuantBandedSparseHaloLaplacian",
           "sparse_halo_laplacian", "quantize_sparse_halo"]


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks", "block_cols", "row_pos", "send_idx"],
    meta_fields=["mesh", "m", "m_padded", "nnz", "halo", "rows_per_shard",
                 "block_shape", "ext_cols_padded", "groups", "n_tiles"],
)
@dataclasses.dataclass(frozen=True)
class SparseHaloLaplacian(ChebyHopMixin):
    """Row-sharded block-sparse Laplacian with halo exchange.

    Leading axis of every data field is the shard axis (sharded
    P('nodes')); each shard's tiles are in the grouped layout of
    ``pack_bsr_groups`` under the shared ``groups``, padding slots zero
    tiles at column 0 — they contribute nothing.  ``n_tiles`` counts
    the nonzero tiles over all shards.
    """

    blocks: jax.Array       # [n, T, br, bc]
    block_cols: jax.Array   # [n, T] int32 (extended-column blocks)
    row_pos: jax.Array      # [n, nrb_s] int32
    send_idx: jax.Array     # [n, n, H] int32
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int
    block_shape: tuple
    ext_cols_padded: int    # extended column space, padded to bc
    groups: tuple
    n_tiles: int

    @property
    def compute_dtype(self):
        return self.blocks.dtype

    def matmul(self, x: jax.Array) -> jax.Array:
        """``L @ x`` for ``x`` [Mp, C] sharded P('nodes', None).

        Differentiable via a custom VJP (``dx = L @ g`` — the rescaled
        Laplacian is symmetric), which keeps autodiff out of the
        shard_map internals."""
        return _sparse_halo_matmul(self, x)

    def _matmul_impl(self, x: jax.Array) -> jax.Array:
        return _sparse_apply(self, x, None)


def _sparse_apply(op, x: jax.Array, x0: jax.Array | None,
                  band_scale: float | None = None) -> jax.Array:
    """Shared shard-local BSR apply for the f32 and int8 operators.

    ``band_scale`` enables the quantized path: int8 blocks x int8
    activations, int32 tile taps per row group, fused hop update and
    dequant/requant at emission — the same integer arithmetic as
    ``QuantBandedLaplacian._call``, so the quantized BSR-halo chain is
    bit-exact with the single-chip one (and the halo all_to_all moves
    int8 payloads — half the bf16 bytes)."""
    n = op.mesh.shape["nodes"]
    H = op.halo
    br, bc = op.block_shape
    ms = op.rows_per_shard
    ext_p = op.ext_cols_padded
    quant = band_scale is not None

    def local_matmul(blocks, bcols, row_pos, send_idx_local, *xs):
        blocks, bcols, row_pos = blocks[0], bcols[0], row_pos[0]
        x_local = xs[0]
        x0_local = xs[1] if len(xs) > 1 else None
        x_ext = halo_exchange_columns(x_local, send_idx_local, n, H)
        pad = ext_p - x_ext.shape[0]
        if pad:
            x_ext = jnp.pad(x_ext, ((0, pad), (0, 0)))
        if quant:
            acc = bsr_windows(blocks, bcols, row_pos, op.groups,
                              op.block_shape, x_ext, jnp.int32)
            return quant_emit(acc, band_scale, x0_local)
        yb = bsr_windows(blocks.astype(x.dtype), bcols, row_pos, op.groups,
                         op.block_shape, x_ext, x.dtype)
        if x0_local is not None:
            yb = 2.0 * yb - x0_local
        return yb.astype(x.dtype)

    operands = (op.blocks, op.block_cols, op.row_pos, op.send_idx,
                x) + ((x0,) if x0 is not None else ())
    in_specs = (P("nodes"), P("nodes"), P("nodes"),
                P("nodes", None, None), P("nodes", None)) + (
        (P("nodes", None),) if x0 is not None else ()
    )
    # Fully-manual shard_map (all mesh axes): activations are
    # replicated over non-'nodes' axes in this operator's use case
    # (whole-graph node models carry no batch dim).  Partial-manual +
    # custom_vjp trips a JAX spec-inference limitation.
    return jax.shard_map(
        local_matmul,
        mesh=op.mesh,
        in_specs=in_specs,
        out_specs=P("nodes", None),
        axis_names=set(op.mesh.axis_names),
        check_vma=False,
    )(*operands)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["band", "base", "colperm", "send_idx"],
    meta_fields=["mesh", "m", "m_padded", "nnz", "halo", "rows_per_shard",
                 "block_shape", "ext_cols_padded"],
)
@dataclasses.dataclass(frozen=True)
class BandedSparseHaloLaplacian(ChebyHopMixin):
    """Sparse-halo operator whose per-shard compute is the BANDED kernel.

    For graphs whose shards are internally bandable even when the global
    ordering is not: each shard's extended-column
    matrix gets a private column ordering (by mean nonzero row — data
    field ``colperm``) that pulls its referenced halo slots into band
    position, then packs into the uniform band layout
    (``band [n, nbr_s, W, br, bc]``, ``base [n, nbr_s]`` monotone per
    shard).  Per hop the shard gathers ``x_ext[colperm]`` (one extra
    activation pass) and runs the single-chip banded pass (on the GPU
    ``ops.pallas_band.banded_call``) instead of the BSR
    row-group gathers.  Exchange plan and halo traffic are identical to
    SparseHaloLaplacian's.
    """

    band: jax.Array         # [n, nbr_s, W, br, bc]
    base: jax.Array         # [n, nbr_s] int32, monotone per shard
    colperm: jax.Array      # [n, ext_p] int32: new pos -> old ext col
    send_idx: jax.Array     # [n, n, H] int32
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int
    block_shape: tuple
    ext_cols_padded: int

    @property
    def compute_dtype(self):
        return self.band.dtype

    def matmul(self, x: jax.Array) -> jax.Array:
        return _banded_sparse_halo_matmul(self, x)

    def cheby_hop(self, x1: jax.Array, x0: jax.Array) -> jax.Array:
        return _banded_sparse_halo_hop(self, x1, x0)

    def _apply_impl(self, x: jax.Array, x0: jax.Array | None) -> jax.Array:
        return _banded_sparse_apply(self, x, x0)


def _banded_sparse_apply(op, x: jax.Array, x0: jax.Array | None,
                         band_scale: float | None = None) -> jax.Array:
    """Shared shard-local banded apply for the f32 and int8 operators
    (``band_scale`` enables the quantized path — same integer arithmetic
    as the single-chip kernel, int8 halo payloads)."""
    n = op.mesh.shape["nodes"]
    H = op.halo
    br, bc = op.block_shape
    ms = op.rows_per_shard
    ext_p = op.ext_cols_padded
    quant = band_scale is not None

    def local(band, base, colperm, send_idx_local, *xs):
        band, base, colperm = band[0], base[0], colperm[0]
        x_local = xs[0]
        x0_local = xs[1] if len(xs) > 1 else None
        x_ext = halo_exchange_columns(x_local, send_idx_local, n, H)
        pad = ext_p - x_ext.shape[0]
        if pad:
            x_ext = jnp.pad(x_ext, ((0, pad), (0, 0)))
        x_perm = jnp.take(x_ext, colperm, axis=0)
        _nb, W, _br, _bc = band.shape
        if band_kernel(band.dtype):
            from cnn_graph_tpu.ops.pallas_band import (
                banded_call,
                uniform_rows,
            )

            return banded_call(
                band.reshape(-1, br, bc), base,
                jnp.asarray(uniform_rows(_nb, W)), x_perm, x0_local,
                out_rows=ms, max_width=W, band_scale=band_scale,
            ).astype(x.dtype)
        xb = x_perm.reshape(ext_p // bc, bc, -1)
        cols = base[:, None] + jnp.arange(W)[None, :]
        wins = jnp.take(xb, cols, axis=0)
        if quant:
            acc = jnp.einsum(
                "iwab,iwbc->iac", band, wins,
                preferred_element_type=jnp.int32,
            ).reshape(ms, -1)
            return quant_emit(acc, band_scale, x0_local)
        y = jnp.einsum(
            "iwab,iwbc->iac", band.astype(x.dtype), wins,
            preferred_element_type=jnp.float32,
        ).reshape(ms, -1)
        if x0_local is not None:
            y = 2.0 * y - x0_local
        return y.astype(x.dtype)

    operands = (op.band, op.base, op.colperm, op.send_idx,
                x) + ((x0,) if x0 is not None else ())
    in_specs = (P("nodes"), P("nodes"), P("nodes"),
                P("nodes", None, None), P("nodes", None)) + (
        (P("nodes", None),) if x0 is not None else ()
    )
    return jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=in_specs,
        out_specs=P("nodes", None),
        axis_names=set(op.mesh.axis_names),
        check_vma=False,
    )(*operands)


@jax.custom_vjp
def _banded_sparse_halo_matmul(op, x):
    return op._apply_impl(x, None)


def _bshm_fwd(op, x):
    return op._apply_impl(x, None), op


def _bshm_bwd(op, g):
    from cnn_graph_tpu.ops.laplacian import zero_cotangent

    return zero_cotangent(op), op._apply_impl(g, None)


_banded_sparse_halo_matmul.defvjp(_bshm_fwd, _bshm_bwd)


@jax.custom_vjp
def _banded_sparse_halo_hop(op, x1, x0):
    return op._apply_impl(x1, x0)


def _bshh_fwd(op, x1, x0):
    return op._apply_impl(x1, x0), op


def _bshh_bwd(op, g):
    from cnn_graph_tpu.ops.laplacian import zero_cotangent

    dx1 = 2.0 * op._apply_impl(g, None)
    return zero_cotangent(op), dx1.astype(g.dtype), -g


_banded_sparse_halo_hop.defvjp(_bshh_fwd, _bshh_bwd)


def _build_banded_sparse_halo(packed, W, mesh, m, mp, nnz, H, ms, ext_p,
                              block_shape, send_idx, dtype):
    """Assemble the uniform [n, nbr_s, W, br, bc] band arrays from the
    per-shard packings (W maxed across shards for one SPMD program)."""
    br, bc = block_shape
    n = len(packed)
    nbr = ms // br
    n_cb = ext_p // bc
    band = np.zeros((n, nbr, W, br, bc), np.dtype(dtype))
    base_all = np.zeros((n, nbr), np.int32)
    colperm = np.zeros((n, ext_p), np.int32)
    for s, (rows, cols, data, base, _w, order) in enumerate(packed):
        base = np.clip(base, 0, max(n_cb - W, 0)).astype(np.int64)
        brow = rows // br
        band[s, brow, cols // bc - base[brow], rows % br, cols % bc] = (
            data.astype(band.dtype)
        )
        base_all[s] = base.astype(np.int32)
        colperm[s] = order.astype(np.int32)

    shard = lambda spec: NamedSharding(mesh, spec)  # noqa: E731
    return BandedSparseHaloLaplacian(
        band=jax.device_put(jnp.asarray(band, dtype=dtype),
                            shard(P("nodes"))),
        base=jax.device_put(jnp.asarray(base_all), shard(P("nodes"))),
        colperm=jax.device_put(jnp.asarray(colperm), shard(P("nodes"))),
        send_idx=jax.device_put(jnp.asarray(send_idx),
                                shard(P("nodes", None, None))),
        mesh=mesh,
        m=m,
        m_padded=mp,
        nnz=nnz,
        halo=H,
        rows_per_shard=ms,
        block_shape=block_shape,
        ext_cols_padded=ext_p,
    )


def _pack_local_banded(block, ms, ext_p, block_shape):
    """Column-order one shard's extended matrix by mean nonzero row and
    compute its band geometry.  Returns (rows, new_cols, data, base, W,
    order) — packing into the uniform array happens after W is maxed
    across shards."""
    br, bc = block_shape
    rows = block.row.astype(np.int64)
    cols = block.col.astype(np.int64)
    col_sum = np.zeros(ext_p, np.float64)
    col_cnt = np.zeros(ext_p, np.int64)
    np.add.at(col_sum, cols, rows)
    np.add.at(col_cnt, cols, 1)
    key = np.where(col_cnt > 0, col_sum / np.maximum(col_cnt, 1), np.inf)
    order = np.argsort(key, kind="stable")  # new pos -> old col
    colpos = np.empty(ext_p, np.int64)
    colpos[order] = np.arange(ext_p)
    new_cols = colpos[cols]

    nbr = ms // br
    n_cb = ext_p // bc
    brow = rows // br
    bcol = new_cols // bc
    lo = np.full(nbr, n_cb, np.int64)
    hi = np.full(nbr, -1, np.int64)
    np.minimum.at(lo, brow, bcol)
    np.maximum.at(hi, brow, bcol)
    base = np.minimum.accumulate(lo[::-1])[::-1]  # suffix min, monotone
    W = int(max((hi - base).max() + 1, 1))
    return rows, new_cols, block.data, base, W, order


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks", "block_cols", "row_pos", "send_idx"],
    meta_fields=["mesh", "m", "m_padded", "nnz", "halo", "rows_per_shard",
                 "block_shape", "ext_cols_padded", "groups", "n_tiles",
                 "band_scale", "act_scale", "headroom"],
)
@dataclasses.dataclass(frozen=True)
class QuantSparseHaloLaplacian(QuantOpMixin):
    """Int8 twin of :class:`SparseHaloLaplacian` — multi-chip serving on
    SCATTERED graphs: int8 tile taps with int32 sums per shard, int8
    recurrence carries over the all_to_all halo (half the bf16 halo
    bytes), dequant/requant at emission (bit-exact with the single-chip
    quantized chain)."""

    blocks: jax.Array       # [n, T, br, bc] int8
    block_cols: jax.Array
    row_pos: jax.Array
    send_idx: jax.Array
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int
    block_shape: tuple
    ext_cols_padded: int
    groups: tuple
    n_tiles: int
    band_scale: float = 1.0
    act_scale: float = 1.0
    headroom: float = 2.0

    def spmm_q(self, x_q: jax.Array) -> jax.Array:
        return _sparse_apply(self, x_q, None, band_scale=self.band_scale)

    def cheby_hop_q(self, x1_q: jax.Array, x0_q: jax.Array) -> jax.Array:
        return _sparse_apply(self, x1_q, x0_q, band_scale=self.band_scale)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["band", "base", "colperm", "send_idx"],
    meta_fields=["mesh", "m", "m_padded", "nnz", "halo", "rows_per_shard",
                 "block_shape", "ext_cols_padded", "band_scale",
                 "act_scale", "headroom"],
)
@dataclasses.dataclass(frozen=True)
class QuantBandedSparseHaloLaplacian(QuantOpMixin):
    """Int8 twin of :class:`BandedSparseHaloLaplacian`: the per-shard
    quantized banded pass behind the all_to_all halo exchange."""

    band: jax.Array         # [n, nbr_s, W, br, bc] int8
    base: jax.Array
    colperm: jax.Array
    send_idx: jax.Array
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo: int
    rows_per_shard: int
    block_shape: tuple
    ext_cols_padded: int
    band_scale: float = 1.0
    act_scale: float = 1.0
    headroom: float = 2.0

    @property
    def band_width(self):
        return self.band.shape[2]

    def spmm_q(self, x_q: jax.Array) -> jax.Array:
        return _banded_sparse_apply(self, x_q, None,
                                    band_scale=self.band_scale)

    def cheby_hop_q(self, x1_q: jax.Array, x0_q: jax.Array) -> jax.Array:
        return _banded_sparse_apply(self, x1_q, x0_q,
                                    band_scale=self.band_scale)


def quantize_sparse_halo(op, headroom: float = 2.0, sample_x: float = 1.0):
    """Quantize a sparse-halo operator (BSR or per-shard-banded) for
    int8 multi-chip serving.  Same scale design as ``quantize_banded``:
    one global band scale ``max|L| / 127`` (a device reduce over the
    sharded data), one activation scale with carry ``headroom``."""
    data = op.band if isinstance(op, BandedSparseHaloLaplacian) else op.blocks
    data_q, s_b = global_int8(data)
    common = dict(
        send_idx=op.send_idx, mesh=op.mesh, m=op.m, m_padded=op.m_padded,
        nnz=op.nnz, halo=op.halo, rows_per_shard=op.rows_per_shard,
        block_shape=op.block_shape, ext_cols_padded=op.ext_cols_padded,
        band_scale=s_b, act_scale=float(sample_x) * headroom / 127.0,
        headroom=headroom,
    )
    if isinstance(op, BandedSparseHaloLaplacian):
        return QuantBandedSparseHaloLaplacian(
            band=data_q, base=op.base, colperm=op.colperm, **common,
        )
    return QuantSparseHaloLaplacian(
        blocks=data_q, block_cols=op.block_cols, row_pos=op.row_pos,
        groups=op.groups, n_tiles=op.n_tiles, **common,
    )


@jax.custom_vjp
def _sparse_halo_matmul(op, x):
    return op._matmul_impl(x)


def _shm_fwd(op, x):
    return op._matmul_impl(x), op


def _shm_bwd(op, g):
    from cnn_graph_tpu.ops.laplacian import zero_cotangent

    # L symmetric: adjoint = itself; the operator gets zero cotangents.
    return zero_cotangent(op), op._matmul_impl(g)


_sparse_halo_matmul.defvjp(_shm_fwd, _shm_bwd)


def sparse_halo_laplacian(
    L: scipy.sparse.spmatrix,
    mesh: Mesh,
    lmax: float = 2.0,
    rescale: bool = True,
    dtype=jnp.float32,
    block_shape: tuple = (128, 128),
    fmt: str = "bsr",
    max_band_width: int = 32,
):
    """Build the block-sparse halo operator (RCM-order the graph first).

    ``fmt``: ``"bsr"`` (default, grouped block rows per shard),
    ``"banded"`` (per-shard column-ordered band + the banded kernel —
    raises when any shard's band exceeds ``max_band_width``), or
    ``"auto"`` (banded when every shard fits, else bsr)."""
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    m = L.shape[0]
    n = mesh.shape["nodes"]
    br, bc = block_shape
    Lp, mp, ms, need, send_idx, H = build_halo_plan(
        L, n, tile=int(np.lcm(br, bc))
    )
    ms = mp // n
    ext_p = -(-(ms + n * H) // bc) * bc

    locals_ = []
    for s in range(n):
        block = Lp[s * ms : (s + 1) * ms].tocoo()
        # Global col -> extended-local col (local range then halo slots).
        col_map = {}
        for t in range(n):
            for slot, c in enumerate(need[s][t]):
                col_map[int(c)] = ms + t * H + slot
        ext_cols = np.array(
            [
                col_map.get(int(c), int(c) - s * ms)
                for c in block.col
            ],
            np.int64,
        )
        locals_.append(scipy.sparse.coo_matrix(
            (block.data, (block.row, ext_cols)), shape=(ms, ext_p)
        ))

    if fmt in ("banded", "auto"):
        packed = [_pack_local_banded(loc, ms, ext_p, block_shape)
                  for loc in locals_]
        W = max(p[4] for p in packed)
        if W <= max_band_width:
            return _build_banded_sparse_halo(
                packed, W, mesh, m, mp, int(L.nnz), H, ms, ext_p,
                block_shape, send_idx, dtype,
            )
        if fmt == "banded":
            raise ValueError(
                f"per-shard band width {W} exceeds {max_band_width}; "
                "use fmt='bsr' (or fewer shards)"
            )

    csrs = [pack_block_sparse(loc, (br, bc))[:4] for loc in locals_]
    blocks, bcols, row_pos, groups = pack_bsr_groups(csrs)

    shard = lambda spec: NamedSharding(mesh, spec)
    return SparseHaloLaplacian(
        blocks=jax.device_put(jnp.asarray(blocks, dtype=dtype),
                              shard(P("nodes"))),
        block_cols=jax.device_put(jnp.asarray(bcols), shard(P("nodes"))),
        row_pos=jax.device_put(jnp.asarray(row_pos), shard(P("nodes"))),
        send_idx=jax.device_put(jnp.asarray(send_idx),
                                shard(P("nodes", None, None))),
        mesh=mesh,
        m=m,
        m_padded=mp,
        nnz=int(L.nnz),
        halo=H,
        rows_per_shard=ms,
        block_shape=(br, bc),
        ext_cols_padded=ext_p,
        groups=groups,
        n_tiles=sum(len(c[1]) for c in csrs),
    )
