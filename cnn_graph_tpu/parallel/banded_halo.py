"""Banded halo-exchange operator: row-sharded banded SpMM whose
communication is two neighbour ``ppermute`` shifts.

After RCM ordering, shard ``s``'s band only references x rows owned by
shards ``s-1`` and ``s+1`` (a contiguous tail/head of each).  So instead
of the general all_to_all exchange plan (parallel/halo.py,
parallel/sparse_halo.py), each Chebyshev hop moves exactly

    left halo  = last  h_l block-rows of the LEFT  neighbour (shift +1)
    right halo = first h_r block-rows of the RIGHT neighbour (shift -1)

— two ``lax.ppermute`` calls.  Edge shards receive zeros from the
unpaired side, which their band never references (their windows are
interior by construction).

Per shard the compute is the single-chip banded hop on the extended
activations ``[left | local | right]``: on the GPU the Triton kernel
(``ops.pallas_band.banded_call``), elsewhere an XLA window einsum with
the same arithmetic.  The halo blocks simply extend the window space.

Reference parity note: the reference has no distributed execution at all
(SURVEY.md §2.3); this operator is part of the framework's scaling layer
alongside NodeSharded (all-gather), HaloSharded (dense all_to_all) and
SparseHalo (block-sparse all_to_all).
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
    BLOCK,
    ROWS_PER_STEP,
    ChebyHopMixin,
    QuantOpMixin,
    band_stats,
    choose_band_levels,
    global_int8,
    pack_banded,
    quant_emit,
    zero_cotangent,
)
from cnn_graph_tpu.ops.pallas_band import (
    banded_call,
    ragged_rows,
    uniform_rows,
)

__all__ = ["BandedHaloLaplacian", "QuantBandedHaloLaplacian",
           "banded_halo_laplacian", "quantize_banded_halo"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


_FIELDS = dict(
    data_fields=["band", "base", "rows"],
    meta_fields=["mesh", "m", "m_padded", "nnz", "halo_left", "halo_right",
                 "rows_per_shard", "block_shape", "rows_per_step",
                 "max_width", "boundary_pre", "boundary_suf", "overlap",
                 "levels"],
)


@functools.partial(jax.tree_util.register_dataclass, **_FIELDS)
@dataclasses.dataclass(frozen=True)
class BandedHaloLaplacian(ChebyHopMixin):
    """Row-sharded banded Laplacian with neighbour halo exchange.

    ``band``: ``[n, T, br, bc]`` per-shard flat bands (sharded
    P('nodes')); ``rows``: ``[n, 2, nbr_s]`` int32 (flat offset, width)
    per block-row; ``base``: ``[n, nbr_s]`` block-column window bases
    INTO THE EXTENDED column space ``[left halo | local | right halo]``
    of each shard (monotone per shard).  ``levels`` is the ragged width
    palette (empty for the uniform layout).

    ``boundary_pre`` / ``boundary_suf`` split each shard's block-rows
    into a halo-touching prefix/suffix and a halo-free interior (both
    multiples of ``rows_per_step``, max'd across shards).  With
    ``overlap=True`` the interior SpMM is issued with NO data dependence
    on the ppermute results, so XLA's latency-hiding scheduler can run
    the neighbour exchange behind it (SURVEY.md §2.3 "overlapping
    exchange with local SpMM"); only the small prefix/suffix passes wait
    for the halo.
    """

    band: jax.Array
    base: jax.Array
    rows: jax.Array
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo_left: int    # block-rows received from the left neighbour
    halo_right: int   # block-rows received from the right neighbour
    rows_per_shard: int
    block_shape: tuple
    rows_per_step: int
    max_width: int
    boundary_pre: int = 0   # halo-touching prefix block-rows (multiple of G)
    boundary_suf: int = 0   # halo-touching suffix block-rows (multiple of G)
    overlap: bool = False   # interior/boundary split for comm overlap
    levels: tuple = ()

    @property
    def compute_dtype(self):
        return self.band.dtype

    @property
    def band_width(self):
        return self.max_width

    def matmul(self, x: jax.Array) -> jax.Array:
        """``L @ x`` for ``x`` [Mp, C] sharded P('nodes', None)."""
        return _banded_halo_matmul(self, x)

    def cheby_hop(self, x1: jax.Array, x0: jax.Array) -> jax.Array:
        """Fused recurrence hop ``2 (L @ x1) - x0`` (one pass per shard;
        x0 is row-aligned with the output so it rides the same
        sharding)."""
        return _banded_halo_hop(self, x1, x0)

    def cheby_chain(self, x: jax.Array, K: int) -> jax.Array:
        """The stacked K-term Chebyshev basis ``[K, Mp, C]`` with ALL
        hops (ppermutes included) inside ONE shard_map region — one
        dispatch per chain instead of per SpMM.  Differentiable: the
        adjoint recurrence runs as one region too.  Bit-exact with the
        per-hop path."""
        return _banded_halo_chain(self, x, K)

    def _apply_impl(self, x: jax.Array, x0: jax.Array | None) -> jax.Array:
        return _apply_sharded(self, x, x0)


def _ragged_from_uniform(band, G, max_levels: int = 4):
    """Per-shard ragged flat bands and row metadata from the uniform
    per-shard band ``[n, nbr_s, W, br, bc]`` (host-side numpy).

    Each ``G``-row super-step keeps only its widest row's span, rounded
    up to one of <= ``max_levels`` widths chosen once across ALL shards.
    Returns ``(levels, flat [n, T_max, br, bc], rows [n, 2, nbr_s])``.
    """
    n, nbr_s, W, br, bc = band.shape
    assert nbr_s % G == 0
    nsb = nbr_s // G

    # Per-row true span from the rightmost nonzero block (>= 1).
    nz = band.reshape(n, nbr_s, W, -1).any(axis=3)
    has = nz.any(axis=2)
    dmax = W - 1 - np.argmax(nz[:, :, ::-1], axis=2)
    span = np.where(has, dmax + 1, 1).astype(np.int64)

    ws = span.reshape(n, nsb, G).max(axis=2)            # [n, nsb]
    levels = choose_band_levels(ws.reshape(-1), max_levels)
    lv = np.asarray(levels, np.int64)
    lvl_idx = np.searchsorted(lv, ws)                   # [n, nsb]
    wl = lv[lvl_idx]

    offs = np.zeros((n, nsb), np.int64)
    offs[:, 1:] = np.cumsum(G * wl, axis=1)[:, :-1]
    total_max = int((G * wl).sum(axis=1).max())
    flat = np.zeros((n, total_max, br, bc), band.dtype)
    for s in range(n):
        for t in range(nsb):
            w, o = int(wl[s, t]), int(offs[s, t])
            flat[s, o:o + G * w] = (
                band[s, t * G:(t + 1) * G, :w].reshape(G * w, br, bc)
            )
    rows = np.stack([ragged_rows((offs[s], lvl_idx[s]), levels, G)
                     for s in range(n)])
    return levels, flat, rows


def _exchange_parts(op, x_local):
    """Start the neighbour ppermutes; return [left?, x_local, right?]
    WITHOUT concatenating, so callers can place compute between the
    collective launch and its first use.  Unpaired edge shards
    receive zeros (their band never reads that region)."""
    n = op.mesh.shape["nodes"]
    br = op.block_shape[0]  # halo extents are block-ROWS of x
    parts = []
    if op.halo_left:
        tail = x_local[-op.halo_left * br:]
        parts.append(
            jax.lax.ppermute(tail, "nodes",
                             [(i, i + 1) for i in range(n - 1)])
        )
    parts.append(x_local)
    if op.halo_right:
        head = x_local[: op.halo_right * br]
        parts.append(
            jax.lax.ppermute(head, "nodes",
                             [(i + 1, i) for i in range(n - 1)])
        )
    return parts


def _rows_pass(op, band, base, rows, x, x0, c, band_scale):
    """One banded pass over a run of block-rows (the kernel on the GPU,
    the same arithmetic as an XLA gather/einsum elsewhere)."""
    br, bc = op.block_shape
    out_rows = base.shape[0] * br
    if band_kernel(band.dtype):
        return banded_call(band, base, rows, x, x0, c, out_rows=out_rows,
                           max_width=op.max_width, band_scale=band_scale)
    d = jnp.arange(op.max_width)[None, :]
    valid = d < rows[1][:, None]
    idx = jnp.clip(rows[0][:, None] + d, 0, band.shape[0] - 1)
    blocks = jnp.where(valid[:, :, None, None], band[idx], 0)
    xb = x.reshape(-1, bc, x.shape[1])
    wins = jnp.take(xb, jnp.clip(base[:, None] + d, 0, xb.shape[0] - 1),
                    axis=0)                          # [rows, Wmax, bc, C]
    if band_scale is not None:
        acc = jnp.einsum("iwab,iwbc->iac", blocks, wins,
                         preferred_element_type=jnp.int32)
        return quant_emit(acc.reshape(out_rows, -1), band_scale, x0)
    y = jnp.einsum("iwab,iwbc->iac", blocks.astype(x.dtype), wins,
                   preferred_element_type=jnp.float32).reshape(out_rows, -1)
    if x0 is not None:
        y = 2.0 * y - x0
        if c is not None:
            y = y + c
    return y.astype(x.dtype)


def _shard_hop(op, band, base, rows, x_local, x0_local,
               band_scale: float | None, c_local=None):
    """One shard-local fused hop: neighbour exchange + banded pass.

    ``band``/``base``/``rows`` are the unwrapped per-shard slices; runs
    inside a ``shard_map`` region.  ``band_scale`` switches on the
    quantized path: int8 band x int8 activations, int32 window taps,
    dequant/requant at emission — the same integer arithmetic as
    ``QuantBandedLaplacian._call``, so the sharded chain is bit-exact
    with the single-chip one, and the halo ppermutes move int8 payloads
    (half the bytes of the bf16 training operator).  ``c_local`` adds
    the adjoint-chain injection (float path, with ``x0_local``).
    """
    br = op.block_shape[0]
    nbr_s = op.rows_per_shard // br

    def run(lo, hi, xarr, shift):
        sl = (lambda a: None if a is None else a[lo * br:hi * br])
        y = _rows_pass(op, band, base[lo:hi] - shift, rows[:, lo:hi], xarr,
                       sl(x0_local), sl(c_local), band_scale)
        return y.astype(x_local.dtype)

    parts = _exchange_parts(op, x_local)
    pre, suf = op.boundary_pre, op.boundary_suf
    interior = nbr_s - pre - suf
    if op.overlap and interior > 0 and (pre or suf):
        # Interior block-rows read only local columns: shift their window
        # bases out of the extended space and run them against x_local —
        # no dependence on the ppermute results, so the exchange hides
        # behind this pass.
        y_int = run(pre, pre + interior, x_local, op.halo_left)
        x_ext = (jnp.concatenate(parts, axis=0)
                 if len(parts) > 1 else x_local)
        ys = []
        if pre:
            ys.append(run(0, pre, x_ext, 0))
        ys.append(y_int)
        if suf:
            ys.append(run(nbr_s - suf, nbr_s, x_ext, 0))
        return jnp.concatenate(ys, axis=0)
    x_ext = jnp.concatenate(parts, axis=0) if len(parts) > 1 else x_local
    return run(0, nbr_s, x_ext, 0)


_OP_SPECS = (P("nodes"), P("nodes"), P("nodes"))


def _apply_sharded(op, x: jax.Array, x0: jax.Array | None,
                   band_scale: float | None = None) -> jax.Array:
    """One sharded hop as its own shard_map region (see _shard_hop)."""

    def local(band, base, rows, *xs):
        return _shard_hop(op, band[0], base[0], rows[0], xs[0],
                          xs[1] if len(xs) > 1 else None, band_scale)

    operands = (op.band, op.base, op.rows, x) + (
        (x0,) if x0 is not None else ()
    )
    in_specs = _OP_SPECS + (P("nodes", None),) + (
        (P("nodes", None),) if x0 is not None else ()
    )
    # Fully-manual shard_map, like parallel/sparse_halo.py: the
    # whole-graph node models carry no batch dimension here.
    return jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=in_specs,
        out_specs=P("nodes", None),
        axis_names=set(op.mesh.axis_names),
        check_vma=False,
    )(*operands)


def _chain_sharded(op, x: jax.Array, K: int,
                   band_scale: float | None = None) -> jax.Array:
    """The WHOLE K-term Chebyshev basis in ONE shard_map region.

    Per-hop operators pay one dispatch (plus GSPMD entry/exit
    resharding) per SpMM; running all K-1 hops (ppermutes included)
    inside a single region pays it once per CHAIN.  Returns the stacked
    basis ``[K, Mp, C]`` (sharded P(None, 'nodes', None)); bit-exact with
    the per-hop path (same per-shard arithmetic, same order)."""
    def local(band, base, rows, x_local):
        band, base, rows = band[0], base[0], rows[0]

        def hop(x1, x0):
            return _shard_hop(op, band, base, rows, x1, x0, band_scale)

        basis = [x_local]
        if K > 1:
            basis.append(hop(x_local, None))
        for _ in range(2, K):
            basis.append(hop(basis[-1], basis[-2]))
        return jnp.stack(basis)

    return jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=_OP_SPECS + (P("nodes", None),),
        out_specs=P(None, "nodes", None),
        axis_names=set(op.mesh.axis_names),
        check_vma=False,
    )(op.band, op.base, op.rows, x)


def _adjoint_chain_sharded(op, g: jax.Array) -> jax.Array:
    """Adjoint of the K-term basis chain in ONE shard_map region.

    Given cotangents ``g`` [K, Mp, C] of the stacked basis, the reverse
    of the three-term recurrence is itself a three-term recurrence run
    backward (L symmetric):

        s_{K-1} = g_{K-1}
        s_{K-2} = g_{K-2} + 2 L s_{K-1}
        s_k     = g_k + 2 L s_{k+1} - s_{k+2}        (K-3 >= k >= 1)
        dx = s_0 = g_0 + L s_1 - s_2

    Every ``2 L s - s_prev + g_k`` is one fused hop with the ``g_k``
    injection, so the adjoint costs one forward chain plus one plain
    SpMM — all inside a single dispatch."""
    K = g.shape[0]

    def local(band, base, rows, g_local):
        band, base, rows = band[0], base[0], rows[0]

        def hop_c(x1, x0, c):
            return _shard_hop(op, band, base, rows, x1, x0, None, c)

        def spmm(v):
            return _shard_hop(op, band, base, rows, v, None, None)

        if K == 1:
            return g_local[0]
        if K == 2:
            return g_local[0] + spmm(g_local[1])
        # s_{K-2} = 2 L s_{K-1} + g_{K-2} (hop against a zero x0).
        s_next = hop_c(g_local[K - 1], jnp.zeros_like(g_local[K - 1]),
                       g_local[K - 2])
        s_next2 = g_local[K - 1]
        for k in range(K - 3, 0, -1):
            s_next, s_next2 = hop_c(s_next, s_next2, g_local[k]), s_next
        return g_local[0] + spmm(s_next) - s_next2

    return jax.shard_map(
        local,
        mesh=op.mesh,
        in_specs=_OP_SPECS + (P(None, "nodes", None),),
        out_specs=P("nodes", None),
        axis_names=set(op.mesh.axis_names),
        check_vma=False,
    )(op.band, op.base, op.rows, g)


@jax.custom_vjp
def _banded_halo_matmul(op, x):
    return op._apply_impl(x, None)


def _bhm_fwd(op, x):
    return op._apply_impl(x, None), op


def _bhm_bwd(op, g):
    # Global L is symmetric -> dx = L @ g, which is this same sharded
    # operator applied to the (identically sharded) cotangent.
    return zero_cotangent(op), op._apply_impl(g, None)


_banded_halo_matmul.defvjp(_bhm_fwd, _bhm_bwd)


@jax.custom_vjp
def _banded_halo_hop(op, x1, x0):
    return op._apply_impl(x1, x0)


def _bhh_fwd(op, x1, x0):
    return op._apply_impl(x1, x0), op


def _bhh_bwd(op, g):
    dx1 = 2.0 * op._apply_impl(g, None)
    return zero_cotangent(op), dx1.astype(g.dtype), -g


_banded_halo_hop.defvjp(_bhh_fwd, _bhh_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _banded_halo_chain(op, x, K):
    return _chain_sharded(op, x, K)


def _bhc_fwd(op, x, K):
    # The recurrence is linear in x: the adjoint needs no forward values,
    # only the operator.
    return _chain_sharded(op, x, K), op


def _bhc_bwd(K, op, g):
    return zero_cotangent(op), _adjoint_chain_sharded(op, g)


_banded_halo_chain.defvjp(_bhc_fwd, _bhc_bwd)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=_FIELDS["data_fields"],
    meta_fields=_FIELDS["meta_fields"] + ["band_scale", "act_scale",
                                          "headroom"],
)
@dataclasses.dataclass(frozen=True)
class QuantBandedHaloLaplacian(QuantOpMixin):
    """Int8-quantized row-sharded banded Laplacian — sharded serving.

    Same exchange plan and band geometry as :class:`BandedHaloLaplacian`
    (two neighbour ``ppermute`` shifts per hop), but the band is int8,
    the recurrence carries ride int8 across devices (the halo payload is
    HALF the bf16 operator's bytes), and every shard runs the quantized
    banded pass (int32 taps, dequant/requant at emission).

    Implements the same ``quantize``/``dequantize``/``spmm_q``/
    ``cheby_hop_q`` protocol as ``QuantBandedLaplacian``, so
    ``ops.cheby_conv`` (and therefore NodeClassifier / ChebNet / the
    forecasting family) dispatches to the int8-resident recurrence with
    a runtime activation scale — sharded serving is the same one-call
    ``models.common.quantize_model_operators`` away as single-chip.
    Inference-only: no VJP (train in f32/bf16, quantize for serving).
    """

    band: jax.Array   # [n, T, br, bc] int8, sharded P('nodes')
    base: jax.Array   # [n, nbr_s] int32, extended-column window bases
    rows: jax.Array   # [n, 2, nbr_s] int32
    mesh: Mesh
    m: int
    m_padded: int
    nnz: int
    halo_left: int
    halo_right: int
    rows_per_shard: int
    block_shape: tuple
    rows_per_step: int
    max_width: int
    boundary_pre: int = 0
    boundary_suf: int = 0
    overlap: bool = False
    levels: tuple = ()
    band_scale: float = 1.0
    act_scale: float = 1.0
    headroom: float = 2.0

    @property
    def band_width(self):
        return self.max_width

    def spmm_q(self, x_q: jax.Array) -> jax.Array:
        """``quantize(L @ dequantize(x_q))``, one int8 pass per shard."""
        return _apply_sharded(self, x_q, None, band_scale=self.band_scale)

    def cheby_hop_q(self, x1_q: jax.Array, x0_q: jax.Array) -> jax.Array:
        """Quantized fused recurrence hop ``2 (L @ x1) - x0``."""
        return _apply_sharded(self, x1_q, x0_q, band_scale=self.band_scale)

    def cheby_chain_q(self, x_q: jax.Array, K: int) -> jax.Array:
        """Stacked int8 K-term basis, all hops in ONE shard_map region
        (int8 carries over the halo; one dispatch per chain).  Bit-exact
        with the per-hop quantized path."""
        return _chain_sharded(self, x_q, K, band_scale=self.band_scale)


def quantize_banded_halo(op: BandedHaloLaplacian, headroom: float = 2.0,
                         sample_x: float = 1.0) -> QuantBandedHaloLaplacian:
    """Quantize a sharded BandedHaloLaplacian for int8 serving.

    Same scale design as ``ops.laplacian.quantize_banded``: ONE global
    band scale ``max|L| / 127`` (a global reduce over the sharded band),
    ONE activation scale with ``headroom`` for the recurrence carries.
    The reduce and the cast run on the devices, and the quantized band
    keeps the P('nodes') sharding.
    """
    band_q, s_b = global_int8(op.band)
    fields = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)}
    fields["band"] = band_q
    return QuantBandedHaloLaplacian(
        **fields, band_scale=s_b,
        act_scale=float(sample_x) * headroom / 127.0, headroom=headroom,
    )


def banded_halo_laplacian(
    L: scipy.sparse.spmatrix,
    mesh: Mesh,
    lmax: float = 2.0,
    rescale: bool = True,
    dtype=jnp.float32,
    rows_per_step: int | None = None,
    max_band_width: int = 48,
    ragged: bool = True,
    force_boundary: int = 0,
) -> BandedHaloLaplacian:
    """Build the row-sharded banded operator over ``mesh``'s 'nodes' axis.

    Requires an RCM-bandable matrix whose halo fits within ONE neighbour
    shard on each side (true for planar/kNN city graphs once shards hold
    more block-rows than the band is wide); raises otherwise — fall back
    to ``sparse_halo_laplacian`` for scattered or tiny-shard cases.

    ``ragged`` (default on, like the single-chip packer) stores each
    G-row super-step at one of <= 4 width levels instead of the global
    max W, per shard; the row metadata rides as a sharded int32 operand
    so every shard runs one compiled program.
    """
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    L.eliminate_zeros()
    m = L.shape[0]
    nnz = int(L.nnz)
    n = mesh.shape["nodes"]
    br = bc = BLOCK

    stats = band_stats(L, (br, bc))
    base0, W, _, _ = stats
    if W > max_band_width:
        raise ValueError(
            f"band width {W} blocks exceeds {max_band_width}; "
            "RCM-reorder the graph or use sparse_halo_laplacian"
        )
    if rows_per_step is None:
        # Rows are padded to a multiple of n*G and padded rows inherit
        # the last REAL row's base — a G that is large next to the
        # per-shard row count can push a whole shard into padding whose
        # windows then look like giant left halos.  Cap G so padding
        # stays under half a shard.
        G = max(1, min(ROWS_PER_STEP, len(base0) // (2 * n)))
    else:
        G = rows_per_step

    # One packing path with the single-chip format: rows padded so every
    # shard holds the same whole number of super-steps.
    band, base, _, mp = pack_banded(
        L, (br, bc), max_band_width=max_band_width, rows_per_step=G,
        stats=stats, row_multiple=n * G, band_dtype=np.dtype(dtype),
    )
    nbr = mp // br
    nbr_s = nbr // n

    # Per-shard halo extents (uniform so every shard runs one program).
    starts = np.arange(n) * nbr_s
    ends = starts + nbr_s - 1
    h_l = int(np.max(starts - base[starts]))
    h_r = int(np.max(np.maximum(base[ends] + W - (ends + 1), 0)))
    if h_l > nbr_s or h_r > nbr_s:
        raise ValueError(
            f"halo ({h_l} left / {h_r} right block-rows) exceeds the "
            f"{nbr_s} block-rows per shard — too many shards for this "
            "band; use fewer shards or sparse_halo_laplacian"
        )

    # Window bases into each shard's extended column space.
    shard_of_row = np.repeat(np.arange(n), nbr_s)
    base_local = (base - shard_of_row * nbr_s + h_l).astype(np.int32)
    base_local = base_local.reshape(n, nbr_s)
    assert np.all(base_local >= 0)
    assert np.all(base_local + W <= nbr_s + h_l + h_r)

    band = band.reshape(n, nbr_s, W, br, bc)

    # Trailing padded rows (all-zero band) inherit the last real row's
    # base, which can sit below h_l in local coordinates and misclassify
    # them as halo-touching.  Their band is zero, so re-base them into
    # the local window space: monotone (>= previous row), >= h_l, and
    # window-in-range.  Results are unchanged (zero rows); only the
    # interior/boundary classification moves.
    nz = band.reshape(n, nbr_s, -1).any(axis=2).reshape(-1)
    last_real = int(np.max(np.nonzero(nz)[0])) if nz.any() else -1
    for gi in range(last_real + 1, n * nbr_s):
        s_i, i = divmod(gi, nbr_s)
        prev = base_local[s_i, i - 1] if i > 0 else h_l
        base_local[s_i, i] = np.clip(
            max(int(prev), h_l), 0, nbr_s + h_l + h_r - W
        )
    assert np.all(np.diff(base_local, axis=1) >= 0)

    # Interior/boundary split for exchange-compute overlap: the prefix
    # rows whose windows reach into the left halo (base < h_l) and the
    # suffix rows reaching the right halo (base + W > h_l + nbr_s),
    # rounded up to whole super-steps (G) and max'd across shards so
    # every shard runs the same three passes.  Interior rows read only
    # local columns, so their SpMM needs no ppermute result.
    pre = max(
        int(np.searchsorted(base_local[s], h_l, side="left"))
        for s in range(n)
    )
    suf = max(
        nbr_s - int(np.searchsorted(base_local[s], h_l + nbr_s - W,
                                    side="right"))
        for s in range(n)
    )
    pre = _round_up(pre, G)
    suf = _round_up(suf, G)
    if force_boundary:
        # Force a non-trivial prefix/interior/suffix split even when the
        # halos are empty (e.g. nodes=1), so the multi-pass path runs on
        # a single device.  Results are identical by construction
        # (per-row arithmetic does not depend on the split).
        pre = suf = max(pre, suf, _round_up(force_boundary, G))
    overlap = pre + suf < nbr_s and (pre > 0 or suf > 0)
    if not overlap:
        pre = suf = 0

    if ragged:
        levels, band, rows = _ragged_from_uniform(band, G)
        max_width = levels[-1]
    else:
        levels, max_width = (), W
        rows = np.broadcast_to(uniform_rows(nbr_s, W), (n, 2, nbr_s))
        band = band.reshape(n, nbr_s * W, br, bc)

    # Pre-shard the per-shard fields over 'nodes': otherwise the FULL
    # global band lands on one device and every call pays a reshard.
    shard = NamedSharding(mesh, P("nodes"))
    return BandedHaloLaplacian(
        band=jax.device_put(jnp.asarray(band, dtype=dtype), shard),
        base=jax.device_put(jnp.asarray(base_local), shard),
        rows=jax.device_put(jnp.asarray(np.ascontiguousarray(rows)), shard),
        mesh=mesh,
        m=m,
        m_padded=mp,
        nnz=nnz,
        halo_left=h_l,
        halo_right=h_r,
        rows_per_shard=nbr_s * br,
        block_shape=(br, bc),
        rows_per_step=G,
        max_width=int(max_width),
        boundary_pre=pre,
        boundary_suf=suf,
        overlap=overlap,
        levels=levels,
    )
