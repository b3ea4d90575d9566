"""Device-resident graph Laplacian operators.

The reference keeps the rescaled Laplacian as a ``tf.SparseTensor`` and
multiplies it with ``tf.sparse_tensor_dense_matmul`` inside the Chebyshev
recurrence (lib/filter.py:81,85; lib/graph_conv.py:163-169).  Here the
Laplacian ships in one of four formats chosen by graph shape:

* ``dense``  — zero-padded dense ``[Mp, Mp]`` matrix; the recurrence is
  plain matmuls.  Small graphs, and scattered graphs whose 128-blocks
  are mostly occupied.
* ``banded`` — RCM-ordered kNN/planar graphs are block-BANDED: each
  block-row touches a short, monotonically advancing window of column
  blocks.  Stored as a dense band of ``128 x 128`` blocks; on the GPU
  the hop runs the Triton kernel of ``ops/pallas_band.py``, elsewhere
  XLA window einsums.
* ``bsr``    — block-sparse rows: dense ``128 x 128`` tiles at nonzero
  positions, block rows grouped by tile count (``pack_bsr_groups``),
  each group contracted by a window gather and one batched matmul.
  Scattered graphs above the dense budget.
* ``bcoo``   — ``jax.experimental.sparse`` fallback.

All operators are pytrees, so they pass through ``jax.jit`` /
``shard_map`` like any other array bundle.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse

from cnn_graph_tpu.graphs.construction import rescale_laplacian
from cnn_graph_tpu.ops.backend import band_kernel

__all__ = [
    "zero_cotangent",
    "ChebyHopMixin",
    "QuantOpMixin",
    "DenseLaplacian",
    "BlockSparseLaplacian",
    "BandedLaplacian",
    "QuantBandedLaplacian",
    "QuantDenseLaplacian",
    "QuantBlockSparseLaplacian",
    "quantize_banded",
    "quantize_dense",
    "quantize_block_sparse",
    "cheby_finals",
    "BCOOLaplacian",
    "device_laplacian",
    "pack_block_sparse",
    "pack_banded",
    "pack_banded_ragged",
    "choose_band_levels",
]

BLOCK = 128  # tile edge of the banded and block-sparse formats
ROWS_PER_STEP = 8  # block-rows per super-step of the ragged band layout


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def zero_cotangent(tree):
    """Structure-matching zero cotangents for an operator pytree (float0
    for integer leaves) — used by the custom VJPs that take operators as
    differentiable-but-constant arguments."""

    def zero(a):
        if jnp.issubdtype(a.dtype, jnp.inexact):
            return jnp.zeros_like(a)
        return np.zeros(a.shape, jax.dtypes.float0)

    return jax.tree.map(zero, tree)


class ChebyHopMixin:
    """Default Chebyshev recurrence hop ``2 (L @ x1) - x0``; formats with
    a fused kernel override it (BandedLaplacian).  Shared by the sharded
    operators in cnn_graph_tpu/parallel as well."""

    def cheby_hop(self, x1: jax.Array, x0: jax.Array, *,
                  donate: bool = False) -> jax.Array:
        # ``donate`` is accepted (and ignored) everywhere so chain
        # drivers can request in-place hops uniformly; only the banded
        # kernel acts on it.
        del donate
        return (2.0 * self.matmul(x1) - x0).astype(x1.dtype)


class QuantOpMixin:
    """Shared int8 serving protocol for the quantized operators — one
    copy of quantize/dequantize/float-view matmul for the single-chip
    ``QuantBandedLaplacian`` and every sharded twin
    (``QuantBandedHaloLaplacian``, ``QuantSparseHaloLaplacian``,
    ``QuantBandedSparseHaloLaplacian``).  Subclasses carry ``act_scale``
    and implement ``spmm_q``/``cheby_hop_q``; ``ops.cheby_conv``
    dispatches on the ``cheby_hop_q`` attribute.  Inference-only: no
    VJP (train in f32/bf16, quantize for serving)."""

    @property
    def compute_dtype(self):
        return jnp.int8

    def quantize(self, x: jax.Array, scale=None) -> jax.Array:
        s = self.act_scale if scale is None else scale
        return jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8)

    def dequantize(self, q: jax.Array, dtype=jnp.float32,
                   scale=None) -> jax.Array:
        s = self.act_scale if scale is None else scale
        return (q.astype(jnp.float32) * s).astype(dtype)

    def matmul(self, x: jax.Array) -> jax.Array:
        """Float view for drop-in parity checks: quantize -> int8 SpMM ->
        dequant (one extra quantization of x vs the resident-int8 chain)."""
        return self.dequantize(self.spmm_q(self.quantize(x)), x.dtype)


def quant_emit(acc: jax.Array, scale: float,
               x0_q: jax.Array | None) -> jax.Array:
    """Int8 emission shared by every quantized XLA path: dequantise the
    int32 accumulator, apply the hop update in input-scale units, round
    half to even and saturate.  The banded kernel's epilogue computes the
    same float32 operations in the same order (bit-identical)."""
    y = scale * acc.astype(jnp.float32)
    if x0_q is not None:
        y = 2.0 * y - x0_q.astype(jnp.float32)
    return jnp.clip(jnp.round(y), -127.0, 127.0).astype(jnp.int8)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["mat"],
    meta_fields=["m", "m_padded", "nnz"],
)
@dataclasses.dataclass(frozen=True)
class DenseLaplacian(ChebyHopMixin):
    """Rescaled Laplacian as a zero-padded dense matrix.

    A bfloat16 matrix (``device_laplacian(dtype=jnp.bfloat16)``) runs the
    recurrence in bf16 with float32 accumulation; the Chebyshev carry
    then also runs in bf16 (values are bounded by the [-1, 1] spectral
    rescale, so the recurrence is well-conditioned).
    """

    mat: jax.Array  # [Mp, Mp]
    m: int
    m_padded: int
    nnz: int

    @property
    def compute_dtype(self):
        return self.mat.dtype

    def matmul(self, x: jax.Array) -> jax.Array:
        """``L @ x`` for ``x`` of shape ``[Mp, C]``."""
        return jnp.dot(self.mat, x, preferred_element_type=x.dtype)


def bsr_windows(blocks, block_cols, row_pos, groups, block_shape, x,
                acc_dtype):
    """``L @ x`` on the grouped block-sparse-row layout
    (``pack_bsr_groups``), accumulated in ``acc_dtype``: per group,
    gather each row's x tiles and contract them in one batched matmul
    (batch = the group's rows, contraction = its level's tiles); then
    put the rows back in block-row order.

    A flat formulation (one matmul per stored tile, then a segment-sum
    over block-rows) took over 90 s to compile on an H100 at 2,578 tiles
    (PERF.md); a static loop over a few groups compiles like the banded
    path."""
    br, bc = block_shape
    C = x.shape[1]
    xb = x.reshape(-1, bc, C)
    outs, off = [], 0
    for rows, k in groups:
        blk = blocks[off: off + rows * k].reshape(rows, k, br, bc)
        cols = block_cols[off: off + rows * k].reshape(rows, k)
        wins = jnp.take(xb, cols, axis=0)  # [rows, k, bc, C]
        outs.append(jnp.einsum("rkij,rkjc->ric", blk, wins,
                               preferred_element_type=acc_dtype))
        off += rows * k
    y = jnp.take(jnp.concatenate(outs), row_pos, axis=0)
    return y.reshape(-1, C)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks", "block_cols", "row_pos"],
    meta_fields=["m", "m_padded", "nnz", "block_shape", "groups",
                 "n_tiles"],
)
@dataclasses.dataclass(frozen=True)
class BlockSparseLaplacian(ChebyHopMixin):
    """Rescaled Laplacian as dense tiles at nonzero block positions.

    Block rows are grouped by tile count (``pack_bsr_groups``): group
    ``(rows, k)`` owns the next ``rows * k`` entries of the flat
    ``blocks``/``block_cols``, each of its rows padded to ``k`` tiles
    with zero tiles at column 0.  ``row_pos[i]`` is block-row ``i``'s
    row in the groups' outputs.  ``n_tiles`` counts the nonzero tiles;
    ``blocks`` holds fewer than 1.5x as many.
    """

    blocks: jax.Array  # [T, br, bc]
    block_cols: jax.Array  # [T] int32
    row_pos: jax.Array  # [n_rb] int32
    m: int
    m_padded: int
    nnz: int
    block_shape: tuple
    groups: tuple  # ((rows, tiles per row), ...), descending tiles
    n_tiles: int

    @property
    def block_size(self):  # square-block compatibility accessor
        return self.block_shape[0]

    @property
    def compute_dtype(self):
        return self.blocks.dtype

    def matmul(self, x: jax.Array) -> jax.Array:
        """``L @ x`` for ``x`` of shape ``[Mp, C]``."""
        return bsr_windows(self.blocks, self.block_cols, self.row_pos,
                           self.groups, self.block_shape, x,
                           x.dtype).astype(x.dtype)


def band_windows(band, base, sched, levels, G, block_shape, x, acc_dtype):
    """XLA path for the banded layouts, accumulated in ``acc_dtype`` —
    the CPU path, the float32 path and the kernel's plain reference.

    Uniform band ``[nbr, W, br, bc]``: one window gather and one einsum.
    Ragged flat band: a static Python loop over super-steps, each an
    einsum over that step's ``[G, W_s, br, bc]`` slab (``sched`` and
    ``levels`` are static metadata)."""
    br, bc = block_shape
    n_cb = x.shape[0] // bc
    xb = x.reshape(n_cb, bc, -1)
    if not levels:
        W = band.shape[1]
        wins = jnp.take(xb, base[:, None] + jnp.arange(W)[None, :], axis=0)
        y = jnp.einsum("iwab,iwbc->iac", band, wins,
                       preferred_element_type=acc_dtype)
        return y.reshape(x.shape)
    offs, lvl_idx = sched
    outs = []
    for s in range(len(offs)):
        w = levels[lvl_idx[s]]
        blk = band[offs[s]: offs[s] + G * w].reshape(G, w, br, bc)
        cols = base[s * G:(s + 1) * G][:, None] + jnp.arange(w)[None, :]
        # Clamp: a level wider than a row's true span can peek past the
        # last column block; the band there is zero, so the clamped
        # window contributes nothing.
        wins = jnp.take(xb, jnp.minimum(cols, n_cb - 1), axis=0)
        y = jnp.einsum("gwab,gwbc->gac", blk, wins,
                       preferred_element_type=acc_dtype)
        outs.append(y.reshape(G * br, -1))
    return jnp.concatenate(outs, axis=0)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["band", "base", "rows"],
    meta_fields=["m", "m_padded", "nnz", "block_shape", "rows_per_step",
                 "sched", "levels"],
)
@dataclasses.dataclass(frozen=True)
class BandedLaplacian(ChebyHopMixin):
    """Rescaled Laplacian as a block-BANDED dense band.

    UNIFORM layout (``levels`` empty): ``band[i, d]`` is the dense
    ``br x bc`` block at block coordinates ``(i, base[i] + d)``; blocks
    outside the true sparsity are zero.  ``base`` is monotone
    non-decreasing (pack_banded enforces it by suffix-min).

    RAGGED layout (``levels`` non-empty, built by ``pack_banded_ragged``):
    the band is stored FLAT ``[total_blocks, br, bc]`` and each
    ``rows_per_step``-row super-step carries its own width W_s from the
    static ``levels`` palette, cutting the blocks the uniform max width
    pads in.  ``sched = (offsets, level_indices)`` is static metadata so
    the XLA path can trace it.

    ``rows`` ``[2, nbr]`` int32 is each block-row's (offset into the
    flat band, width) — what the GPU kernel walks; both layouts have it.
    """

    band: jax.Array  # [nbr, W, br, bc], or [total, br, bc] when ragged
    base: jax.Array  # [nbr] int32, monotone non-decreasing
    rows: jax.Array  # [2, nbr] int32: (flat offset, width) per block-row
    m: int
    m_padded: int
    nnz: int
    block_shape: tuple
    rows_per_step: int  # block-rows per ragged super-step (G)
    sched: tuple = ()   # ragged: ((offset...), (level index...))
    levels: tuple = ()  # ragged: ascending distinct super-step widths

    @property
    def band_width(self):
        return self.levels[-1] if self.levels else self.band.shape[1]

    @property
    def compute_dtype(self):
        return self.band.dtype

    def cheby_hop(self, x1: jax.Array, x0: jax.Array, *,
                  donate: bool = False) -> jax.Array:
        if band_kernel(self.band.dtype):
            from cnn_graph_tpu.ops.pallas_band import band_cheby_hop

            return band_cheby_hop(self, x1, x0, donate)
        return super().cheby_hop(x1, x0)

    def cheby_hop_c(self, x1: jax.Array, x0: jax.Array,
                    c: jax.Array) -> jax.Array:
        """Adjoint-chain hop ``2 (L @ x1) - x0 + c`` (one kernel pass on
        the GPU); used inside ``filters.cheby_conv_banded``'s backward."""
        if band_kernel(self.band.dtype):
            from cnn_graph_tpu.ops.pallas_band import band_cheby_hop_c

            return band_cheby_hop_c(self, x1, x0, c)
        return (2.0 * self.matmul(x1) - x0 + c).astype(x1.dtype)

    def matmul(self, x: jax.Array) -> jax.Array:
        """``L @ x`` for ``x`` of shape ``[Mp, C]``."""
        if band_kernel(self.band.dtype):
            from cnn_graph_tpu.ops.pallas_band import band_spmm

            return band_spmm(self, x)
        # float32 accumulation matches the kernel's accumulator, so this
        # path is a valid oracle for bf16 operands.
        return band_windows(
            self.band, self.base, self.sched, self.levels,
            self.rows_per_step, self.block_shape, x, jnp.float32,
        ).astype(x.dtype)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["bcoo"],
    meta_fields=["m", "m_padded", "nnz"],
)
@dataclasses.dataclass(frozen=True)
class BCOOLaplacian(ChebyHopMixin):
    """``jax.experimental.sparse`` BCOO fallback (CPU tests, odd shapes)."""

    bcoo: Any
    m: int
    m_padded: int
    nnz: int

    @property
    def compute_dtype(self):
        return self.bcoo.data.dtype

    def matmul(self, x: jax.Array) -> jax.Array:
        return self.bcoo @ x


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["band", "base", "rows"],
    meta_fields=["m", "m_padded", "nnz", "block_shape", "rows_per_step",
                 "band_scale", "act_scale", "headroom", "sched", "levels"],
)
@dataclasses.dataclass(frozen=True)
class QuantBandedLaplacian(QuantOpMixin):
    """Int8-quantized banded Laplacian — the INFERENCE/serving path.

    The band is symmetric-quantized with ONE global scale
    ``band_scale = max|L| / 127`` (the spectral rescale bounds entries
    uniformly); activations ride ONE scale ``s_x`` across the whole
    Chebyshev recurrence, valid because |T_k(lambda)| <= 1 on the
    rescaled spectrum keeps the carries near the input's range (the
    ``headroom`` factor absorbs the rest).  ``s_x`` never enters the
    kernel — the emission epilogue is ``y/s_x = band_scale * acc`` in
    input-scale units — so callers may pass a TRACED per-call scale
    (``ops.filters.cheby_basis`` computes ``max|x|`` at runtime; no
    calibration pass needed).  Taps accumulate in pure int32, with no
    per-tap float rescaling.

    Inference-only: no VJP (train in bf16/f32, quantize for serving).
    The recurrence runs on int8 carries via ``cheby_hop_q``; ``matmul``
    offers a float-in/float-out view for drop-in parity checks, and the
    ``cheby_hop_q``/``spmm_q`` protocol plugs into ``ops.cheby_conv``
    (and therefore ChebNet / NodeClassifier inference) directly.
    """

    band: jax.Array   # int8, layout as BandedLaplacian
    base: jax.Array   # [nbr] int32, monotone
    rows: jax.Array   # [2, nbr] int32
    m: int
    m_padded: int
    nnz: int
    block_shape: tuple
    rows_per_step: int
    band_scale: float  # dequant scale of the band
    act_scale: float   # default activation scale (quantize/dequantize)
    headroom: float = 2.0  # saturation margin for recurrence carries
    sched: tuple = ()   # ragged schedule (see BandedLaplacian)
    levels: tuple = ()

    @property
    def band_width(self):
        return self.levels[-1] if self.levels else self.band.shape[1]

    def _call(self, x_q: jax.Array, x0_q: jax.Array | None,
              donate: bool = False) -> jax.Array:
        if band_kernel(self.band.dtype):
            from cnn_graph_tpu.ops.pallas_band import banded_call

            return banded_call(
                self.band.reshape(-1, *self.block_shape), self.base,
                self.rows, x_q, x0_q, out_rows=self.m_padded,
                max_width=self.band_width, band_scale=self.band_scale,
                donate_x0=donate,
            )
        acc = band_windows(
            self.band, self.base, self.sched, self.levels,
            self.rows_per_step, self.block_shape, x_q, jnp.int32,
        )
        return quant_emit(acc, self.band_scale, x0_q)

    def spmm_q(self, x_q: jax.Array) -> jax.Array:
        """``quantize(L @ dequantize(x_q))`` in one int8 pass."""
        return self._call(x_q, None)

    def cheby_hop_q(self, x1_q: jax.Array, x0_q: jax.Array, *,
                    donate: bool = False) -> jax.Array:
        """Quantized fused recurrence hop ``2 (L @ x1) - x0``.

        ``donate`` writes the result in place over ``x0``'s buffer
        (kernel-level ``input_output_aliases``) — chain drivers use it
        so while-loop carries stay in fixed buffers (see
        ``cheby_finals``)."""
        return self._call(x1_q, x0_q, donate=donate)


def cheby_finals(L, x: jax.Array, K: int) -> jax.Array:
    """Run the K-1-product Chebyshev recurrence and return ``T_{K-1} x``.

    The chain driver behind the throughput benchmarks and any
    power-iteration-style use that needs only the final carry.  Two hops
    per loop iteration with DONATED (in-place) kernel outputs, so each
    while-loop carry stays in a fixed buffer:

        body(p, q):  r = hop(q, p)   # writes into p's buffer
                     s = hop(r, q)   # writes into q's buffer
                     return (r, s)   # same buffer slots as (p, q)

    A naive ``return q, hop(q, p)`` body permutes the carry buffers, and
    XLA's while-loop lowering restores the fixed-slot invariant with a
    full-activation copy per carry per hop.

    Dispatches on the operator protocol: quantized operators
    (``cheby_hop_q``) take/return int8 carries (pass ``x`` already
    quantized); everything else runs in the operator's compute dtype.
    """
    quant = hasattr(L, "cheby_hop_q")
    f = L.cheby_hop_q if quant else L.cheby_hop
    try:
        import inspect

        donate_ok = "donate" in inspect.signature(f).parameters
    except (TypeError, ValueError):  # pragma: no cover - builtins only
        donate_ok = False
    hop = (lambda a, b: f(a, b, donate=True)) if donate_ok else f

    if K <= 1:
        return x
    p, q = x, (L.spmm_q(x) if quant else L.matmul(x))
    n = K - 2  # hops remaining after the first product

    def body(_, carry):
        pp, qq = carry
        r = hop(qq, pp)
        s = hop(r, qq)
        return r, s

    p, q = jax.lax.fori_loop(0, n // 2, body, (p, q))
    if n % 2:
        q = hop(q, p)
    return q


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["mat"],
    meta_fields=["m", "m_padded", "nnz", "mat_scale", "act_scale",
                 "headroom"],
)
@dataclasses.dataclass(frozen=True)
class QuantDenseLaplacian(QuantOpMixin):
    """Int8-quantized DENSE Laplacian — serving twin of DenseLaplacian.

    The reference's flagship classification topology (the 20NEWS
    embedding-kNN graph, /root/reference/lib/utils.py:127-150 +
    nips2016/20news.ipynb cell 22) is ~54%% block-dense after RCM, so
    ``fmt="auto"`` serves it as a DENSE operator — this twin gives that
    path int8 serving: the matrix is symmetric-quantized with one global
    scale ``max|L|/127``, the recurrence runs int8 @ int8 -> int32 (half
    the bf16 bytes), and the dequant/requant emission works in
    input-scale units exactly like ``QuantBandedLaplacian`` — so the
    activation scale is a TRACED runtime value and the whole
    ``cheby_hop_q``/``spmm_q`` protocol (``ops.cheby_conv`` streaming
    dispatch, ``cheby_finals`` chains, ``quantize_model_operators``)
    applies unchanged.  Inference-only: no VJP.
    """

    mat: jax.Array   # [Mp, Mp] int8
    m: int
    m_padded: int
    nnz: int
    mat_scale: float  # dequant scale of the matrix
    act_scale: float  # default activation scale (quantize/dequantize)
    headroom: float = 2.0

    def _call(self, x_q: jax.Array, x0_q: jax.Array | None) -> jax.Array:
        acc = jnp.dot(self.mat, x_q, preferred_element_type=jnp.int32)
        return quant_emit(acc, self.mat_scale, x0_q)

    def spmm_q(self, x_q: jax.Array) -> jax.Array:
        return self._call(x_q, None)

    def cheby_hop_q(self, x1_q: jax.Array, x0_q: jax.Array, *,
                    donate: bool = False) -> jax.Array:
        del donate  # XLA manages buffers for the plain matmul path
        return self._call(x1_q, x0_q)


def global_int8(a: jax.Array):
    """Symmetric int8 quantization with one global scale ``max|a|/127``,
    computed on the device (the array keeps its sharding).  Returns
    ``(a_int8, scale)``."""
    s = float(jax.jit(
        lambda b: jnp.max(jnp.abs(b.astype(jnp.float32))))(a)) / 127.0
    if s == 0.0:
        s = 1.0
    q = jax.jit(lambda b: jnp.clip(
        jnp.round(b.astype(jnp.float32) / s), -127, 127).astype(jnp.int8))(a)
    return q, s


def quantize_dense(op: DenseLaplacian, headroom: float = 2.0,
                   sample_x: float = 1.0) -> QuantDenseLaplacian:
    """Quantize a DenseLaplacian for int8 inference (scale semantics
    identical to :func:`quantize_banded`)."""
    mat_q, s = global_int8(op.mat)
    return QuantDenseLaplacian(
        mat=mat_q, m=op.m, m_padded=op.m_padded, nnz=op.nnz,
        mat_scale=s, act_scale=float(sample_x) * headroom / 127.0,
        headroom=headroom,
    )


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks", "block_cols", "row_pos"],
    meta_fields=["m", "m_padded", "nnz", "block_shape", "groups",
                 "n_tiles", "block_scale", "act_scale", "headroom"],
)
@dataclasses.dataclass(frozen=True)
class QuantBlockSparseLaplacian(QuantOpMixin):
    """Int8-quantized BSR Laplacian — serving twin of
    BlockSparseLaplacian for scattered graphs ABOVE the dense budget
    (RCV1-scale embedding-kNN graphs, /root/reference/lib/utils.py:
    162-218).  Same one-global-scale / input-scale-units emission as
    the banded and dense twins; int8 tile taps accumulate in int32.
    Inference-only."""

    blocks: jax.Array       # [T, br, bc] int8
    block_cols: jax.Array   # [T] int32
    row_pos: jax.Array      # [n_rb] int32
    m: int
    m_padded: int
    nnz: int
    block_shape: tuple
    groups: tuple
    n_tiles: int
    block_scale: float
    act_scale: float
    headroom: float = 2.0

    @property
    def block_size(self):
        return self.block_shape[0]

    def _call(self, x_q: jax.Array, x0_q: jax.Array | None) -> jax.Array:
        acc = bsr_windows(self.blocks, self.block_cols, self.row_pos,
                          self.groups, self.block_shape, x_q, jnp.int32)
        return quant_emit(acc, self.block_scale, x0_q)

    def spmm_q(self, x_q: jax.Array) -> jax.Array:
        return self._call(x_q, None)

    def cheby_hop_q(self, x1_q: jax.Array, x0_q: jax.Array, *,
                    donate: bool = False) -> jax.Array:
        del donate
        return self._call(x1_q, x0_q)


def quantize_block_sparse(op: BlockSparseLaplacian, headroom: float = 2.0,
                          sample_x: float = 1.0) -> QuantBlockSparseLaplacian:
    """Quantize a BlockSparseLaplacian for int8 inference."""
    blocks_q, s = global_int8(op.blocks)
    return QuantBlockSparseLaplacian(
        blocks=blocks_q,
        block_cols=op.block_cols,
        row_pos=op.row_pos,
        m=op.m,
        m_padded=op.m_padded,
        nnz=op.nnz,
        block_shape=op.block_shape,
        groups=op.groups,
        n_tiles=op.n_tiles,
        block_scale=s,
        act_scale=float(sample_x) * headroom / 127.0,
        headroom=headroom,
    )


def quantize_banded(op: BandedLaplacian, headroom: float = 2.0,
                    sample_x: float = 1.0) -> QuantBandedLaplacian:
    """Quantize a BandedLaplacian for int8 inference.

    ``headroom`` multiplies the activation scale so recurrence carries
    that wander above the input range saturate gracefully instead of
    wrapping; |T_k| <= 1 on the rescaled spectrum bounds the growth, so
    2x covers practical chains (validated in tests against the f32
    chain).  ``sample_x`` is the expected activation max (callers pass
    ``float(jnp.max(jnp.abs(x)))`` of a representative batch).
    """
    band_q, s_b = global_int8(op.band)
    return QuantBandedLaplacian(
        band=band_q,
        base=op.base,
        rows=op.rows,
        m=op.m,
        m_padded=op.m_padded,
        nnz=op.nnz,
        block_shape=op.block_shape,
        rows_per_step=op.rows_per_step,
        band_scale=s_b,
        act_scale=float(sample_x) * headroom / 127.0,
        headroom=headroom,
        sched=op.sched,
        levels=op.levels,
    )


LaplacianOperator = (
    DenseLaplacian | BlockSparseLaplacian | BandedLaplacian
    | QuantBandedLaplacian | QuantDenseLaplacian
    | QuantBlockSparseLaplacian | BCOOLaplacian
)


def band_stats(L: scipy.sparse.spmatrix,
               block_shape: tuple = (BLOCK, BLOCK)):
    """Band geometry of the block-tiled matrix: per-block-row monotone
    window bases (suffix-min of the first nonzero block column), the band
    width W covering every row's span, and the number of occupied blocks
    (for the banded-vs-BSR choice).
    """
    br, bc = block_shape
    m = L.shape[0]
    mp = _round_up(m, int(np.lcm(br, bc)))
    n_rb = mp // br
    n_cb = mp // bc
    coo = L.tocoo()
    brow = coo.row // br
    bcol = coo.col // bc
    n_blocks = len(np.unique(brow.astype(np.int64) * n_cb + bcol))

    lo = np.full(n_rb, n_cb, np.int64)  # empty rows pass through suffix-min
    hi = np.full(n_rb, -1, np.int64)
    np.minimum.at(lo, brow, bcol)
    np.maximum.at(hi, brow, bcol)

    base = np.minimum.accumulate(lo[::-1])[::-1]  # suffix min: monotone, <= lo
    W = min(int(max((hi - base).max() + 1, 1)), n_cb)
    base = np.clip(base, 0, n_cb - W).astype(np.int32)
    assert np.all(base >= 0) and np.all(base[brow] <= bcol)
    assert np.all(bcol < base[brow] + W)
    return base, W, n_blocks, mp


def _check_width(W: int, max_band_width: int):
    if W > max_band_width:
        raise ValueError(
            f"band width {W} blocks exceeds {max_band_width}; "
            "RCM-reorder the graph or use fmt='bsr'"
        )


def pack_banded(L: scipy.sparse.spmatrix,
                block_shape: tuple = (BLOCK, BLOCK),
                max_band_width: int = 48,
                rows_per_step: int | None = None,
                stats: tuple | None = None,
                row_multiple: int | None = None,
                band_dtype=np.float32):
    """Pack a block-banded sparse matrix into a dense band
    ``[n_row_blocks, W, br, bc]`` with monotone window bases.

    The row count is padded to a multiple of ``rows_per_step`` (G; zero
    band rows, base held at its last value).  Returns ``(band, base, G,
    m_padded)``.  Raises ``ValueError`` when the band would exceed
    ``max_band_width`` blocks (a scattered ordering — use BSR, or
    RCM-reorder first).
    """
    br, bc = block_shape
    base, W, _, mp = stats if stats is not None else band_stats(
        L, block_shape
    )
    _check_width(W, max_band_width)
    G = rows_per_step or min(ROWS_PER_STEP, len(base))
    # Pad rows so the row count is whole super-steps (and keep bc | mp
    # for the column reshape).  Padded band rows are zero; base holds its
    # last value, keeping monotonicity and column bounds.
    # ``row_multiple`` overrides the row rounding (the sharded
    # banded-halo packer needs n_shards * G block-rows per multiple).
    mp = _round_up(mp, int(np.lcm((row_multiple or G) * br, bc)))
    n_rb = mp // br
    base = np.concatenate(
        [base, np.full(n_rb - len(base), base[-1], np.int32)]
    )
    # Allocate the host staging band directly in the target dtype: a
    # float32 buffer at 1M-node scale (~8k block-rows, W~11) is ~6GB of
    # host RAM before the device cast; bf16/int8 staging halves/quarters
    # that.  jax's ml_dtypes supplies the NumPy bfloat16.
    band = np.zeros((n_rb, W, br, bc), np.dtype(band_dtype))
    coo = L.tocoo()
    brow = coo.row // br
    band[brow, coo.col // bc - base[brow], coo.row % br, coo.col % bc] = (
        coo.data.astype(band.dtype)
    )
    return band, base, G, mp


def choose_band_levels(ws, max_levels: int = 4) -> tuple:
    """Pick <= ``max_levels`` width levels (always including the max)
    minimizing total padded band blocks when every super-step width in
    ``ws`` is rounded UP to its level.  Exhaustive over the distinct
    widths (band widths are <= max_band_width, so this is tiny)."""
    uniq, cnt = np.unique(np.asarray(ws, np.int64), return_counts=True)
    if len(uniq) <= max_levels:
        return tuple(int(u) for u in uniq)
    best = None
    for combo in itertools.combinations(range(len(uniq) - 1),
                                        max_levels - 1):
        lv = np.concatenate([uniq[list(combo)], uniq[-1:]])
        cost = int((cnt * lv[np.searchsorted(lv, uniq)]).sum())
        if best is None or cost < best[0]:
            best = (cost, lv)
    return tuple(int(v) for v in best[1])


def pack_banded_ragged(L: scipy.sparse.spmatrix,
                       block_shape: tuple = (BLOCK, BLOCK),
                       max_band_width: int = 48,
                       rows_per_step: int | None = None,
                       stats: tuple | None = None,
                       max_levels: int = 4,
                       band_dtype=np.float32):
    """Pack a block-banded sparse matrix with PER-SUPER-STEP widths.

    Like ``pack_banded``, but each G-block-row super-step stores only
    ``W_s = max span within the step`` diagonal blocks (rounded up to
    one of <= ``max_levels`` static width levels), laid out flat — the
    blocks the uniform max-width layout pads in are not stored.

    Returns ``(band_flat, base, sched, levels, G, m_padded)`` where
    ``sched`` is the static schedule ``(offsets, level_indices)`` as
    tuples and ``band_flat`` is ``[sum_s G*W_s, br, bc]``.
    """
    br, bc = block_shape
    base, W, _, mp = stats if stats is not None else band_stats(
        L, block_shape
    )
    _check_width(W, max_band_width)
    G = rows_per_step or min(ROWS_PER_STEP, len(base))
    mp = _round_up(mp, int(np.lcm(G * br, bc)))
    n_rb = mp // br
    base = np.concatenate(
        [base, np.full(n_rb - len(base), base[-1], np.int32)]
    )
    nsb = n_rb // G

    coo = L.tocoo()
    brow = coo.row // br
    hi = np.full(n_rb, -1, np.int64)
    np.maximum.at(hi, brow, coo.col // bc)
    span = np.maximum(hi - base.astype(np.int64) + 1, 1)
    ws = span.reshape(nsb, G).max(axis=1)
    levels = choose_band_levels(ws, max_levels)
    lvl_idx = np.searchsorted(np.asarray(levels), ws).astype(np.int64)
    wl = np.asarray(levels, np.int64)[lvl_idx]
    offs = np.zeros(nsb, np.int64)
    offs[1:] = np.cumsum(G * wl)[:-1]
    total = int((G * wl).sum())

    band = np.zeros((total, br, bc), np.dtype(band_dtype))
    s_of_row = brow // G
    pos = (offs[s_of_row] + (brow % G) * wl[s_of_row]
           + (coo.col // bc - base[brow]))
    band[pos, coo.row % br, coo.col % bc] = coo.data.astype(band.dtype)

    sched = (tuple(int(v) for v in offs), tuple(int(v) for v in lvl_idx))
    return band, base, sched, levels, G, mp


def pack_block_sparse(L: scipy.sparse.spmatrix,
                      block_shape: tuple = (BLOCK, BLOCK)):
    """Tile a sparse matrix into dense ``br x bc`` blocks, keeping nonzero
    tiles only.

    Returns ``(blocks, block_rows, block_cols, block_rowptr, m_padded)``
    as NumPy arrays, blocks sorted by (row, col).  Square inputs pad both
    dims to lcm(br, bc) (so ``m_padded`` stays a single int for the
    square operators); rectangular inputs (e.g. the per-shard extended
    matrices of parallel/sparse_halo.py) pad each dim independently and
    ``m_padded`` is the padded ROW count.
    """
    br_sz, bc_sz = block_shape
    rows, cols = L.shape
    if rows == cols:
        mp = _round_up(rows, int(np.lcm(br_sz, bc_sz)))
        mp_r = mp_c = mp
    else:
        mp_r = _round_up(rows, br_sz)
        mp_c = _round_up(cols, bc_sz)
    n_rb = mp_r // br_sz
    n_cb = mp_c // bc_sz
    coo = L.tocoo()
    br = coo.row // br_sz
    bc = coo.col // bc_sz
    block_ids = br.astype(np.int64) * n_cb + bc
    unique_ids = np.unique(block_ids)

    blocks = np.zeros((len(unique_ids), br_sz, bc_sz), dtype=np.float32)
    slot = np.searchsorted(unique_ids, block_ids)
    blocks[slot, coo.row % br_sz, coo.col % bc_sz] = coo.data

    brows = (unique_ids // n_cb).astype(np.int32)
    rowptr = np.searchsorted(brows, np.arange(n_rb + 1)).astype(np.int32)
    return blocks, brows, (unique_ids % n_cb).astype(np.int32), rowptr, mp_r


def tile_levels(counts) -> np.ndarray:
    """Round per-row tile counts up to the palette 1, 2, 3, 4, 6, 8, 12,
    16, ... (powers of two and 1.5x powers of two): a row stores fewer
    than 1.5x its tiles, and rows of at most k tiles use at most
    2 log2(k) + 1 levels.  Empty rows take level 1."""
    c = np.maximum(np.asarray(counts, np.int64), 1)
    p = np.left_shift(1, np.frexp(c)[1] - 1).astype(np.int64)
    return np.where(c == p, p, np.where(2 * c <= 3 * p, 3 * p // 2, 2 * p))


def pack_bsr_groups(csrs):
    """Block-CSR matrices (``pack_block_sparse``'s first four outputs)
    with a common block-row count, to the GROUPED padded layout: block
    rows are sorted by tile count, longest first, and each row is padded
    to its tile-count level (``tile_levels``), so storage stays within
    1.5x of the nonzero tiles however skewed the row degrees; rows of
    one level form one group.  Several matrices (the shards of
    parallel/sparse_halo.py) share one static group list: the j-th
    longest row of each is padded to the largest level among the j-th
    longest rows, so no matrix stores more than every-row-padded-to-
    the-longest would.

    Returns ``(blocks [n, T, br, bc], cols [n, T] int32, row_pos [n,
    n_rb] int32, groups)``: group ``(rows, k)`` owns the next ``rows * k``
    tiles (each row's in column order, zero tiles at column 0 after),
    and block-row ``i``'s output is row ``row_pos[i]`` of the groups'
    outputs concatenated in order."""
    lv = [tile_levels(np.diff(c[3])) for c in csrs]
    orders = [np.argsort(-v, kind="stable") for v in lv]
    width = np.max([v[o] for v, o in zip(lv, orders)], axis=0)  # descending
    start = np.cumsum(width) - width
    ks, rows = np.unique(width, return_counts=True)
    groups = tuple((int(r), int(k)) for r, k in zip(rows[::-1], ks[::-1]))
    n_rb = len(width)
    blk0 = csrs[0][0]
    blocks = np.zeros((len(csrs), int(width.sum())) + blk0.shape[1:],
                      blk0.dtype)
    cols = np.zeros(blocks.shape[:2], np.int32)
    row_pos = np.zeros((len(csrs), n_rb), np.int32)
    for s, ((blk, brows, bcols, rowptr), o) in enumerate(zip(csrs, orders)):
        row_pos[s, o] = np.arange(n_rb)
        slot = (start[row_pos[s, brows]] + np.arange(len(brows))
                - rowptr[brows])
        blocks[s, slot] = blk
        cols[s, slot] = bcols
    return blocks, cols, row_pos, groups


def _block_shape(block_size) -> tuple:
    if block_size == "auto":
        return (BLOCK, BLOCK)
    if isinstance(block_size, int):
        return (block_size, block_size)
    return tuple(block_size)


def device_laplacian(
    L: scipy.sparse.spmatrix,
    lmax: float = 2.0,
    fmt: str = "auto",
    block_size: int | tuple | str = "auto",
    dtype=jnp.float32,
    rescale: bool = True,
    dense_threshold: int = 2048,
    rows_per_step: int | None = None,
    ragged: bool = True,
    dense_budget: int = 2 << 30,
) -> LaplacianOperator:
    """Build a device operator for the (rescaled) Laplacian.

    ``fmt`` is ``dense`` / ``banded`` / ``bsr`` / ``bcoo`` / ``auto``
    (dense for small graphs, then banded for narrow-band graphs, then —
    above ~1/3 block occupancy, if within ``dense_budget`` bytes — dense
    again, BSR otherwise).  ``block_size`` is an int (square tiles),
    ``(rows, cols)``, or ``"auto"`` (128 x 128).  ``rescale`` applies
    the spectral map ``2 L / lmax - I`` (the reference rescales inside
    every filter call, graph_conv.py:148-149; we do it once here).
    ``ragged`` (banded format only, default on) packs per-super-step
    band widths instead of the global max; pass False for the uniform
    layout.
    """
    if rescale:
        L = rescale_laplacian(L, lmax=lmax)
    L = L.tocsr()
    L.eliminate_zeros()
    m = L.shape[0]
    nnz = int(L.nnz)
    block_shape = _block_shape(block_size)

    _stats = None
    if fmt == "auto":
        if m <= dense_threshold:
            fmt = "dense"
        elif block_shape == (BLOCK, BLOCK):
            # Banded when the band is narrow and reasonably full; a
            # scattered graph whose blocks are mostly occupied runs as
            # one dense matmul when it fits the budget.  These thresholds
            # date from the original target and have not been measured
            # on the GPU yet.
            _stats = band_stats(L)
            base, W, n_blocks, _ = _stats
            n_rb = len(base)
            fmt = "banded" if W <= 32 and n_rb * W <= 3 * n_blocks else "bsr"
            if fmt == "bsr":
                density = n_blocks / float(n_rb * n_rb)
                mp8 = _round_up(m, 8)
                dense_bytes = mp8 * mp8 * jnp.dtype(dtype).itemsize
                if density >= 1 / 3 and dense_bytes <= dense_budget:
                    fmt = "dense"
        else:
            fmt = "bsr"

    if fmt == "dense":
        mp = _round_up(m, 8)
        dense = np.zeros((mp, mp), dtype=np.float32)
        coo = L.tocoo()
        dense[coo.row, coo.col] = coo.data
        return DenseLaplacian(
            mat=jnp.asarray(dense, dtype=dtype), m=m, m_padded=mp, nnz=nnz,
        )

    if fmt == "banded":
        from cnn_graph_tpu.ops.pallas_band import ragged_rows, uniform_rows

        if ragged:
            band, base, sched, levels, G, mp = pack_banded_ragged(
                L, block_shape, rows_per_step=rows_per_step, stats=_stats,
                band_dtype=np.dtype(dtype),
            )
            rows = ragged_rows(sched, levels, G)
        else:
            band, base, G, mp = pack_banded(
                L, block_shape, rows_per_step=rows_per_step, stats=_stats,
                band_dtype=np.dtype(dtype),
            )
            sched, levels = (), ()
            rows = uniform_rows(*band.shape[:2])
        return BandedLaplacian(
            band=jnp.asarray(band, dtype=dtype),
            base=jnp.asarray(base),
            rows=jnp.asarray(rows),
            m=m,
            m_padded=mp,
            nnz=nnz,
            block_shape=block_shape,
            rows_per_step=G,
            sched=sched,
            levels=levels,
        )

    if fmt == "bsr":
        *csr, mp = pack_block_sparse(L, block_shape)
        blocks, cols, row_pos, groups = pack_bsr_groups([csr])
        return BlockSparseLaplacian(
            blocks=jnp.asarray(blocks[0], dtype=dtype),
            block_cols=jnp.asarray(cols[0]),
            row_pos=jnp.asarray(row_pos[0]),
            m=m,
            m_padded=mp,
            nnz=nnz,
            block_shape=block_shape,
            groups=groups,
            n_tiles=len(csr[1]),
        )

    if fmt == "bcoo":
        from jax.experimental import sparse as jsparse

        mp = _round_up(m, 8)
        coo = L.tocoo()
        indices = np.stack([coo.row, coo.col], axis=1).astype(np.int32)
        mat = jsparse.BCOO(
            (jnp.asarray(coo.data, dtype=dtype), jnp.asarray(indices)),
            shape=(mp, mp),
        )
        return BCOOLaplacian(bcoo=mat, m=m, m_padded=mp, nnz=nnz)

    raise ValueError(f"unknown Laplacian format {fmt!r}")
