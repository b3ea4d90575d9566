"""Banded block SpMM and fused Chebyshev hop: one Pallas kernel for the GPU.

After RCM ordering a kNN/planar Laplacian tiled into ``br x bc`` blocks is
block-BANDED: block-row ``i`` touches only the column blocks
``base[i] .. base[i] + row_w[i] - 1``.  The band stores those blocks
contiguously in a flat ``[T, br, bc]`` array starting at ``row_off[i]``
(the uniform layout is the special case ``row_off = i * W``,
``row_w = W``).

One program computes one ``(column tile, block-row)`` output tile.  It
loads its own base, offset and width, walks the row's blocks with
``pl.dot`` (accumulating in float32, or int32 for int8 operands) and
applies the epilogue in registers:

* the Chebyshev hop update ``y = 2 acc - x0``;
* the adjoint-chain injection ``+ c`` (see ``filters.cheby_conv_banded``);
* for int8 operators, the dequantise/requantise ``clip(round(2 s acc -
  x0))`` in input-scale units, bit-identical to the XLA int8 path.

The column tile is grid axis 0, so the programs of one block-row launch
next to each other and read its band blocks from L2.  Neighbouring rows
overlap in their x windows, which L2 serves as well.

Route: Triton (``backend="triton"``).  ``pl.dot`` precision: bfloat16
operands run on the tensor cores with float32 accumulation; int8 with
int32 accumulation (exact); float32 operands are computed in IEEE
float32 (``Precision.HIGHEST``, no TF32).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["banded_call", "uniform_rows", "ragged_rows", "band_spmm",
           "band_cheby_hop", "band_cheby_hop_c"]

# (column tile, warps, pipeline stages) per operand dtype: one stage holds
# a band block and an x block in shared memory, and the stages must fit a
# block's 227 KB.  bf16 and int8 were picked by a sweep at the 50k city
# graph, C=512, on an H100 (PERF.md).  float32 bands run on XLA in
# production (ops.backend.band_kernel); the float32 entry only sizes the
# stages to fit, for the interpret-mode tests that check the kernel's
# indexing against SciPy at float32 tolerance.
_TILING = {
    jnp.dtype(jnp.float32): (64, 4, 2),
    jnp.dtype(jnp.bfloat16): (128, 4, 3),
    jnp.dtype(jnp.int8): (64, 4, 4),
}


def _round_half_even(y):
    """``jnp.round`` (half to even) from floor, which the Triton route
    lowers: round half up, then step ties that landed on an odd value
    back down."""
    r = jnp.floor(y + 0.5)
    odd = r - 2.0 * jnp.floor(0.5 * r) != 0.0
    return jnp.where((r - y == 0.5) & odd, r - 1.0, r)


def uniform_rows(n_rows: int, width: int) -> np.ndarray:
    """Row metadata ``[2, n_rows]`` int32 (offset, width) of a uniform
    band of ``width`` blocks per block-row."""
    return np.stack([np.arange(n_rows) * width,
                     np.full(n_rows, width)]).astype(np.int32)


def ragged_rows(sched, levels, G: int) -> np.ndarray:
    """Row metadata ``[2, n_rows]`` int32 of a ragged band whose
    ``G``-row super-step ``s`` starts at ``sched[0][s]`` and is
    ``levels[sched[1][s]]`` blocks wide."""
    offs = np.asarray(sched[0], np.int64)
    w = np.asarray(levels, np.int64)[np.asarray(sched[1], np.int64)]
    g = np.arange(G)
    off = (offs[:, None] + g[None, :] * w[:, None]).reshape(-1)
    return np.stack([off, np.repeat(w, G)]).astype(np.int32)


def _kernel(base_ref, off_ref, w_ref, band_ref, x_ref, *rest, bc, tc, n_cb,
            hop, has_c, band_scale, precision):
    if hop and has_c:
        x0_ref, c_ref, y_ref = rest
    elif hop:
        (x0_ref, y_ref), c_ref = rest, None
    else:
        (y_ref,), x0_ref, c_ref = rest, None, None
    quant = band_scale is not None
    acc_dt = jnp.int32 if quant else jnp.float32
    j = pl.program_id(0)
    i = pl.program_id(1)
    base = base_ref[i]
    off = off_ref[i]
    cols = pl.ds(pl.multiple_of(j * tc, tc), tc)

    def tap(d, acc):
        # A level wider than the row's true span may reach past the last
        # column block; the band block there is zero, so clamping the
        # window keeps the load in bounds without changing the sum.
        col = jnp.minimum(base + d, n_cb - 1)
        xw = x_ref[pl.ds(pl.multiple_of(col * bc, bc), bc), cols]
        return acc + pl.dot(band_ref[off + d], xw, precision=precision)

    acc = jax.lax.fori_loop(0, w_ref[i], tap,
                            jnp.zeros((band_ref.shape[1], tc), acc_dt))
    if quant:
        y = band_scale * acc.astype(jnp.float32)
        if hop:
            y = 2.0 * y - x0_ref[...].astype(jnp.float32)
        y = _round_half_even(jnp.clip(y, -128.0, 128.0))
        y_ref[...] = jnp.clip(y, -127.0, 127.0).astype(y_ref.dtype)
        return
    if hop:
        acc = 2.0 * acc - x0_ref[...].astype(jnp.float32)
        if has_c:
            acc = acc + c_ref[...].astype(jnp.float32)
    y_ref[...] = acc.astype(y_ref.dtype)


def banded_call(band, base, rows, x, x0=None, c=None, *, out_rows: int,
                max_width: int, band_scale: float | None = None,
                interpret: bool = False, donate_x0: bool = False):
    """``y = L @ x`` (``x0`` None), the hop ``y = 2 L x - x0``, or the
    adjoint hop ``y = 2 L x - x0 + c``, on the banded layout.

    ``band``: flat ``[T, br, bc]``; ``base``: ``[n_rows]`` int32 window
    bases into x's block-rows; ``rows``: ``[2, n_rows]`` int32 (offset
    into ``band``, width) per block-row, at most ``max_width`` wide.
    ``x`` may hold MORE rows than ``out_rows = n_rows * br`` (the
    sharded operators pass ``[left halo | local | right halo]``).
    ``band_scale`` selects the int8 path (int8 band and activations).
    ``donate_x0`` writes ``y`` over ``x0``'s buffer: each program reads
    its x0 tile before it writes the same tile.
    """
    T, br, bc = band.shape
    n_rows = base.shape[0]
    assert out_rows == n_rows * br, (out_rows, n_rows, br)
    assert x.shape[0] % bc == 0, x.shape
    assert c is None or x0 is not None, "c injection requires the hop form"
    quant = band_scale is not None
    dt = jnp.dtype(band.dtype)
    tile, warps, stages = _TILING[dt]
    C = x.shape[1]
    tc = min(tile, max(16, int(pl.next_power_of_2(C))))
    cp = -(-C // tc) * tc
    x = x.astype(dt)
    if x0 is not None:
        x0 = x0.astype(dt)
    if c is not None:
        c = c.astype(dt)
    if cp != C:
        pad = ((0, 0), (0, cp - C))
        x = jnp.pad(x, pad)
        x0 = None if x0 is None else jnp.pad(x0, pad)
        c = None if c is None else jnp.pad(c, pad)
    hop = x0 is not None
    has_c = c is not None
    precision = (jax.lax.Precision.HIGHEST if dt == jnp.float32
                 else jax.lax.Precision.DEFAULT)

    tile_spec = pl.BlockSpec((br, tc), lambda j, i: (i, j))
    operands = [base, rows[0], rows[1], band, x]
    in_specs = [pl.BlockSpec()] * 5  # whole arrays, indexed in-kernel
    if hop:
        operands.append(x0)
        in_specs.append(tile_spec)
    if has_c:
        operands.append(c)
        in_specs.append(tile_spec)
    n_tap_blocks = n_rows * max_width
    y = pl.pallas_call(
        functools.partial(
            _kernel, bc=bc, tc=tc, n_cb=x.shape[0] // bc, hop=hop,
            has_c=has_c, band_scale=band_scale, precision=precision,
        ),
        out_shape=jax.ShapeDtypeStruct((out_rows, cp), dt),
        grid=(cp // tc, n_rows),
        in_specs=in_specs,
        out_specs=tile_spec,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps,
                                             num_stages=stages),
        input_output_aliases={5: 0} if (donate_x0 and hop) else {},
        interpret=interpret,
        name="banded_hop_q" if quant else "banded_hop",
        cost_estimate=pl.CostEstimate(
            flops=2 * n_tap_blocks * br * bc * cp,
            bytes_accessed=int(T * br * bc * dt.itemsize
                               + (3 + has_c if hop else 2)
                               * out_rows * cp * dt.itemsize),
            transcendentals=0,
        ),
    )(*operands)
    return y[:, :C] if cp != C else y


# ---- operator-level entry points (BandedLaplacian / QuantBanded) ----


def _flat(L):
    """The operator's band as the kernel's flat ``[T, br, bc]`` array."""
    br, bc = L.block_shape
    return L.band.reshape(-1, br, bc)


def _call(L, x, x0=None, c=None, donate=False, interpret=False):
    return banded_call(
        _flat(L), L.base, L.rows, x, x0, c, out_rows=L.m_padded,
        max_width=L.band_width, donate_x0=donate, interpret=interpret,
    ).astype(x.dtype)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def band_spmm(L, x: jax.Array, interpret: bool = False) -> jax.Array:
    """``L @ x`` through the kernel; symmetric-adjoint VJP ``dx = L g``
    (the operator is a differentiable argument with zero cotangents)."""
    return _call(L, x, interpret=interpret)


def _spmm_fwd(L, x, interpret):
    return _call(L, x, interpret=interpret), L


def _spmm_bwd(interpret, L, g):
    from cnn_graph_tpu.ops.laplacian import zero_cotangent

    return zero_cotangent(L), _call(L, g, interpret=interpret)


band_spmm.defvjp(_spmm_fwd, _spmm_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def band_cheby_hop(L, x1: jax.Array, x0: jax.Array, donate: bool = False,
                   interpret: bool = False) -> jax.Array:
    """Fused hop ``2 (L @ x1) - x0``; VJP ``dx1 = 2 L g``, ``dx0 = -g``.
    ``donate`` writes the result over ``x0`` (chain drivers use it so
    while-loop carries stay in fixed buffers)."""
    return _call(L, x1, x0, donate=donate, interpret=interpret)


def _hop_fwd(L, x1, x0, donate, interpret):
    return _call(L, x1, x0, donate=donate, interpret=interpret), L


def _hop_bwd(donate, interpret, L, g):
    from cnn_graph_tpu.ops.laplacian import zero_cotangent

    return (zero_cotangent(L), 2.0 * _call(L, g, interpret=interpret),
            -g)


band_cheby_hop.defvjp(_hop_fwd, _hop_bwd)


def band_cheby_hop_c(L, x1: jax.Array, x0: jax.Array, c: jax.Array,
                     interpret: bool = False) -> jax.Array:
    """Adjoint-chain hop ``2 (L @ x1) - x0 + c`` in one kernel pass.  No
    VJP: it runs inside ``cheby_conv_banded``'s own backward."""
    return _call(L, x1, x0, c, interpret=interpret)
