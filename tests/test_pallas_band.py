"""Banded block SpMM: packing invariants, XLA-path and kernel
(Pallas Triton route, interpret mode) parity against scipy, custom-VJP
gradients, and the auto-format selection.  The last section runs the
kernel over float32, bfloat16 and int8 bands, uniform and ragged
layouts, SpMM / hop / hop with the adjoint injection, column padding and
several column tiles, and the donated hop, against the XLA paths of the
same operators.  The compiled kernel runs on the GPU in
``chip_smoke.py`` and in the ``gpu``-marked test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnn_graph_tpu.data.synthetic import city_graph
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.ops import device_laplacian, quantize_banded
from cnn_graph_tpu.ops.laplacian import BandedLaplacian, band_stats, quant_emit
from cnn_graph_tpu.ops.pallas_band import (
    _round_half_even,
    band_spmm,
    banded_call,
    ragged_rows,
    uniform_rows,
)


@pytest.fixture(scope="module")
def banded_graph():
    """~1200-node planar kNN graph, RCM-ordered: multiple 128-blocks with
    a genuine moving band (the bench's city-graph shape in miniature)."""
    rng = np.random.default_rng(0)
    side = 35
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    z = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    z += rng.normal(0, 0.3, z.shape).astype(np.float32)
    dist, idx = gc.knn(z, k=8, algorithm="auto")
    W = gc.adjacency(dist, idx)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return gc.laplacian(W, normalized=True)


class TestBandPacking:
    def test_band_stats_invariants(self, banded_graph):
        base, W, n_blocks, mp = band_stats(banded_graph)
        n_cb = mp // 128
        assert np.all(np.diff(base) >= 0), "bases must be monotone"
        assert base.min() >= 0 and base.max() + W <= n_cb
        assert n_blocks <= len(base) * W
        coo = banded_graph.tocoo()
        brow, bcol = coo.row // 128, coo.col // 128
        assert np.all(base[brow] <= bcol) and np.all(bcol < base[brow] + W)

    def test_packed_band_reconstructs_matrix(self, banded_graph):
        op = device_laplacian(banded_graph, fmt="banded", ragged=False)
        Lr = gc.rescale_laplacian(banded_graph, 2.0)
        band = np.asarray(op.band)
        base = np.asarray(op.base)
        nbr, W, br, bc = band.shape
        dense = np.zeros((op.m_padded, op.m_padded), np.float32)
        for i in range(nbr):
            for d in range(W):
                c = base[i] + d
                dense[i * br:(i + 1) * br, c * bc:(c + 1) * bc] = band[i, d]
        np.testing.assert_allclose(
            dense[: op.m, : op.m], Lr.toarray(), atol=1e-6
        )

    def test_width_guard(self, banded_graph):
        from cnn_graph_tpu.ops.laplacian import pack_banded

        # A random permutation destroys the band -> packing must refuse.
        rng = np.random.default_rng(1)
        p = rng.permutation(banded_graph.shape[0])
        scattered = banded_graph[p][:, p].tocsr()
        with pytest.raises(ValueError, match="band width"):
            pack_banded(scattered, max_band_width=4)


class TestBandMatmul:
    def test_xla_fallback_matches_scipy(self, banded_graph):
        op = device_laplacian(banded_graph, fmt="banded")
        Lr = gc.rescale_laplacian(banded_graph, 2.0)
        rng = np.random.default_rng(1)
        X = rng.normal(size=(op.m_padded, 64)).astype(np.float32)
        X[op.m:] = 0
        got = np.asarray(jax.jit(lambda o, x: o.matmul(x))(op, jnp.asarray(X)))
        np.testing.assert_allclose(got[: op.m], Lr @ X[: op.m], atol=1e-4)
        np.testing.assert_allclose(got[op.m:], 0.0, atol=1e-5)

    def test_pallas_interpret_matches_scipy(self, banded_graph):
        op = device_laplacian(banded_graph, fmt="banded")
        Lr = gc.rescale_laplacian(banded_graph, 2.0)
        rng = np.random.default_rng(2)
        X = rng.normal(size=(op.m_padded, 256)).astype(np.float32)
        X[op.m:] = 0
        got = np.asarray(band_spmm(op, jnp.asarray(X), interpret=True))
        np.testing.assert_allclose(got[: op.m], Lr @ X[: op.m], atol=1e-4)

    def test_pallas_column_padding(self, banded_graph):
        # C not a multiple of the tile.
        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(3)
        X = rng.normal(size=(op.m_padded, 200)).astype(np.float32)
        got = np.asarray(band_spmm(op, jnp.asarray(X), interpret=True))
        assert got.shape == (op.m_padded, 200)
        Lr = gc.rescale_laplacian(banded_graph, 2.0)
        np.testing.assert_allclose(got[: op.m], Lr @ X[: op.m], atol=1e-4)

    def test_pallas_multiple_column_tiles(self, banded_graph):
        # C above the float32 column tile (64) gives the column grid axis
        # several programs.
        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(4)
        X = rng.normal(size=(op.m_padded, 256)).astype(np.float32)
        got = np.asarray(banded_call(
            op.band, op.base, op.rows, jnp.asarray(X), out_rows=op.m_padded,
            max_width=op.band_width, interpret=True,
        ))
        want = np.asarray(op.matmul(jnp.asarray(X)))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_gradient_symmetric_adjoint(self, banded_graph):
        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(5)
        X = jnp.asarray(rng.normal(size=(op.m_padded, 128)).astype(np.float32))

        def f_pallas(x):
            return jnp.sum(band_spmm(op, x, True) ** 2)

        def f_xla(x):
            return jnp.sum(op.matmul(x) ** 2)

        g_pallas = np.asarray(jax.grad(f_pallas)(X))
        g_xla = np.asarray(jax.grad(f_xla)(X))
        np.testing.assert_allclose(g_pallas, g_xla, rtol=1e-4, atol=1e-4)


class TestAutoSelection:
    def test_auto_prefers_banded_for_rcm_graph(self, banded_graph):
        op = device_laplacian(banded_graph, fmt="auto", dense_threshold=512)
        assert isinstance(op, BandedLaplacian)

    def test_auto_scattered_block_dense_picks_dense(self):
        from cnn_graph_tpu.ops.laplacian import (
            BlockSparseLaplacian,
            DenseLaplacian,
        )

        # A large unordered kNN graph: the block band spans nearly the
        # whole matrix, so auto must refuse banded (W > 32 blocks) — and
        # because the occupied 128-blocks exceed 1/3 of all blocks, auto
        # picks one dense matmul when it fits the memory budget ...
        rng = np.random.default_rng(6)
        z = rng.uniform(size=(6000, 2)).astype(np.float32)
        W = gc.knn_graph(z, k=6)
        L = gc.laplacian(W, normalized=True)
        op = device_laplacian(L, fmt="auto", dense_threshold=512)
        assert isinstance(op, DenseLaplacian)
        # ... and falls back to BSR when the dense matrix would not.
        op2 = device_laplacian(L, fmt="auto", dense_threshold=512,
                               dense_budget=1 << 20)
        assert isinstance(op2, BlockSparseLaplacian)

    def test_cheby_conv_through_banded(self, banded_graph):
        from cnn_graph_tpu.ops import cheby_conv

        op_band = device_laplacian(banded_graph, fmt="banded")
        op_dense = device_laplacian(banded_graph, fmt="dense")
        rng = np.random.default_rng(7)
        B, F, K, Fout = 4, 3, 5, 8
        m = op_band.m
        x = rng.normal(size=(B, m, F)).astype(np.float32)

        def run(op):
            xp = np.zeros((B, op.m_padded, F), np.float32)
            xp[:, :m] = x
            return np.asarray(jax.jit(cheby_conv)(jnp.asarray(xp), op, w))

        w = jnp.asarray(rng.normal(size=(K, F, Fout)) * 0.1, jnp.float32)
        np.testing.assert_allclose(
            run(op_band)[:, :m], run(op_dense)[:, :m], atol=1e-4
        )


class TestFusedChebyHop:
    def test_hop_matches_unfused(self, banded_graph):
        from cnn_graph_tpu.ops.pallas_band import band_cheby_hop

        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(8)
        x1 = jnp.asarray(rng.normal(size=(op.m_padded, 256)), jnp.float32)
        x0 = jnp.asarray(rng.normal(size=(op.m_padded, 256)), jnp.float32)
        got = np.asarray(band_cheby_hop(op, x1, x0, interpret=True))
        want = np.asarray(2.0 * op.matmul(x1) - x0)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_hop_gradients(self, banded_graph):
        from cnn_graph_tpu.ops.pallas_band import band_cheby_hop

        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(9)
        x1 = jnp.asarray(rng.normal(size=(op.m_padded, 128)), jnp.float32)
        x0 = jnp.asarray(rng.normal(size=(op.m_padded, 128)), jnp.float32)

        def f_pallas(x1, x0):
            return jnp.sum(band_cheby_hop(op, x1, x0, interpret=True) ** 2)

        def f_ref(x1, x0):
            return jnp.sum((2.0 * op.matmul(x1) - x0) ** 2)

        g1p, g0p = jax.grad(f_pallas, argnums=(0, 1))(x1, x0)
        g1r, g0r = jax.grad(f_ref, argnums=(0, 1))(x1, x0)
        np.testing.assert_allclose(np.asarray(g1p), np.asarray(g1r),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(g0p), np.asarray(g0r),
                                   rtol=1e-4, atol=1e-4)

    def test_cheby_basis_uses_hop_protocol(self, banded_graph):
        # The basis built through cheby_hop matches the NumPy oracle.
        from cnn_graph_tpu.graphs.construction import chebyshev_basis
        from cnn_graph_tpu.ops import cheby_basis

        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(10)
        m = op.m
        x = np.zeros((2, op.m_padded, 3), np.float32)
        x[:, :m] = rng.normal(size=(2, m, 3))
        got = np.asarray(jax.jit(cheby_basis, static_argnums=2)(
            jnp.asarray(x), op, 4))
        Lr = gc.rescale_laplacian(banded_graph, 2.0)
        want = chebyshev_basis(Lr, x[0, :m], 4)  # [K, m, F]
        np.testing.assert_allclose(got[:, 0, :m], want, atol=1e-3)


class TestExtendedColumnMode:
    """banded_call's sharded-halo usage: window bases offset into an
    extended x (left/right halo rows), out_rows < x rows.  This is the
    mode the BandedHaloLaplacian kernel path runs per shard — exercised
    here in interpret mode against the unshifted kernel."""

    def test_shifted_base_matches_unshifted(self, banded_graph):
        from cnn_graph_tpu.ops.pallas_band import banded_call

        op = device_laplacian(banded_graph, fmt="banded", ragged=False)
        rng = np.random.default_rng(11)
        C = 256
        x = rng.normal(size=(op.m_padded, C)).astype(np.float32)
        flat = op.band.reshape(-1, 128, 128)
        kw = dict(out_rows=op.m_padded, max_width=op.band_width,
                  interpret=True)

        want = np.asarray(banded_call(flat, op.base, op.rows,
                                      jnp.asarray(x), **kw))

        # Prepend OFF zero block-rows to x and shift every window base:
        # identical math through the extended-column path.
        for off in (1, 3):
            x_ext = np.concatenate(
                [rng.normal(size=(off * 128, C)).astype(np.float32), x]
            )
            base_ext = np.asarray(op.base) + off
            got = np.asarray(banded_call(
                flat, jnp.asarray(base_ext.astype(np.int32)), op.rows,
                jnp.asarray(x_ext), **kw,
            ))
            np.testing.assert_allclose(got, want, atol=1e-4,
                                       err_msg=f"offset {off}")

    def test_shifted_base_fused_hop(self, banded_graph):
        from cnn_graph_tpu.ops.pallas_band import banded_call

        op = device_laplacian(banded_graph, fmt="banded", ragged=False)
        rng = np.random.default_rng(12)
        C, off = 128, 2
        x = rng.normal(size=(op.m_padded, C)).astype(np.float32)
        x0 = rng.normal(size=(op.m_padded, C)).astype(np.float32)
        x_ext = np.concatenate(
            [np.zeros((off * 128, C), np.float32), x]
        )
        base_ext = (np.asarray(op.base) + off).astype(np.int32)
        got = np.asarray(banded_call(
            op.band.reshape(-1, 128, 128), jnp.asarray(base_ext), op.rows,
            jnp.asarray(x_ext), jnp.asarray(x0), out_rows=op.m_padded,
            max_width=op.band_width, interpret=True,
        ))
        want = np.asarray(2.0 * op.matmul(jnp.asarray(x)) - x0)
        np.testing.assert_allclose(got, want, atol=1e-4)


class TestQuantizedBand:
    """Int8 inference path (QuantBandedLaplacian): kernel/fallback
    bit-exactness, single-SpMM error, and drift over a full recurrence
    against the float chain."""

    @pytest.fixture(scope="class")
    def qsetup(self, banded_graph):
        from cnn_graph_tpu.ops import quantize_banded

        op = device_laplacian(banded_graph, fmt="banded", ragged=False)
        rng = np.random.default_rng(13)
        x = rng.normal(size=(op.m_padded, 128)).astype(np.float32)
        x[op.m:] = 0
        qop = quantize_banded(op, sample_x=float(np.max(np.abs(x))))
        return op, qop, x

    def test_quantized_matmul_close_to_float(self, qsetup):
        op, qop, x = qsetup
        got = np.asarray(jax.jit(lambda o, v: o.matmul(v))(
            qop, jnp.asarray(x)))
        want = np.asarray(op.matmul(jnp.asarray(x)))
        # Global-scale int8 on Gaussian data: the max/RMS ratio (~4.4)
        # costs ~2 bits, so a single quant->spmm->dequant round trip
        # lands at ~6% RMS (input + output rounding); per-tensor-adaptive
        # scales would halve it at the price of per-tap rescaling —
        # accepted for the serving path.
        rel = (np.linalg.norm(got[: op.m] - want[: op.m])
               / np.linalg.norm(want[: op.m]))
        assert rel < 0.08, rel

    def test_kernel_interpret_matches_fallback_bitexact(self, qsetup):
        op, qop, x = qsetup
        xq = qop.quantize(jnp.asarray(x))
        x0q = qop.quantize(jnp.asarray(0.3 * x))
        got = np.asarray(banded_call(
            qop.band.reshape(-1, 128, 128), qop.base, qop.rows, xq, x0q,
            out_rows=qop.m_padded, max_width=qop.band_width,
            band_scale=qop.band_scale, interpret=True,
        ))
        want = np.asarray(qop._call(xq, x0q))  # XLA integer fallback
        np.testing.assert_array_equal(got, want)

    def test_quantized_chain_tracks_float_chain(self, qsetup):
        op, qop, x = qsetup
        K = 15

        @jax.jit
        def chain_f(op, x):
            def hop(c, _):
                a, b = c
                return (b, op.cheby_hop(b, a)), None

            (a, b), _ = jax.lax.scan(hop, (x, op.matmul(x)), None,
                                     length=K)
            return b

        @jax.jit
        def chain_q(qop, x):
            xq = qop.quantize(x)

            def hop(c, _):
                a, b = c
                return (b, qop.cheby_hop_q(b, a)), None

            (a, b), _ = jax.lax.scan(hop, (xq, qop.spmm_q(xq)), None,
                                     length=K)
            return qop.dequantize(b)

        xf = jnp.asarray(x)
        want = np.asarray(chain_f(op, xf))
        got = np.asarray(chain_q(qop, xf))
        rel = (np.linalg.norm(got[: op.m] - want[: op.m])
               / np.linalg.norm(want[: op.m]))
        assert rel < 0.15, rel


class TestRaggedBand:
    """Ragged per-super-step band widths (pack_banded_ragged): packing
    reconstruction, XLA-path-vs-scipy, interpret-kernel parity,
    gradients, and the quantized twin."""

    @pytest.fixture(scope="class")
    def rop(self, banded_graph):
        return device_laplacian(banded_graph, fmt="banded")  # ragged is the default

    def test_ragged_is_default_and_saves_blocks(self, banded_graph, rop):
        uni = device_laplacian(banded_graph, fmt="banded", ragged=False)
        assert rop.levels, "banded default should pack ragged"
        assert rop.band.ndim == 3
        assert rop.band.shape[0] <= uni.band.shape[0] * uni.band.shape[1]

    def test_ragged_pack_reconstructs_matrix(self, banded_graph, rop):
        Lr = gc.rescale_laplacian(banded_graph, 2.0).toarray()
        br, bc = rop.block_shape
        G = rop.rows_per_step
        offs, lvl_idx = rop.sched
        band = np.asarray(rop.band)
        base = np.asarray(rop.base)
        dense = np.zeros((rop.m_padded, rop.m_padded), np.float32)
        for s in range(len(offs)):
            w = rop.levels[lvl_idx[s]]
            blk = band[offs[s]: offs[s] + G * w].reshape(G, w, br, bc)
            for g in range(G):
                r0 = (s * G + g) * br
                for d in range(w):
                    c0 = (base[s * G + g] + d) * bc
                    if c0 < rop.m_padded:
                        dense[r0:r0 + br, c0:c0 + bc] += blk[g, d]
        np.testing.assert_allclose(dense[: rop.m, : rop.m], Lr, atol=1e-6)

    def test_ragged_fallback_matches_scipy(self, banded_graph, rop):
        rng = np.random.default_rng(21)
        C = 64
        x = rng.normal(size=(rop.m_padded, C)).astype(np.float32)
        got = np.asarray(jax.jit(lambda o, v: o.matmul(v))(
            rop, jnp.asarray(x)))
        Lr = gc.rescale_laplacian(banded_graph, 2.0)
        want = Lr @ x[: rop.m]
        np.testing.assert_allclose(got[: rop.m], want, atol=1e-4)

    def test_ragged_interpret_kernel_matches_fallback(self, rop):
        from cnn_graph_tpu.ops.pallas_band import band_cheby_hop, band_spmm

        rng = np.random.default_rng(22)
        C = 192  # forces column padding too
        x = jnp.asarray(rng.normal(size=(rop.m_padded, C)), jnp.float32)
        x0 = jnp.asarray(rng.normal(size=(rop.m_padded, C)), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(band_spmm(rop, x, True)),
            np.asarray(rop.matmul(x)), atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(band_cheby_hop(rop, x, x0, interpret=True)),
            np.asarray(2.0 * rop.matmul(x) - x0), atol=1e-4)

    def test_ragged_gradients_symmetric_adjoint(self, rop):
        from cnn_graph_tpu.ops.pallas_band import band_cheby_hop

        rng = np.random.default_rng(23)
        C = 128
        x = jnp.asarray(rng.normal(size=(rop.m_padded, C)), jnp.float32)
        x0 = jnp.asarray(rng.normal(size=(rop.m_padded, C)), jnp.float32)

        def f(x, x0):
            return jnp.sum(band_cheby_hop(rop, x, x0, interpret=True) ** 2)

        gx, gx0 = jax.grad(f, argnums=(0, 1))(x, x0)
        g = 2.0 * band_cheby_hop(rop, x, x0, interpret=True)
        np.testing.assert_allclose(np.asarray(gx),
                                   np.asarray(2.0 * rop.matmul(g)),
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(gx0), np.asarray(-g),
                                   atol=1e-6)

    def test_ragged_quantized_bitexact_and_conv(self, banded_graph, rop):
        from cnn_graph_tpu.ops import cheby_conv, quantize_banded

        rng = np.random.default_rng(24)
        qop = quantize_banded(rop, sample_x=3.0)
        assert qop.levels == rop.levels
        xq = qop.quantize(jnp.asarray(
            rng.normal(size=(rop.m_padded, 128)).astype(np.float32)))
        x0q = qop.quantize(jnp.asarray(
            rng.normal(size=(rop.m_padded, 128)).astype(np.float32)))
        got = np.asarray(banded_call(
            qop.band, qop.base, qop.rows, xq, x0q, out_rows=qop.m_padded,
            max_width=qop.band_width, band_scale=qop.band_scale,
            interpret=True))
        want = np.asarray(qop._call(xq, x0q))
        np.testing.assert_array_equal(got, want)

        # and through the public conv with the f32 ragged op as oracle
        K, Fin, Fout = 6, 8, 8
        x = jnp.asarray(rng.normal(size=(2, rop.m, Fin)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.2, jnp.float32)
        want_c = np.asarray(jax.jit(cheby_conv)(x, rop, w))
        got_c = np.asarray(jax.jit(cheby_conv)(x, qop, w))
        rel = np.linalg.norm(got_c - want_c) / np.linalg.norm(want_c)
        assert rel < 0.12, rel


class TestAdjointChainConv:
    """cheby_conv_banded: the streaming banded conv whose backward runs
    the fused three-term ADJOINT recurrence (cheby_hop_c, one kernel
    pass per hop on the GPU) instead of autodiff's un-fused SpMM + two
    elementwise passes."""

    @pytest.fixture(scope="class")
    def ops_pair(self, banded_graph):
        rop = device_laplacian(banded_graph, fmt="banded")
        uop = device_laplacian(banded_graph, fmt="banded", ragged=False)
        dref = device_laplacian(banded_graph, fmt="dense")
        return rop, uop, dref

    def test_hop_c_interpret_matches_math(self, ops_pair):
        from cnn_graph_tpu.ops.pallas_band import band_cheby_hop_c

        rop, uop, _ = ops_pair
        rng = np.random.default_rng(30)
        C = 192
        x1 = jnp.asarray(rng.normal(size=(rop.m_padded, C)), jnp.float32)
        x0 = jnp.asarray(rng.normal(size=(rop.m_padded, C)), jnp.float32)
        c = jnp.asarray(rng.normal(size=(rop.m_padded, C)), jnp.float32)
        for op in (rop, uop):
            got = np.asarray(band_cheby_hop_c(op, x1, x0, c,
                                              interpret=True))
            want = np.asarray(2.0 * op.matmul(x1) - x0 + c)
            np.testing.assert_allclose(got, want, atol=1e-4)

    def test_forward_matches_dense_reference(self, ops_pair):
        from cnn_graph_tpu.ops import cheby_conv

        rop, _uop, dref = ops_pair
        rng = np.random.default_rng(31)
        B, Fin, Fout, K = 3, 4, 5, 7
        x = jnp.asarray(rng.normal(size=(B, rop.m, Fin)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.2, jnp.float32)
        got = np.asarray(jax.jit(cheby_conv)(x, rop, w))
        want = np.asarray(jax.jit(cheby_conv)(
            jnp.asarray(np.asarray(x)[:, : dref.m]), dref, w))
        np.testing.assert_allclose(got, want[:, : rop.m], atol=2e-3)

    @pytest.mark.parametrize("K", [1, 2, 3, 7])
    def test_grads_match_autodiff_through_hops(self, ops_pair, K):
        """dx and dW from the fused adjoint chain vs plain autodiff
        through the per-hop path (the old cheby_basis + einsum route)."""
        from cnn_graph_tpu.ops.filters import cheby_basis, cheby_conv_banded

        rop, _uop, _ = ops_pair
        rng = np.random.default_rng(32)
        B, Fin, Fout = 2, 4, 3
        x = jnp.asarray(rng.normal(size=(B, rop.m, Fin)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.3, jnp.float32)
        t = jnp.asarray(rng.normal(size=(B, rop.m, Fout)), jnp.float32)

        def loss_stream(x, w):
            return jnp.sum(cheby_conv_banded(x, rop, w) * t)

        def loss_generic(x, w):
            basis = cheby_basis(x, rop, K)
            y = jnp.einsum("kbmf,kfo->bmo", basis, w)
            return jnp.sum(y * t)

        gx1, gw1 = jax.jit(jax.grad(loss_stream, argnums=(0, 1)))(x, w)
        gx2, gw2 = jax.jit(jax.grad(loss_generic, argnums=(0, 1)))(x, w)
        np.testing.assert_allclose(np.asarray(gx1), np.asarray(gx2),
                                   atol=2e-3, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(gw1), np.asarray(gw2),
                                   atol=2e-3, rtol=1e-4)

    def test_node_classifier_trains_through_streaming_conv(self,
                                                          banded_graph):
        """End to end: a NodeClassifier on a banded operator still
        learns (loss drops) through the new conv + adjoint backward."""
        import optax

        from cnn_graph_tpu.models import NodeClassifier

        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(33)
        model = NodeClassifier(op, input_features=4, num_classes=3,
                               hidden=[8], K=4)
        params = model.init(jax.random.PRNGKey(0))
        x = jnp.asarray(rng.normal(size=(op.m_padded, 4)), jnp.float32)
        y = jnp.asarray(rng.integers(0, 3, op.m_padded), jnp.int32)
        mask = jnp.ones((op.m_padded,), bool)
        opt = optax.adam(1e-2)
        state = opt.init(params)

        @jax.jit
        def step(params, state):
            l, g = jax.value_and_grad(model.loss)(params, x, y, mask)
            up, state = opt.update(g, state, params)
            return optax.apply_updates(params, up), state, l

        losses = []
        for _ in range(12):
            params, state, l = step(params, state)
            losses.append(float(l))
        assert losses[-1] < losses[0], losses

    def test_input_grad_false_skips_dx_keeps_dw(self, ops_pair):
        """input_grad=False (the first-layer declaration): dW identical
        to the differentiated path, dx exactly zero — and the backward
        jaxpr carries no adjoint-chain kernel calls."""
        from cnn_graph_tpu.ops.filters import cheby_conv_banded

        rop, _uop, _ = ops_pair
        rng = np.random.default_rng(34)
        B, Fin, Fout, K = 2, 4, 3, 7
        x = jnp.asarray(rng.normal(size=(B, rop.m, Fin)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.3, jnp.float32)
        t = jnp.asarray(rng.normal(size=(B, rop.m, Fout)), jnp.float32)

        def loss(x, w, input_grad):
            return jnp.sum(cheby_conv_banded(x, rop, w, input_grad) * t)

        gx1, gw1 = jax.grad(loss, argnums=(0, 1))(x, w, True)
        gx0, gw0 = jax.grad(loss, argnums=(0, 1))(x, w, False)
        np.testing.assert_allclose(np.asarray(gw0), np.asarray(gw1),
                                   atol=1e-5, rtol=1e-5)
        assert not np.any(np.asarray(gx0))
        assert np.any(np.asarray(gx1))


class TestChebyFinals:
    """cheby_finals: the donated double-hop chain driver (final-carry
    recurrence behind the benchmarks) against the NumPy oracle, and the
    in-place (input_output_aliases) kernel path in interpret mode."""

    @pytest.mark.parametrize("K", [1, 2, 5, 6])
    def test_matches_oracle_float(self, banded_graph, K):
        from cnn_graph_tpu.graphs.construction import chebyshev_basis
        from cnn_graph_tpu.ops import cheby_finals

        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(21)
        x = np.zeros((op.m_padded, 16), np.float32)
        x[: op.m] = rng.normal(size=(op.m, 16))
        got = np.asarray(jax.jit(
            lambda o, v: cheby_finals(o, v, K))(op, jnp.asarray(x)))
        Lr = gc.rescale_laplacian(banded_graph, 2.0)
        want = chebyshev_basis(Lr, x[: op.m], K)[K - 1]
        np.testing.assert_allclose(got[: op.m], want, atol=2e-3)

    @pytest.mark.parametrize("K", [4, 5])
    def test_quant_path_matches_unrolled(self, banded_graph, K):
        from cnn_graph_tpu.ops import cheby_finals, quantize_banded

        op = device_laplacian(banded_graph, fmt="banded")
        rng = np.random.default_rng(22)
        x = np.zeros((op.m_padded, 16), np.float32)
        x[: op.m] = rng.normal(size=(op.m, 16))
        qop = quantize_banded(op, sample_x=float(np.max(np.abs(x))))
        xq = jax.jit(lambda o, v: o.quantize(v))(qop, jnp.asarray(x))

        got = np.asarray(jax.jit(
            lambda o, v: cheby_finals(o, v, K))(qop, xq))

        @jax.jit
        def unrolled(qop, xq):
            basis = [xq, qop.spmm_q(xq)]
            for _ in range(2, K):
                basis.append(qop.cheby_hop_q(basis[-1], basis[-2]))
            return basis[K - 1]

        want = np.asarray(unrolled(qop, xq))
        np.testing.assert_array_equal(got, want)  # same int arithmetic

    def test_donated_kernel_matches_undonated(self, banded_graph):
        op = device_laplacian(banded_graph, fmt="banded", ragged=False)
        rng = np.random.default_rng(23)
        C = 128
        x = rng.normal(size=(op.m_padded, C)).astype(np.float32)
        x0 = rng.normal(size=(op.m_padded, C)).astype(np.float32)
        kw = dict(out_rows=op.m_padded, max_width=op.band_width,
                  interpret=True)
        flat = op.band.reshape(-1, 128, 128)
        want = np.asarray(banded_call(
            flat, op.base, op.rows, jnp.asarray(x), jnp.asarray(x0), **kw))
        got = np.asarray(banded_call(
            flat, op.base, op.rows, jnp.asarray(x), jnp.asarray(x0),
            donate_x0=True, **kw))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_donated_ragged_kernel_matches(self, banded_graph):
        op = device_laplacian(banded_graph, fmt="banded")
        assert op.levels, "fixture should pack ragged by default"
        rng = np.random.default_rng(24)
        C = 128
        x = rng.normal(size=(op.m_padded, C)).astype(np.float32)
        x0 = rng.normal(size=(op.m_padded, C)).astype(np.float32)
        kw = dict(out_rows=op.m_padded, max_width=op.band_width,
                  interpret=True)
        want = np.asarray(banded_call(
            op.band, op.base, op.rows, jnp.asarray(x), jnp.asarray(x0),
            **kw))
        got = np.asarray(banded_call(
            op.band, op.base, op.rows, jnp.asarray(x), jnp.asarray(x0),
            donate_x0=True, **kw))
        np.testing.assert_allclose(got, want, atol=1e-5)


# ---- the kernel over dtypes, layouts and modes (interpret mode) ----

BS = 32  # small blocks keep the interpreter fast


@pytest.fixture(scope="module")
def ops():
    """float32 operators of a 576-node city graph in 32-blocks, ragged
    (several width levels) and uniform."""
    L, _ = city_graph(24, k=8, seed=0)
    rag = device_laplacian(L, fmt="banded", block_size=BS, rows_per_step=2)
    uni = device_laplacian(L, fmt="banded", block_size=BS, ragged=False)
    assert len(rag.levels) >= 2, rag.levels
    return {"ragged": rag, "uniform": uni}


def _typed(op, dtype):
    if dtype == "int8":
        return quantize_banded(op, sample_x=3.0)
    return jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a, op)


def _kernel(op, x, x0=None, c=None, **kw):
    quant = hasattr(op, "band_scale")
    return banded_call(
        op.band.reshape(-1, BS, BS), op.base, op.rows, x, x0, c,
        out_rows=op.m_padded, max_width=op.band_width,
        band_scale=op.band_scale if quant else None, interpret=True, **kw)


def _inputs(op, C, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shape = (op.m_padded, C)
    if dtype == "int8":
        return [jnp.asarray(rng.integers(-100, 100, shape), jnp.int8)
                for _ in range(3)]
    return [jnp.asarray(rng.normal(size=shape), dtype) for _ in range(3)]


def _xla(op, mode, x, x0, c):
    if hasattr(op, "band_scale"):
        return op.spmm_q(x) if mode == "spmm" else op.cheby_hop_q(x, x0)
    y = op.matmul(x)
    if mode == "spmm":
        return y
    y = 2.0 * y.astype(jnp.float32) - x0.astype(jnp.float32)
    if mode == "hop_c":
        y = y + c.astype(jnp.float32)
    return y.astype(x.dtype)


CASES = [(dt, mode) for dt in ("float32", "bfloat16", "int8")
         for mode in ("spmm", "hop", "hop_c")
         if not (dt == "int8" and mode == "hop_c")]


# C=40 sits below every column tile (padded); C=160 spans several tiles
# of every dtype (64 float32/int8, 128 bf16 columns) and pads the last.
@pytest.mark.parametrize("C", [40, 160], ids=["pad", "tiles"])
@pytest.mark.parametrize("layout", ["uniform", "ragged"])
@pytest.mark.parametrize("dtype,mode", CASES)
def test_kernel_matches_xla_path(ops, dtype, mode, layout, C):
    op = _typed(ops[layout], dtype)
    x, x0, c = _inputs(op, C, dtype)
    args = {"spmm": (x,), "hop": (x, x0), "hop_c": (x, x0, c)}[mode]
    got = np.asarray(_kernel(op, *args), np.float32)
    want = np.asarray(_xla(op, mode, x, x0, c), np.float32)
    assert got.shape == (op.m_padded, C)
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)  # integer sums are exact
    elif dtype == "bfloat16":
        # Same float32 accumulation, another summation order, and one
        # bf16 rounding of the output (8-bit mantissa).
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("layout", ["uniform", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_donated_hop_matches(ops, dtype, layout):
    op = _typed(ops[layout], dtype)
    x, x0, _ = _inputs(op, 64, dtype, seed=1)
    want = np.asarray(_kernel(op, x, x0), np.float32)
    got = np.asarray(jax.jit(lambda a, b: _kernel(op, a, b, donate_x0=True))(
        x, x0), np.float32)
    np.testing.assert_array_equal(got, want)


def test_row_metadata_layouts(ops):
    """Uniform rows are (i * W, W); ragged rows walk each super-step's
    flat slab, covering the band exactly once."""
    uni, rag = ops["uniform"], ops["ragged"]
    n, W = uni.band.shape[:2]
    np.testing.assert_array_equal(np.asarray(uni.rows), uniform_rows(n, W))
    rows = ragged_rows(rag.sched, rag.levels, rag.rows_per_step)
    np.testing.assert_array_equal(np.asarray(rag.rows), rows)
    off, w = rows
    assert off[0] == 0 and np.all(off[1:] == off[:-1] + w[:-1])
    assert off[-1] + w[-1] == rag.band.shape[0]


def test_round_half_even_matches_jnp_round():
    grid = np.arange(-128, 128.5, 0.5, dtype=np.float32)
    y = np.concatenate([grid, np.nextafter(grid, 200), np.nextafter(grid,
                                                                    -200),
                        np.random.default_rng(0).uniform(-128, 128, 4096)
                        .astype(np.float32)])
    got = np.asarray(jax.jit(_round_half_even)(y))
    np.testing.assert_array_equal(got, np.round(y))


def test_int8_epilogue_is_quant_emit(ops):
    """The kernel's int8 epilogue equals ``quant_emit`` on the exact
    int32 accumulator, ties and saturation included."""
    q = _typed(ops["uniform"], "int8")
    x, x0, _ = _inputs(q, 48, "int8", seed=2)
    dense = np.zeros((q.m_padded, q.m_padded), np.int64)
    band = np.asarray(q.band)
    for i, b in enumerate(np.asarray(q.base)):
        for d in range(band.shape[1]):
            c0 = (b + d) * BS
            dense[i * BS:(i + 1) * BS, c0:c0 + BS] = band[i, d]
    acc = jnp.asarray(dense @ np.asarray(x, np.int64), jnp.int32)
    want = np.asarray(quant_emit(acc, q.band_scale, x0))
    np.testing.assert_array_equal(np.asarray(_kernel(q, x, x0)), want)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu):
    """On the card: the compiled kernel (no interpreter) against the XLA
    path at the city-graph shape, bf16 and int8."""
    from cnn_graph_tpu.ops import laplacian as lap

    L, _ = city_graph(64, k=8, seed=0)
    op = device_laplacian(L, fmt="banded", dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(op.m_padded, 256)), jnp.bfloat16)
    got = np.asarray(op.matmul(x), np.float32)
    want = np.asarray(lap.band_windows(
        op.band, op.base, op.sched, op.levels, op.rows_per_step,
        op.block_shape, x, jnp.float32), np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())
    q = quantize_banded(op, sample_x=3.0)
    xq = q.quantize(x.astype(jnp.float32))
    acc = lap.band_windows(q.band, q.base, q.sched, q.levels,
                           q.rows_per_step, q.block_shape, xq, jnp.int32)
    np.testing.assert_array_equal(np.asarray(q.spmm_q(xq)),
                                  np.asarray(quant_emit(acc, q.band_scale,
                                                        None)))
