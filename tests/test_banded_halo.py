"""Banded halo operator: ring-ppermute exchange + per-shard banded SpMM
against the dense single-device oracle (virtual 8-device CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnn_graph_tpu.data.synthetic import city_graph
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.ops import device_laplacian
from cnn_graph_tpu.parallel import banded_halo_laplacian, make_mesh


@pytest.fixture(scope="module")
def setup():
    L, _ = city_graph(40, k=8, seed=0)  # 1600 nodes, bandable
    mesh = make_mesh(data=2, nodes=4)
    op = banded_halo_laplacian(L, mesh)
    ref = device_laplacian(L, fmt="dense")
    return L, mesh, op, ref


class TestBandedHalo:
    def test_ragged_default_matches_uniform_exactly(self, setup):
        """The ragged per-shard layout (the default) and
        the uniform layout are the same blocks in the same order — their
        chains must agree to accumulation-order precision."""
        L, mesh, op, _ = setup
        assert op.levels, "ragged should be the sharded default"
        uni = banded_halo_laplacian(L, mesh, ragged=False)
        assert not uni.levels
        rng = np.random.default_rng(7)
        x = np.zeros((op.m_padded, 32), np.float32)
        x[: op.m] = rng.normal(size=(op.m, 32))
        with mesh:
            got_r = np.asarray(jax.jit(
                lambda o, v: o.cheby_chain(v, 5)
            )(op, jnp.asarray(x)))
            got_u = np.asarray(jax.jit(
                lambda o, v: o.cheby_chain(v, 5)
            )(uni, jnp.asarray(x)))
        np.testing.assert_allclose(got_r, got_u, atol=1e-5)

    def test_matmul_matches_dense(self, setup):
        L, mesh, op, ref = setup
        rng = np.random.default_rng(0)
        x = np.zeros((op.m_padded, 64), np.float32)
        x[: op.m] = rng.normal(size=(op.m, 64))
        xr = np.zeros((ref.m_padded, 64), np.float32)
        xr[: op.m] = x[: op.m]
        with mesh:
            got = np.asarray(
                jax.jit(lambda o, v: o.matmul(v))(op, jnp.asarray(x))
            )
        want = np.asarray(ref.matmul(jnp.asarray(xr)))
        np.testing.assert_allclose(got[: op.m], want[: op.m], atol=1e-4)
        np.testing.assert_allclose(got[op.m:], 0.0, atol=1e-5)

    def test_cheby_hop_matches_dense(self, setup):
        L, mesh, op, ref = setup
        rng = np.random.default_rng(1)
        x1 = np.zeros((op.m_padded, 32), np.float32)
        x1[: op.m] = rng.normal(size=(op.m, 32))
        x0 = np.zeros((op.m_padded, 32), np.float32)
        x0[: op.m] = rng.normal(size=(op.m, 32))
        x1r = np.zeros((ref.m_padded, 32), np.float32)
        x1r[: op.m] = x1[: op.m]
        x0r = np.zeros((ref.m_padded, 32), np.float32)
        x0r[: op.m] = x0[: op.m]
        with mesh:
            got = np.asarray(jax.jit(
                lambda o, a, b: o.cheby_hop(a, b)
            )(op, jnp.asarray(x1), jnp.asarray(x0)))
        want = np.asarray(ref.cheby_hop(jnp.asarray(x1r), jnp.asarray(x0r)))
        np.testing.assert_allclose(got[: op.m], want[: op.m], atol=1e-4)

    def test_gradients_match_dense(self, setup):
        L, mesh, op, ref = setup
        rng = np.random.default_rng(2)
        x = np.zeros((op.m_padded, 16), np.float32)
        x[: op.m] = rng.normal(size=(op.m, 16))
        xr = np.zeros((ref.m_padded, 16), np.float32)
        xr[: op.m] = x[: op.m]

        def f(o, v):
            return jnp.sum(o.cheby_hop(v, 0.5 * v) ** 2)

        with mesh:
            g = np.asarray(jax.jit(jax.grad(f, argnums=1))(op,
                                                           jnp.asarray(x)))
        gr = np.asarray(jax.grad(lambda v: f(ref, v))(jnp.asarray(xr)))
        np.testing.assert_allclose(g[: op.m], gr[: op.m],
                                   rtol=1e-3, atol=1e-4)

    def test_halo_extents_are_tight(self, setup):
        L, mesh, op, ref = setup
        nbr_s = op.rows_per_shard // 128
        assert 0 < op.halo_left <= nbr_s
        assert 0 <= op.halo_right <= nbr_s
        # The exchange moves only the halo rows, not whole shards.
        assert op.halo_left + op.halo_right < 2 * nbr_s

    def test_overlap_split_matches_unsplit(self, setup):
        """The interior/boundary split (exchange-compute overlap) must be
        bit-identical to the single-pass path: same per-row einsum slices,
        same float32 accumulation — only the dependency structure differs.
        """
        import dataclasses

        L, mesh, _op, ref = setup
        # rows_per_step=1 keeps the G-rounded boundary smaller than the
        # shard so the split actually engages at this test scale.
        op = banded_halo_laplacian(L, mesh, rows_per_step=1)
        assert op.overlap and (op.boundary_pre or op.boundary_suf), (
            op.boundary_pre, op.boundary_suf, op.overlap)
        flat = dataclasses.replace(op, overlap=False)

        rng = np.random.default_rng(7)
        x1 = jnp.asarray(rng.normal(size=(op.m_padded, 32)), jnp.float32)
        x0 = jnp.asarray(rng.normal(size=(op.m_padded, 32)), jnp.float32)

        def hop(o, a, b):
            return o.cheby_hop(a, b)

        def gfun(o, a, b):
            return jnp.sum(o.cheby_hop(a, b) ** 2)

        with mesh:
            split_y = np.asarray(jax.jit(hop)(op, x1, x0))
            unsplit_y = np.asarray(jax.jit(hop)(flat, x1, x0))
            split_g = np.asarray(jax.jit(jax.grad(gfun, 1))(op, x1, x0))
            unsplit_g = np.asarray(jax.jit(jax.grad(gfun, 1))(flat, x1, x0))
        np.testing.assert_array_equal(split_y, unsplit_y)
        np.testing.assert_array_equal(split_g, unsplit_g)
        # Dense oracle agreement too (not just self-consistency).
        want = np.asarray(ref.cheby_hop(x1[: ref.m_padded],
                                        x0[: ref.m_padded]))
        np.testing.assert_allclose(split_y[: op.m], want[: op.m], atol=1e-4)

    def test_too_many_shards_raises(self):
        # 8 shards over a graph whose band is wider than a shard.
        L, _ = city_graph(16, k=8, seed=0)  # 256 nodes -> 2 block rows
        mesh = make_mesh(data=1, nodes=8)
        with pytest.raises(ValueError):
            banded_halo_laplacian(L, mesh)

    def test_node_classifier_trains_through(self, setup):
        import optax

        from cnn_graph_tpu.models import NodeClassifier

        L, mesh, op, ref = setup
        rng = np.random.default_rng(3)
        m, mp = op.m, op.m_padded
        labels = (rng.random(mp) < 0.5).astype(np.int64)
        feats = np.zeros((mp, 8), np.float32)
        feats[:m] = labels[:m, None] + 0.3 * rng.normal(size=(m, 8))
        mask = np.zeros(mp, bool)
        mask[:m] = True

        model = NodeClassifier(op, input_features=8, num_classes=2,
                               hidden=[8], K=3, dropout=1.0)
        params = model.init(jax.random.PRNGKey(0))
        opt = optax.adam(1e-2)
        state = opt.init(params)

        @jax.jit
        def step(op, params, state, x, y, msk):
            import functools

            from cnn_graph_tpu.models import common as mcommon

            mdl = mcommon.with_graph_arrays(model, {"op": op})
            loss, grads = jax.value_and_grad(mdl.loss)(params, x, y, msk)
            updates, state = opt.update(grads, state, params)
            return optax.apply_updates(params, updates), state, loss

        x = jnp.asarray(feats)
        y = jnp.asarray(labels)
        msk = jnp.asarray(mask)
        losses = []
        with mesh:
            for _ in range(20):
                params, state, loss = step(op, params, state, x, y, msk)
                losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.5, losses


class TestChebyChain:
    """The whole K-hop recurrence under ONE shard_map region
    (cheby_chain): bit-exact with the per-hop path, differentiable via
    the adjoint-recurrence VJP, and dispatched by ops.cheby_basis."""

    def test_chain_bitexact_vs_per_hop(self, setup):
        _L, mesh, op, _ref = setup
        rng = np.random.default_rng(20)
        K = 7
        x = jnp.asarray(rng.normal(size=(op.m_padded, 32)), jnp.float32)

        def per_hop(o, v):
            b = [v, o.matmul(v)]
            for _ in range(2, K):
                b.append(o.cheby_hop(b[-1], b[-2]))
            return jnp.stack(b)

        with mesh:
            got = np.asarray(jax.jit(
                lambda o, v: o.cheby_chain(v, K))(op, x))
            want = np.asarray(jax.jit(per_hop)(op, x))
        np.testing.assert_array_equal(got, want)

    def test_chain_grad_matches_per_hop_autodiff(self, setup):
        _L, mesh, op, _ref = setup
        rng = np.random.default_rng(21)
        K = 6
        x = jnp.asarray(rng.normal(size=(op.m_padded, 16)), jnp.float32)
        t = jnp.asarray(rng.normal(size=(K, op.m_padded, 16)), jnp.float32)

        def loss_chain(v):
            return jnp.sum(op.cheby_chain(v, K) * t)

        def loss_hops(v):
            b = [v, op.matmul(v)]
            for _ in range(2, K):
                b.append(op.cheby_hop(b[-1], b[-2]))
            return jnp.sum(jnp.stack(b) * t)

        with mesh:
            g_chain = np.asarray(jax.jit(jax.grad(loss_chain))(x))
            g_hops = np.asarray(jax.jit(jax.grad(loss_hops))(x))
        np.testing.assert_allclose(g_chain, g_hops, atol=2e-4, rtol=1e-5)

    @pytest.mark.parametrize("K", [1, 2, 3])
    def test_chain_small_K_edge_cases(self, setup, K):
        _L, mesh, op, _ref = setup
        rng = np.random.default_rng(22)
        x = jnp.asarray(rng.normal(size=(op.m_padded, 8)), jnp.float32)
        t = jnp.asarray(rng.normal(size=(K, op.m_padded, 8)), jnp.float32)

        def per_hop(v):
            b = [v]
            if K > 1:
                b.append(op.matmul(v))
            for _ in range(2, K):
                b.append(op.cheby_hop(b[-1], b[-2]))
            return jnp.stack(b)

        with mesh:
            got = np.asarray(jax.jit(
                lambda v: op.cheby_chain(v, K))(x))
            want = np.asarray(jax.jit(per_hop)(x))
            g1 = np.asarray(jax.jit(jax.grad(
                lambda v: jnp.sum(op.cheby_chain(v, K) * t)))(x))
            g2 = np.asarray(jax.jit(jax.grad(
                lambda v: jnp.sum(per_hop(v) * t)))(x))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(g1, g2, atol=2e-4, rtol=1e-5)

    def test_cheby_basis_dispatches_chain(self, setup):
        """ops.cheby_basis must produce identical values through the
        one-region chain as the dense single-chip reference."""
        from cnn_graph_tpu.ops import cheby_basis

        _L, mesh, op, ref = setup
        rng = np.random.default_rng(23)
        K = 5
        x = np.zeros((1, op.m, 3), np.float32)
        x[0, : op.m] = rng.normal(size=(op.m, 3))
        with mesh:
            got = np.asarray(jax.jit(
                lambda o, v: cheby_basis(v, o, K))(op, jnp.asarray(x)))
        want = np.asarray(jax.jit(
            lambda o, v: cheby_basis(v, o, K))(ref, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_quant_chain_bitexact_vs_per_hop(self, setup):
        from cnn_graph_tpu.parallel import quantize_banded_halo

        _L, mesh, op, _ref = setup
        qop = quantize_banded_halo(op, sample_x=3.0)
        rng = np.random.default_rng(24)
        K = 6
        xq = jnp.asarray(
            rng.integers(-100, 100, (op.m_padded, 16)).astype(np.int8))

        def per_hop(o, v):
            b = [v, o.spmm_q(v)]
            for _ in range(2, K):
                b.append(o.cheby_hop_q(b[-1], b[-2]))
            return jnp.stack(b)

        with mesh:
            got = np.asarray(jax.jit(
                lambda o, v: o.cheby_chain_q(v, K))(qop, xq))
            want = np.asarray(jax.jit(per_hop)(qop, xq))
        np.testing.assert_array_equal(got, want)


class TestQuantBandedHalo:
    """Int8 multi-chip serving: the quantized sharded operator
    (parallel.banded_halo.QuantBandedHaloLaplacian; DESIGN.md §11).
    The halo ppermutes carry int8 payloads — half the bf16 operator's
    bytes per hop."""

    def test_chain_bitexact_vs_single_chip(self, setup):
        """The sharded int8 recurrence runs the same integer arithmetic
        as the single-chip QuantBandedLaplacian: int32 window taps,
        identical dequant/requant emission — so a K-hop chain of int8
        carries must be BIT-exact with the single-chip chain."""
        from cnn_graph_tpu.ops import quantize_banded
        from cnn_graph_tpu.parallel import quantize_banded_halo

        L, mesh, op, ref = setup
        qop = quantize_banded_halo(op, sample_x=3.0)
        sop = device_laplacian(L, fmt="banded",
                               dtype=jnp.float32)
        sq = quantize_banded(sop, sample_x=3.0)
        assert np.isclose(qop.band_scale, sq.band_scale, rtol=1e-6)

        rng = np.random.default_rng(11)
        mp = max(op.m_padded, sq.m_padded)
        xq = rng.integers(-100, 100, (mp, 32)).astype(np.int8)
        xq[op.m:] = 0

        def chain(q, x, K=9):
            b = [x, q.spmm_q(x)]
            for _ in range(2, K):
                b.append(q.cheby_hop_q(b[-1], b[-2]))
            return jnp.stack(b)

        with mesh:
            got = np.asarray(
                jax.jit(chain)(qop, jnp.asarray(xq[: op.m_padded]))
            )
        want = np.asarray(jax.jit(chain)(sq, jnp.asarray(xq[: sq.m_padded])))
        np.testing.assert_array_equal(got[:, : op.m], want[:, : op.m])

    def test_overlap_split_matches_unsplit_int8(self, setup):
        """The exchange-compute overlap split must stay bit-exact on the
        quantized path (requantization happens per row, so the split
        cannot change any emitted value)."""
        import dataclasses

        from cnn_graph_tpu.parallel import quantize_banded_halo

        L, mesh, _op, ref = setup
        op = banded_halo_laplacian(L, mesh, rows_per_step=1)
        qop = quantize_banded_halo(op, sample_x=3.0)
        assert qop.overlap and (qop.boundary_pre or qop.boundary_suf)
        flat = dataclasses.replace(qop, overlap=False)

        rng = np.random.default_rng(13)
        x1 = jnp.asarray(
            rng.integers(-100, 100, (op.m_padded, 16)).astype(np.int8))
        x0 = jnp.asarray(
            rng.integers(-100, 100, (op.m_padded, 16)).astype(np.int8))
        with mesh:
            split_y = np.asarray(jax.jit(
                lambda o, a, b: o.cheby_hop_q(a, b))(qop, x1, x0))
            unsplit_y = np.asarray(jax.jit(
                lambda o, a, b: o.cheby_hop_q(a, b))(flat, x1, x0))
        np.testing.assert_array_equal(split_y, unsplit_y)

    def test_cheby_conv_and_model_serving(self, setup):
        """cheby_conv dispatches on the quant protocol for the SHARDED
        operator, and quantize_model_operators converts a NodeClassifier
        over a banded-halo op in one call with a small accuracy cost."""
        from cnn_graph_tpu.models import NodeClassifier, common
        from cnn_graph_tpu.ops import cheby_conv
        from cnn_graph_tpu.parallel import QuantBandedHaloLaplacian

        L, mesh, op, ref = setup
        rng = np.random.default_rng(17)
        K, Fin, Fout = 6, 16, 8
        x = np.zeros((1, op.m_padded, Fin), np.float32)
        x[:, : op.m] = rng.normal(size=(1, op.m, Fin))
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.2, jnp.float32)

        model = NodeClassifier(op, input_features=Fin, num_classes=4,
                               hidden=[8], K=4)
        params = model.init(jax.random.PRNGKey(0))
        qmodel = common.quantize_model_operators(model, sample_x=3.0)
        assert isinstance(qmodel.op, QuantBandedHaloLaplacian)

        xr = np.zeros((1, ref.m_padded, Fin), np.float32)
        xr[:, : op.m] = x[:, : op.m]
        want = np.asarray(jax.jit(cheby_conv)(jnp.asarray(xr), ref, w))
        with mesh:
            got = np.asarray(
                jax.jit(cheby_conv)(jnp.asarray(x), qmodel.op, w))
            y_f = np.asarray(jax.jit(model.apply)(
                params, jnp.asarray(x[0])))
            y_q = np.asarray(jax.jit(qmodel.apply)(
                params, jnp.asarray(x[0])))
        rel = (np.linalg.norm(got[:, : op.m] - want[:, : op.m])
               / np.linalg.norm(want[:, : op.m]))
        assert rel < 0.12, rel
        rel_m = np.linalg.norm(y_q - y_f) / np.linalg.norm(y_f)
        assert rel_m < 0.15, rel_m

    def test_halo_payload_is_int8(self, setup):
        """The exchanged halo must be int8 (half the bf16 bytes on the
        neighbour exchange): check the ppermute operand dtype in the jaxpr."""
        from cnn_graph_tpu.parallel import quantize_banded_halo

        L, mesh, op, ref = setup
        qop = quantize_banded_halo(op, sample_x=3.0)
        x = jnp.zeros((op.m_padded, 16), jnp.int8)
        with mesh:
            jaxpr = jax.make_jaxpr(
                lambda o, v: o.spmm_q(v))(qop, x)
        perms = [e for e in str(jaxpr).split("\n") if "ppermute" in e]
        assert perms, "no ppermute in the quantized sharded spmm"
        assert all("i8[" in p for p in perms), perms
