"""Node classification + sparse halo operator tests (ogbn-style path)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import NodeClassifier
from cnn_graph_tpu.ops import device_laplacian
from cnn_graph_tpu.parallel import make_mesh, sparse_halo_laplacian


@pytest.fixture(scope="module")
def community_graph():
    """Planted-partition graph: 4 communities, labels = community id —
    the canonical transductive node-classification testbed."""
    rng = np.random.default_rng(0)
    n_per, k = 64, 4
    centers = rng.normal(0, 5, (k, 8))
    z = np.concatenate(
        [centers[c] + rng.normal(0, 1, (n_per, 8)) for c in range(k)]
    ).astype(np.float32)
    labels = np.repeat(np.arange(k), n_per)
    order = rng.permutation(len(labels))
    z, labels = z[order], labels[order]
    W = gc.knn_graph(z, k=6)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    z, labels = z[perm], labels[perm]
    L = gc.laplacian(W, normalized=True)
    features = jnp.asarray(z)
    return L, features, jnp.asarray(labels)


class TestNodeClassifier:
    def test_shapes_and_masked_loss(self, community_graph):
        L, features, labels = community_graph
        op = device_laplacian(L, fmt="dense")
        model = NodeClassifier(op, input_features=8, num_classes=4,
                               hidden=[16], K=3)
        params = model.init(jax.random.PRNGKey(0))
        logits = model.apply(params, features)
        assert logits.shape == (features.shape[0], 4)

        mask = jnp.arange(features.shape[0]) < 100
        l_masked = model.loss(params, features, labels, mask)
        l_full = model.loss(params, features, labels)
        assert float(l_masked) > 0 and float(l_full) > 0
        assert not np.isclose(float(l_masked), float(l_full))

    def test_transductive_training(self, community_graph):
        L, features, labels = community_graph
        op = device_laplacian(L, fmt="dense")
        model = NodeClassifier(op, input_features=8, num_classes=4,
                               hidden=[32], K=3, dropout=0.8)
        params = model.init(jax.random.PRNGKey(1))
        n = features.shape[0]
        rng = np.random.default_rng(2)
        train_mask = jnp.asarray(rng.random(n) < 0.3)
        test_mask = ~train_mask

        opt = optax.adam(1e-2)
        state = opt.init(params)

        @jax.jit
        def step(params, state, key):
            loss, grads = jax.value_and_grad(model.loss)(
                params, features, labels, train_mask, train=True, rng=key
            )
            updates, state = opt.update(grads, state, params)
            return optax.apply_updates(params, updates), state, loss

        key = jax.random.PRNGKey(3)
        for _ in range(150):
            key, sk = jax.random.split(key)
            params, state, loss = step(params, state, sk)

        acc = float(model.accuracy(params, features, labels, test_mask))
        assert acc > 0.85, acc  # communities are cleanly separable


class TestSparseHaloLaplacian:
    @pytest.mark.parametrize("nodes", [2, 4])
    def test_matmul_matches_dense(self, community_graph, nodes):
        L, _, _ = community_graph
        mesh = make_mesh(data=8 // nodes, nodes=nodes)
        sp = sparse_halo_laplacian(L, mesh, block_shape=(8, 8))
        dense = device_laplacian(L, fmt="dense")

        rng = np.random.default_rng(1)
        X = rng.normal(size=(sp.m_padded, 16)).astype(np.float32)
        X[sp.m:] = 0
        with mesh:
            got = np.asarray(jax.jit(sp.matmul)(jnp.asarray(X)))
        Xd = np.zeros((dense.m_padded, 16), np.float32)
        Xd[: dense.m] = X[: dense.m]
        want = np.asarray(dense.matmul(jnp.asarray(Xd)))
        np.testing.assert_allclose(got[: sp.m], want[: sp.m], atol=1e-4)

    def test_node_classifier_over_sparse_halo(self, community_graph):
        L, features, labels = community_graph
        mesh = make_mesh(data=4, nodes=2)
        sp = sparse_halo_laplacian(L, mesh, block_shape=(8, 8))
        dense = device_laplacian(L, fmt="dense")

        model_sp = NodeClassifier(sp, input_features=8, num_classes=4,
                                  hidden=[16], K=3)
        model_d = NodeClassifier(dense, input_features=8, num_classes=4,
                                 hidden=[16], K=3)
        params = model_d.init(jax.random.PRNGKey(0))

        # Features padded to the sharded operator's node count.
        fp = jnp.zeros((sp.m_padded, 8)).at[: sp.m].set(features)
        with mesh:
            logits_sp = np.asarray(
                jax.jit(model_sp.apply)(params, fp)
            )[: sp.m]
        logits_d = np.asarray(model_d.apply(params, features))
        np.testing.assert_allclose(logits_sp, logits_d, atol=1e-4)

    def test_memory_is_blocks_not_dense(self, community_graph):
        L, _, _ = community_graph
        mesh = make_mesh(data=2, nodes=4)
        sp = sparse_halo_laplacian(L, mesh, block_shape=(8, 8))
        dense_entries = sp.m_padded * (sp.rows_per_shard + 4 * sp.halo)
        sparse_entries = int(np.prod(sp.blocks.shape))
        assert sparse_entries < dense_entries


class TestBandedSparseHalo:
    """Per-shard banded sparse-halo (fmt='banded'): same exchange plan
    as BSR, banded pass per shard after a private column ordering."""

    @pytest.mark.parametrize("nodes", [2, 4])
    def test_matmul_and_hop_match_dense(self, community_graph, nodes):
        L, _, _ = community_graph
        mesh = make_mesh(data=8 // nodes, nodes=nodes)
        sp = sparse_halo_laplacian(L, mesh, block_shape=(8, 8),
                                   fmt="banded")
        from cnn_graph_tpu.parallel import BandedSparseHaloLaplacian

        assert isinstance(sp, BandedSparseHaloLaplacian)
        dense = device_laplacian(L, fmt="dense")

        rng = np.random.default_rng(2)
        X = rng.normal(size=(sp.m_padded, 16)).astype(np.float32)
        X[sp.m:] = 0
        X0 = rng.normal(size=(sp.m_padded, 16)).astype(np.float32)
        with mesh:
            got = np.asarray(jax.jit(sp.matmul)(jnp.asarray(X)))
            got_hop = np.asarray(jax.jit(sp.cheby_hop)(
                jnp.asarray(X), jnp.asarray(X0)))
        Xd = np.zeros((dense.m_padded, 16), np.float32)
        Xd[: dense.m] = X[: dense.m]
        want = np.asarray(dense.matmul(jnp.asarray(Xd)))
        np.testing.assert_allclose(got[: sp.m], want[: sp.m], atol=1e-4)
        np.testing.assert_allclose(
            got_hop[: sp.m], 2.0 * want[: sp.m] - X0[: sp.m], atol=1e-4)

    def test_gradients_symmetric_adjoint(self, community_graph):
        L, _, _ = community_graph
        mesh = make_mesh(data=4, nodes=2)
        sp = sparse_halo_laplacian(L, mesh, block_shape=(8, 8),
                                   fmt="banded")
        rng = np.random.default_rng(3)
        X = jnp.asarray(rng.normal(size=(sp.m_padded, 8)), jnp.float32)

        with mesh:
            g = jax.grad(lambda v: jnp.sum(sp.matmul(v) ** 2))(X)
            want = 2.0 * sp.matmul(sp.matmul(X))  # L symmetric
            np.testing.assert_allclose(np.asarray(g), np.asarray(want),
                                       atol=1e-3)

    def test_auto_falls_back_to_bsr_when_wide(self, community_graph):
        """A shard whose extended matrix cannot band within the width cap
        must come back as the BSR operator under fmt='auto'."""
        L, _, _ = community_graph
        mesh = make_mesh(data=4, nodes=2)
        from cnn_graph_tpu.parallel import SparseHaloLaplacian

        sp = sparse_halo_laplacian(L, mesh, block_shape=(8, 8),
                                   fmt="auto", max_band_width=1)
        assert isinstance(sp, SparseHaloLaplacian)
        with pytest.raises(ValueError, match="band width"):
            sparse_halo_laplacian(L, mesh, block_shape=(8, 8),
                                  fmt="banded", max_band_width=1)


class TestQuantSparseHalo:
    """Int8 twins of the sparse-halo operators (DESIGN.md §11): same
    exchange plan, int8 carries over the all_to_all halo, integer
    arithmetic identical to the single-chip quantized chain."""

    def _single_chip_chain(self, L, xq_full, K):
        from cnn_graph_tpu.ops import quantize_banded

        sop = device_laplacian(L, fmt="banded",
                               dtype=jnp.float32)
        sq = quantize_banded(sop, sample_x=3.0)

        def chain(q, x):
            b = [x, q.spmm_q(x)]
            for _ in range(2, K):
                b.append(q.cheby_hop_q(b[-1], b[-2]))
            return jnp.stack(b)

        want = np.asarray(
            jax.jit(chain)(sq, jnp.asarray(xq_full[: sq.m_padded])))
        return sq, chain, want

    @pytest.mark.parametrize("fmt", ["bsr", "banded"])
    def test_chain_bitexact_vs_single_chip(self, community_graph, fmt):
        from cnn_graph_tpu.parallel import quantize_sparse_halo

        L, _, _ = community_graph
        mesh = make_mesh(data=4, nodes=2)
        sp = sparse_halo_laplacian(L, mesh, block_shape=(8, 8), fmt=fmt)
        qsp = quantize_sparse_halo(sp, sample_x=3.0)

        rng = np.random.default_rng(21)
        K = 7
        mp = max(sp.m_padded, 512)
        xq = rng.integers(-100, 100, (mp, 16)).astype(np.int8)
        xq[sp.m:] = 0
        sq, chain, want = self._single_chip_chain(L, xq, K)
        assert np.isclose(qsp.band_scale, sq.band_scale, rtol=1e-6)
        with mesh:
            got = np.asarray(
                jax.jit(chain)(qsp, jnp.asarray(xq[: sp.m_padded])))
        np.testing.assert_array_equal(got[:, : sp.m], want[:, : sp.m])

    def test_quantize_model_operators_handles_sparse_halo(
            self, community_graph):
        from cnn_graph_tpu.models import common
        from cnn_graph_tpu.parallel import (
            QuantBandedSparseHaloLaplacian,
            QuantSparseHaloLaplacian,
        )

        L, features, _ = community_graph
        mesh = make_mesh(data=4, nodes=2)
        for fmt, qcls in (("bsr", QuantSparseHaloLaplacian),
                          ("banded", QuantBandedSparseHaloLaplacian)):
            sp = sparse_halo_laplacian(L, mesh, block_shape=(8, 8),
                                       fmt=fmt)
            model = NodeClassifier(sp, input_features=8, num_classes=4,
                                   hidden=[16], K=3)
            params = model.init(jax.random.PRNGKey(0))
            qmodel = common.quantize_model_operators(model, sample_x=5.0)
            assert isinstance(qmodel.op, qcls)

            fp = jnp.zeros((sp.m_padded, 8)).at[: sp.m].set(features)
            with mesh:
                y_f = np.asarray(jax.jit(model.apply)(params, fp))
                y_q = np.asarray(jax.jit(qmodel.apply)(params, fp))
            rel = np.linalg.norm(y_q - y_f) / np.linalg.norm(y_f)
            assert rel < 0.15, (fmt, rel)
