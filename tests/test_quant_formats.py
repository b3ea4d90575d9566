"""Every single-chip format and its int8 twin against SciPy / each other.

The reference's flagship classification topology (20NEWS embedding-kNN,
lib/utils.py:127-150 + 20news.ipynb cell 22) auto-serves as a DENSE
operator; scattered graphs above the dense budget land on BSR; planar
graphs on the banded format.  These tests pin each format's XLA path to
the SciPy product and each int8 twin's integer arithmetic to the dense
twin (bit-exact: integer sums are exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.ops import (
    cheby_conv,
    cheby_finals,
    device_laplacian,
    quantize_banded,
    quantize_block_sparse,
    quantize_dense,
)


@pytest.fixture(scope="module")
def scattered_graph():
    """A small embedding-kNN-style scattered graph (the 20NEWS topology
    shape in miniature): random points in 8-D, k=10, RCM-ordered — wide
    band, substantial block occupancy."""
    rng = np.random.default_rng(0)
    z = rng.normal(size=(900, 8)).astype(np.float32)
    dist, idx = gc.knn(z, k=10, algorithm="auto")
    W = gc.adjacency(dist, idx)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return gc.laplacian(W, normalized=True)


@pytest.fixture(scope="module")
def bsr_op(scattered_graph):
    return device_laplacian(scattered_graph, fmt="bsr", block_size=128)


FORMATS = {
    "dense": dict(fmt="dense"),
    "bsr": dict(fmt="bsr", block_size=128),
    "bsr32": dict(fmt="bsr", block_size=32),
    "bcoo": dict(fmt="bcoo"),
    "banded": dict(fmt="banded"),
    "banded_uniform": dict(fmt="banded", ragged=False),
    "banded32": dict(fmt="banded", block_size=32),
}


class TestFormatsAgainstScipy:
    @pytest.mark.parametrize("mode", ["spmm", "hop"])
    @pytest.mark.parametrize("name", sorted(FORMATS))
    def test_xla_path_matches_scipy(self, scattered_graph, name, mode):
        op = device_laplacian(scattered_graph, **FORMATS[name])
        Lr = gc.rescale_laplacian(scattered_graph, 2.0)
        rng = np.random.default_rng(1)
        x = np.zeros((op.m_padded, 24), np.float32)
        x[: op.m] = rng.normal(size=(op.m, 24))
        x0 = rng.normal(size=x.shape).astype(np.float32)
        if mode == "spmm":
            got = jax.jit(lambda o, v: o.matmul(v))(op, jnp.asarray(x))
            want = Lr @ x[: op.m]
        else:
            got = jax.jit(lambda o, v, w: o.cheby_hop(v, w))(
                op, jnp.asarray(x), jnp.asarray(x0))
            want = 2.0 * (Lr @ x[: op.m]) - x0[: op.m]
        got = np.asarray(got)
        assert got.shape == x.shape
        np.testing.assert_allclose(got[: op.m], want, atol=1e-4)


TWINS = {
    "bsr": lambda L: quantize_block_sparse(
        device_laplacian(L, fmt="bsr", block_size=128), sample_x=3.0),
    "banded": lambda L: quantize_banded(
        device_laplacian(L, fmt="banded"), sample_x=3.0),
    "banded_uniform": lambda L: quantize_banded(
        device_laplacian(L, fmt="banded", ragged=False), sample_x=3.0),
}


class TestInt8Twins:
    def test_dense_twin_matches_integer_reference(self, scattered_graph):
        """The dense twin against a NumPy restatement of its arithmetic:
        exact int32 sum, float32 dequantise, hop update, round half to
        even, saturate."""
        q = quantize_dense(device_laplacian(scattered_graph, fmt="dense"),
                           sample_x=3.0)
        rng = np.random.default_rng(2)
        xq = rng.integers(-127, 128, (q.m_padded, 16)).astype(np.int8)
        x0q = rng.integers(-127, 128, (q.m_padded, 16)).astype(np.int8)
        acc = np.asarray(q.mat).astype(np.int64) @ xq.astype(np.int64)
        y = np.float32(q.mat_scale) * acc.astype(np.float32)
        y = np.float32(2.0) * y - x0q.astype(np.float32)
        want = np.clip(np.round(y), -127, 127).astype(np.int8)
        got = np.asarray(jax.jit(lambda o, a, b: o.cheby_hop_q(a, b))(
            q, jnp.asarray(xq), jnp.asarray(x0q)))
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("mode", ["spmm", "hop"])
    @pytest.mark.parametrize("name", sorted(TWINS))
    def test_twin_bit_exact_with_dense_twin(self, scattered_graph, name,
                                            mode):
        qd = quantize_dense(device_laplacian(scattered_graph, fmt="dense"),
                            sample_x=3.0)
        q = TWINS[name](scattered_graph)
        assert q.act_scale == qd.act_scale
        rng = np.random.default_rng(3)
        mp = max(q.m_padded, qd.m_padded)
        xq = np.zeros((mp, 16), np.int8)
        xq[: q.m] = rng.integers(-127, 128, (q.m, 16))
        x0q = rng.integers(-127, 128, (mp, 16)).astype(np.int8)

        def run(o):
            a = jnp.asarray(xq[: o.m_padded])
            if mode == "spmm":
                return np.asarray(jax.jit(lambda o, a: o.spmm_q(a))(o, a))
            b = jnp.asarray(x0q[: o.m_padded])
            return np.asarray(jax.jit(
                lambda o, a, b: o.cheby_hop_q(a, b))(o, a, b))

        np.testing.assert_array_equal(run(q)[: q.m], run(qd)[: q.m])


class TestQuantBlockSparse:
    def test_conv_protocol_tracks_f32(self, bsr_op):
        op_xla = bsr_op
        q = quantize_block_sparse(bsr_op, sample_x=3.0)
        rng = np.random.default_rng(5)
        K, Fin, Fout = 5, 8, 6
        x = jnp.asarray(rng.normal(size=(2, q.m, Fin)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.2, jnp.float32)
        yq = np.asarray(cheby_conv(x, q, w))
        yf = np.asarray(cheby_conv(x, op_xla, w))
        rel = np.abs(yq - yf).max() / (np.abs(yf).max() + 1e-9)
        assert rel < 0.08, rel

    def test_chain_protocol(self, bsr_op):
        """cheby_finals dispatches on cheby_hop_q for the BSR twin."""
        q = quantize_block_sparse(bsr_op, sample_x=3.0)
        rng = np.random.default_rng(6)
        X = jnp.asarray(rng.normal(size=(q.m_padded, 128)), jnp.float32)
        out = cheby_finals(q, q.quantize(X), 6)
        assert out.dtype == jnp.int8
        assert np.isfinite(np.asarray(q.dequantize(out))).all()


def hub_graph(n=1024, seed=0):
    """A ring plus one hub joined to every node: the hub's block row
    touches every column block, every other row two or three."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    i = np.arange(n)
    rows = np.concatenate([i, np.zeros(n - 1, int)])
    cols = np.concatenate([(i + 1) % n, np.arange(1, n)])
    w = rng.uniform(0.5, 1.5, len(rows))
    W = sp.coo_matrix((w, (rows, cols)), shape=(n, n)).tocsr()
    return gc.laplacian(W + W.T, normalized=True)


class TestGroupedBsr:
    """The BSR layout groups block rows by tile count, so a skewed graph
    stores under 1.5x its nonzero tiles (padding every row to the
    longest would store nearly the dense matrix)."""

    @pytest.mark.parametrize("c", [0, 1, 2, 3, 5, 7, 12, 13, 100, 1000])
    def test_tile_levels_bound(self, c):
        from cnn_graph_tpu.ops.laplacian import tile_levels

        (lv,) = tile_levels([c])
        assert max(c, 1) <= lv < 1.5 * max(c, 1) or lv == max(c, 1)

    def test_tile_levels_are_few(self):
        from cnn_graph_tpu.ops.laplacian import tile_levels

        k = 1000
        assert len(np.unique(tile_levels(np.arange(1, k + 1)))) <= (
            2 * np.log2(k) + 1)

    @pytest.mark.parametrize("block", [16, 32])
    def test_hub_graph_storage_and_product(self, block):
        L = hub_graph()
        op = device_laplacian(L, fmt="bsr", block_size=block)
        n_rb = op.m_padded // block
        assert op.blocks.shape[0] < 1.5 * op.n_tiles
        assert op.blocks.shape[0] < n_rb * n_rb / 4  # far from dense
        assert len(op.groups) >= 2
        x = np.random.default_rng(1).normal(size=(op.m_padded, 8))
        got = np.asarray(jax.jit(lambda o, v: o.matmul(v))(
            op, jnp.asarray(x, jnp.float32)))
        want = gc.rescale_laplacian(L, 2.0) @ x[: op.m]
        np.testing.assert_allclose(got[: op.m], want, atol=1e-4)

    def test_shared_groups_rebuild_each_matrix(self):
        """Several matrices under one group list (the sharded operator's
        packing): each is rebuilt exactly from its own rows."""
        from cnn_graph_tpu.ops.laplacian import (
            pack_block_sparse,
            pack_bsr_groups,
        )

        mats = [gc.rescale_laplacian(hub_graph(256, s), 2.0) for s in (0, 1)]
        mats[1] = mats[1][::-1]  # the hub row last: other row counts
        bs = 16
        csrs = [pack_block_sparse(m, (bs, bs))[:4] for m in mats]
        blocks, cols, row_pos, groups = pack_bsr_groups(csrs)
        for s, m in enumerate(mats):
            assert sorted(row_pos[s]) == list(range(256 // bs))
            dense = np.zeros((256, 256))
            off, r0 = 0, 0
            for rows, k in groups:
                for r in range(rows):
                    (i,) = np.nonzero(row_pos[s] == r0 + r)[0]
                    for t in range(k):
                        c = cols[s, off + r * k + t]
                        dense[i * bs:(i + 1) * bs, c * bs:(c + 1) * bs] += (
                            blocks[s, off + r * k + t])
                off += rows * k
                r0 += rows
            np.testing.assert_allclose(dense, m.toarray(), atol=1e-6)
        assert [k for _, k in groups] == sorted(
            {k for _, k in groups}, reverse=True)

    def test_int8_twin_on_hub_graph(self):
        op = device_laplacian(hub_graph(), fmt="bsr", block_size=32)
        q = quantize_block_sparse(op, sample_x=3.0)
        x = np.random.default_rng(2).normal(size=(op.m_padded, 16))
        y = np.asarray(q.matmul(jnp.asarray(x, jnp.float32)))
        yf = np.asarray(op.matmul(jnp.asarray(x, jnp.float32)))
        assert np.abs(y - yf).max() / np.abs(yf).max() < 0.08


class TestQuantDense:
    def test_float_view_and_conv(self, scattered_graph):
        op = device_laplacian(scattered_graph, fmt="dense")
        q = quantize_dense(op, sample_x=3.0)
        rng = np.random.default_rng(7)
        X = jnp.asarray(rng.normal(size=(op.m_padded, 64)), jnp.float32)
        f32 = np.asarray(op.matmul(X))
        qv = np.asarray(q.matmul(X))
        rel = np.abs(qv - f32).max() / (np.abs(f32).max() + 1e-9)
        assert rel < 0.05, rel

        K, Fin, Fout = 5, 8, 6
        x = jnp.asarray(rng.normal(size=(2, op.m, Fin)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.2, jnp.float32)
        yq = np.asarray(cheby_conv(x, q, w))
        yf = np.asarray(cheby_conv(x, op, w))
        rel = np.abs(yq - yf).max() / (np.abs(yf).max() + 1e-9)
        assert rel < 0.08, rel

    def test_matches_bsr_twin_semantics(self, scattered_graph, bsr_op):
        """Dense and BSR twins quantize the same matrix with the same
        scale recipe — their int8 chains must agree closely (they differ
        only in which structural zeros are materialized)."""
        opd = device_laplacian(scattered_graph, fmt="dense")
        qd = quantize_dense(opd, sample_x=3.0)
        qb = quantize_block_sparse(bsr_op, sample_x=3.0)
        assert abs(qd.mat_scale - qb.block_scale) < 1e-12
        rng = np.random.default_rng(8)
        X = jnp.asarray(rng.normal(size=(qb.m_padded, 64)), jnp.float32)
        xq = qb.quantize(X)
        a = np.asarray(qd.spmm_q(xq[: qd.m_padded]))
        b = np.asarray(qb.spmm_q(xq))
        assert np.array_equal(a[: qd.m], b[: qd.m])


class TestServingEntryPoint:
    def test_quantize_model_operators_covers_dense_and_bsr(
            self, scattered_graph):
        from cnn_graph_tpu.models import NodeClassifier
        from cnn_graph_tpu.models.common import quantize_model_operators
        from cnn_graph_tpu.ops.laplacian import (
            QuantBlockSparseLaplacian,
            QuantDenseLaplacian,
        )

        for fmt, twin in (("dense", QuantDenseLaplacian),
                          ("bsr", QuantBlockSparseLaplacian)):
            op = device_laplacian(scattered_graph, fmt=fmt)
            model = NodeClassifier(op, input_features=8, num_classes=4,
                                   hidden=[], K=5)
            qm = quantize_model_operators(model, sample_x=3.0)
            assert isinstance(qm.op, twin), (fmt, type(qm.op))
            rng = np.random.default_rng(9)
            x = jnp.asarray(rng.normal(size=(op.m, 8)), jnp.float32)
            params = model.init(jax.random.PRNGKey(0))
            lf = np.asarray(model.apply(params, x))
            lq = np.asarray(qm.apply(params, x))
            agree = (lf.argmax(1) == lq.argmax(1)).mean()
            assert agree > 0.95, (fmt, agree)

    def test_auto_dense_scattered_graph_serves_quantized(
            self, scattered_graph):
        """The 20NEWS-shape story end to end: fmt='auto' on a block-dense
        scattered graph picks DENSE (DESIGN.md §14), and the serving
        entry point now quantizes it instead of passing it through."""
        from cnn_graph_tpu.models import NodeClassifier
        from cnn_graph_tpu.models.common import quantize_model_operators
        from cnn_graph_tpu.ops.laplacian import (
            DenseLaplacian,
            QuantDenseLaplacian,
        )

        op = device_laplacian(scattered_graph, fmt="auto",
                              dense_threshold=256)
        if not isinstance(op, DenseLaplacian):
            pytest.skip("auto did not pick dense for this fixture")
        model = NodeClassifier(op, input_features=8, num_classes=4,
                               hidden=[], K=5)
        qm = quantize_model_operators(model, sample_x=3.0)
        assert isinstance(qm.op, QuantDenseLaplacian)
