"""Int8 serving path, end to end: the quantized operator plugged into
``ops.cheby_conv`` (dynamic runtime activation scale) and through the
user-facing models — NodeClassifier and ChebNet inference must track
their f32 results within serving tolerances (DESIGN.md §11).  The reference's serving hot path is the filter op,
lib/filter.py:45-95."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.ops import cheby_conv, device_laplacian, quantize_banded


@pytest.fixture(scope="module")
def planted_graph():
    """~1200-node planar planted-partition graph: RCM-bandable kNN graph
    whose labels are spatial patches (the node_classification recipe in
    miniature)."""
    rng = np.random.default_rng(7)
    side, n_classes, feat_dim = 35, 4, 16
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    pos += rng.normal(0, 0.3, pos.shape).astype(np.float32)
    patch = (pos[:, 0] // (side / 4)).astype(int) * 4 + (
        pos[:, 1] // (side / 4)
    ).astype(int)
    labels = (patch % n_classes).astype(np.int64)
    signatures = rng.normal(0, 1, (n_classes, feat_dim)).astype(np.float32)
    feats = signatures[labels] + rng.normal(
        0, 1.0, (len(labels), feat_dim)
    ).astype(np.float32)

    dist, idx = gc.knn(pos, k=8, algorithm="auto")
    W = gc.adjacency(dist, idx)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    L = gc.laplacian(W, normalized=True)
    return L, feats[perm], labels[perm], n_classes


@pytest.fixture(scope="module")
def qpair(planted_graph):
    L, feats, labels, n_classes = planted_graph
    op = device_laplacian(L, fmt="banded")
    qop = quantize_banded(op, sample_x=float(np.abs(feats).max()))
    return op, qop


class TestChebyConvQuant:
    def test_cheby_conv_dispatches_on_quant_protocol(self, planted_graph,
                                                     qpair):
        """cheby_conv(x, qop, w) must run the int8-resident recurrence and
        land close to the f32 result — the operator is a drop-in."""
        L, feats, _, _ = planted_graph
        op, qop = qpair
        rng = np.random.default_rng(3)
        K, Fin, Fout = 8, 16, 8
        x = jnp.asarray(feats[None, :, :])  # [1, M, Fin]
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.2, jnp.float32)

        want = np.asarray(jax.jit(cheby_conv)(x, op, w))
        got = np.asarray(jax.jit(cheby_conv)(x, qop, w))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 0.12, rel

    def test_quant_basis_scale_is_dynamic(self, qpair):
        """The runtime scale comes from max|x|, not the baked act_scale:
        scaling the input by 1000x must not saturate (outputs scale)."""
        op, qop = qpair
        rng = np.random.default_rng(4)
        K, Fin, Fout = 6, 4, 4
        x = jnp.asarray(rng.normal(size=(1, op.m, Fin)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(K, Fin, Fout)) * 0.3, jnp.float32)
        y1 = np.asarray(jax.jit(cheby_conv)(x, qop, w))
        y2 = np.asarray(jax.jit(cheby_conv)(x * 1000.0, qop, w))
        rel = np.linalg.norm(y2 / 1000.0 - y1) / np.linalg.norm(y1)
        assert rel < 1e-3, rel


class TestModelServing:
    def test_node_classifier_int8_accuracy_delta(self, planted_graph,
                                                 qpair):
        """Train a NodeClassifier in f32, swap the operator for int8 at
        inference: test accuracy must move < 0.5% absolute (the serving
        acceptance bar)."""
        import optax

        from cnn_graph_tpu.models import NodeClassifier

        L, feats, labels, n_classes = planted_graph
        op, qop = qpair
        m = op.m_padded
        fp = np.zeros((m, feats.shape[1]), np.float32)
        fp[: len(feats)] = feats
        yp = np.zeros((m,), np.int64)
        yp[: len(labels)] = labels
        rng = np.random.default_rng(0)
        train = np.zeros(m, bool)
        train[: len(labels)] = rng.random(len(labels)) < 0.3
        test = np.zeros(m, bool)
        test[: len(labels)] = ~train[: len(labels)]

        def make_model(operator):
            return NodeClassifier(operator, input_features=feats.shape[1],
                                  num_classes=n_classes, hidden=[32], K=5)

        model = make_model(op)
        params = model.init(jax.random.PRNGKey(0))
        opt = optax.adam(1e-2)
        state = opt.init(params)
        features, y, tmask = map(jnp.asarray, (fp, yp, train))

        @jax.jit
        def fit(op, params, state, features, y, tmask):
            mm = make_model(op)

            def step(carry, _):
                params, state = carry
                loss, g = jax.value_and_grad(mm.loss)(
                    params, features, y, tmask
                )
                up, state = opt.update(g, state, params)
                return (optax.apply_updates(params, up), state), loss

            (params, state), losses = jax.lax.scan(
                step, (params, state), None, length=120
            )
            return params, losses

        params, losses = fit(op, params, state, features, y, tmask)
        assert losses[-1] < losses[0]

        @jax.jit
        def acc(op, params, features, y, mask):
            return make_model(op).accuracy(params, features, y, mask)

        test_m = jnp.asarray(test)
        a_f32 = float(acc(op, params, features, y, test_m))
        a_int8 = float(acc(qop, params, features, y, test_m))
        assert a_f32 > 0.8, a_f32  # the task is learnable
        assert abs(a_int8 - a_f32) < 0.005, (a_f32, a_int8)

    def test_chebnet_int8_logits_track_f32(self, planted_graph):
        """ChebNet inference with a quantized level-0 operator: logits
        stay close and the argmax prediction is stable."""
        from cnn_graph_tpu.graphs import coarsening
        from cnn_graph_tpu.models import ChebNet

        L, feats, labels, n_classes = planted_graph
        # ChebNet consumes a Gaussian-kernel graph; rebuild the adjacency
        # from the Laplacian structure is overkill — use a grid graph.
        z = gc.grid(20)
        W = gc.knn_graph(z, k=8)
        graphs_, perm = coarsening.coarsen(W, levels=2, seed=1,
                                           verbose=False)
        Ls = [gc.laplacian(g, normalized=True) for g in graphs_]
        op_f = device_laplacian(Ls[0], fmt="banded")
        qop = quantize_banded(op_f, sample_x=3.0)

        rng = np.random.default_rng(5)
        B = 6
        x = jnp.asarray(rng.normal(size=(B, op_f.m)), jnp.float32)

        def build(op0):
            return ChebNet([op0] + [device_laplacian(l, fmt="dense")
                                    for l in Ls[1:]],
                           F=[8], K=[10], p=[1], M=[n_classes])

        net_f = build(op_f)
        params = net_f.init(jax.random.PRNGKey(2))
        logits_f = np.asarray(jax.jit(net_f.apply)(params, x))
        net_q = build(qop)
        logits_q = np.asarray(jax.jit(net_q.apply)(params, x))
        rel = (np.linalg.norm(logits_q - logits_f)
               / np.linalg.norm(logits_f))
        assert rel < 0.1, rel
        assert (logits_q.argmax(1) == logits_f.argmax(1)).mean() >= 5 / 6


class TestForecastingServing:
    def test_gconv_lstm_cell_int8_tracks_f32(self, planted_graph, qpair):
        """The spatiotemporal cell consumes whatever operator it is given
        through ops.cheby_conv, so quantized inference needs no model
        changes — outputs must track f32 through the nonlinear gates over
        several steps."""
        from cnn_graph_tpu.models.gconv_lstm import (
            GConvLSTMCell, glstm_stack_apply, glstm_stack_init,
        )

        L, feats, _, _ = planted_graph
        op, qop = qpair
        rng = np.random.default_rng(9)
        T, B, Fin, H = 3, 2, 4, 6
        x_seq = jnp.asarray(
            rng.normal(size=(T, B, op.m, Fin)), jnp.float32)

        def run(operator):
            cell = GConvLSTMCell(operator, num_units=H, feat_in=Fin, K=4)
            params = glstm_stack_init(jax.random.PRNGKey(1), [cell])
            return np.asarray(jax.jit(
                lambda p, x: glstm_stack_apply(p, [cell], x)
            )(params, x_seq))

        y_f = run(op)
        y_q = run(qop)
        rel = np.linalg.norm(y_q - y_f) / np.linalg.norm(y_f)
        assert rel < 0.15, rel


class TestQuantizeHelper:
    def test_quantize_model_operators_one_call(self, planted_graph, qpair):
        """models.common.quantize_model_operators: one call converts a
        trained model to the int8 serving path (banded ops quantized,
        other formats untouched)."""
        from cnn_graph_tpu.models import NodeClassifier, common
        from cnn_graph_tpu.ops.laplacian import QuantBandedLaplacian

        L, feats, _, n_classes = planted_graph
        op, _ = qpair
        model = NodeClassifier(op, input_features=feats.shape[1],
                               num_classes=n_classes, hidden=[8], K=4)
        params = model.init(jax.random.PRNGKey(0))
        qmodel = common.quantize_model_operators(
            model, sample_x=float(np.abs(feats).max()))
        assert isinstance(qmodel.op, QuantBandedLaplacian)
        assert model.op is op  # original untouched

        fp = np.zeros((op.m_padded, feats.shape[1]), np.float32)
        fp[: len(feats)] = feats
        x = jnp.asarray(fp)
        y_f = np.asarray(jax.jit(model.apply)(params, x))
        y_q = np.asarray(jax.jit(qmodel.apply)(params, x))
        rel = np.linalg.norm(y_q - y_f) / np.linalg.norm(y_f)
        assert rel < 0.15, rel

    def test_mixed_chebnet_stack(self, planted_graph):
        """ChebNet with banded level 0 + dense deeper levels: only the
        banded operator quantizes."""
        from cnn_graph_tpu.graphs import coarsening
        from cnn_graph_tpu.models import ChebNet, common
        from cnn_graph_tpu.ops.laplacian import (
            DenseLaplacian, QuantBandedLaplacian,
        )

        z = gc.grid(20)
        W = gc.knn_graph(z, k=8)
        graphs_, _ = coarsening.coarsen(W, levels=2, seed=1, verbose=False)
        Ls = [gc.laplacian(g, normalized=True) for g in graphs_]
        net = ChebNet(
            [device_laplacian(Ls[0], fmt="banded")]
            + [device_laplacian(l, fmt="dense") for l in Ls[1:]],
            F=[8], K=[6], p=[1], M=[3])
        qnet = common.quantize_model_operators(net, sample_x=3.0)
        assert isinstance(qnet.operators[0], QuantBandedLaplacian)
        # ChebNet keeps one operator per gconv layer; the rest of the
        # stack (unused here with p=[1]) stays in its original format.
        for o in qnet.operators[1:]:
            assert isinstance(o, DenseLaplacian)
