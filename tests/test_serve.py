"""Serving layer: AOT compile + StableHLO export/load round-trips
(cnn_graph_tpu/serve.py).  The reference has no serving layer (models
die with their tf.Session, lib/graph_model.py:124-197); this is the
deployable-artifact story over the int8 path."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnn_graph_tpu import serve
from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import NodeClassifier
from cnn_graph_tpu.ops import device_laplacian


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(0)
    z = gc.grid(20)
    W = gc.knn_graph(z, k=8)
    L = gc.laplacian(W, normalized=True)
    op = device_laplacian(L, fmt="banded")
    model = NodeClassifier(op, input_features=8, num_classes=4,
                           hidden=[16], K=4)
    params = model.init(jax.random.PRNGKey(0))
    x = jnp.asarray(rng.normal(size=(op.m_padded, 8)), jnp.float32)
    y_ref = np.asarray(jax.jit(model.apply)(params, x))
    return model, params, x, y_ref


class TestCompileServing:
    def test_f32_compiled_matches_eager_apply(self, trained):
        model, params, x, y_ref = trained
        cs = serve.compile_serving(model, params, x, int8=False)
        np.testing.assert_allclose(np.asarray(cs(x)), y_ref, atol=1e-5)
        assert cs.input_spec.shape == x.shape

    def test_int8_compiled_tracks_f32(self, trained):
        model, params, x, y_ref = trained
        cs = serve.compile_serving(model, params, x)
        rel = (np.linalg.norm(np.asarray(cs(x)) - y_ref)
               / np.linalg.norm(y_ref))
        assert rel < 0.15, rel

    def test_no_retrace_on_repeat_calls(self, trained):
        """The handle holds ONE compiled executable: repeated calls may
        not trace (the whole point of AOT serving)."""
        model, params, x, _ = trained
        cs = serve.compile_serving(model, params, x, int8=False)
        y1 = np.asarray(cs(x))
        y2 = np.asarray(cs(x * 1.0))
        np.testing.assert_allclose(y1, y2, atol=1e-6)
        assert cs.cost_analysis is not None


class TestExportLoad:
    def test_round_trip_without_model_code(self, trained, tmp_path):
        """load_serving reconstructs inference from the artifact dir
        alone — it never touches the model object."""
        model, params, x, y_ref = trained
        d = str(tmp_path / "artifact")
        serve.export_serving(model, params, x, d)
        assert sorted(os.listdir(d)) == ["leaves.npz", "meta.json",
                                         "model.stablehlo"]
        ls = serve.load_serving(d)
        y_l = np.asarray(ls(x))
        rel = np.linalg.norm(y_l - y_ref) / np.linalg.norm(y_ref)
        assert rel < 0.15, rel  # int8 default
        assert ls.meta["model"] == "NodeClassifier"
        assert ls.meta["int8"] is True
        assert ls.input_spec.shape == x.shape

    def test_round_trip_needs_no_flatbuffers(self, trained, tmp_path,
                                             monkeypatch):
        """The artifact is written and read without ``Exported.serialize``
        (its ``flatbuffers`` dependency is not installed everywhere)."""
        import sys

        model, params, x, _ = trained
        monkeypatch.setitem(sys.modules, "flatbuffers", None)
        cs = serve.compile_serving(model, params, x)
        d = str(tmp_path / "artifact")
        serve.export_serving(model, params, x, d)
        np.testing.assert_array_equal(np.asarray(serve.load_serving(d)(x)),
                                      np.asarray(cs(x)))

    def test_load_refuses_another_jax_version(self, trained, tmp_path):
        import json

        model, params, x, _ = trained
        d = str(tmp_path / "artifact")
        serve.export_serving(model, params, x, d)
        meta_path = os.path.join(d, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["jax_version"] = "0.0.1"
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(ValueError, match="re-export"):
            serve.load_serving(d)

    def test_load_refuses_the_older_format(self, trained, tmp_path):
        """An artifact written by ``Exported.serialize`` (no calling
        convention in meta.json) is refused with a re-export message."""
        import json

        model, params, x, _ = trained
        d = str(tmp_path / "artifact")
        serve.export_serving(model, params, x, d)
        meta_path = os.path.join(d, "meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        del meta["exported"], meta["jax_version"]
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(ValueError, match="older format"):
            serve.load_serving(d)

    def test_loaded_artifact_is_inference_only(self, trained, tmp_path):
        model, params, x, _ = trained
        d = str(tmp_path / "artifact")
        serve.export_serving(model, params, x, d, int8=False)
        ls = serve.load_serving(d)
        with pytest.raises(TypeError, match="inference-only"):
            jax.grad(lambda v: ls(v).sum())(x)

    def test_export_matches_compiled(self, trained, tmp_path):
        model, params, x, _ = trained
        cs = serve.compile_serving(model, params, x)
        d = str(tmp_path / "artifact")
        serve.export_serving(model, params, x, d)
        y_l = np.asarray(serve.load_serving(d)(x))
        np.testing.assert_allclose(y_l, np.asarray(cs(x)), atol=1e-5)

    def test_bf16_leaves_round_trip(self, tmp_path):
        """bf16 operator leaves survive the raw-bytes npz encoding (numpy
        cannot serialize ml_dtypes natively)."""
        rng = np.random.default_rng(3)
        z = gc.grid(16)
        W = gc.knn_graph(z, k=8)
        L = gc.laplacian(W, normalized=True)
        op = device_laplacian(L, fmt="banded",
                              dtype=jnp.bfloat16)
        model = NodeClassifier(op, input_features=4, num_classes=3,
                               hidden=[], K=3)
        params = model.init(jax.random.PRNGKey(1))
        x = jnp.asarray(rng.normal(size=(op.m_padded, 4)), jnp.float32)
        y_ref = np.asarray(jax.jit(model.apply)(params, x))

        d = str(tmp_path / "bf16")
        serve.export_serving(model, params, x, d, int8=False)
        ls = serve.load_serving(d)
        assert "bfloat16" in ls.meta["leaf_dtypes"]
        np.testing.assert_allclose(np.asarray(ls(x)), y_ref,
                                   atol=2e-2, rtol=2e-2)

    def test_chebnet_graph_classifier_exports(self, tmp_path):
        """The batch-of-graph-signals model family exports too."""
        from cnn_graph_tpu.graphs import coarsening
        from cnn_graph_tpu.models import ChebNet

        z = gc.grid(16)
        W = gc.knn_graph(z, k=8)
        graphs_, _ = coarsening.coarsen(W, levels=2, seed=1, verbose=False)
        Ls = [gc.laplacian(g, normalized=True) for g in graphs_]
        net = ChebNet(
            [device_laplacian(Ls[0], fmt="banded")]
            + [device_laplacian(l, fmt="dense") for l in Ls[1:]],
            F=[8], K=[5], p=[1], M=[3])
        params = net.init(jax.random.PRNGKey(2))
        rng = np.random.default_rng(4)
        x = jnp.asarray(rng.normal(size=(4, net.operators[0].m)),
                        jnp.float32)
        y_ref = np.asarray(jax.jit(net.apply)(params, x))

        d = str(tmp_path / "chebnet")
        serve.export_serving(net, params, x, d)
        y_l = np.asarray(serve.load_serving(d)(x))
        rel = np.linalg.norm(y_l - y_ref) / np.linalg.norm(y_ref)
        assert rel < 0.15, rel

    def test_sharded_model_export_raises(self, tmp_path):
        """Halo-sharded operators are not exportable (the artifact is the
        single-chip serving unit): export_serving must refuse clearly
        instead of failing deep in tracing or baking in a device count."""
        from cnn_graph_tpu.data.synthetic import city_graph
        from cnn_graph_tpu.parallel import banded_halo_laplacian, make_mesh

        mesh = make_mesh(data=1, nodes=len(jax.devices()))
        L, _ = city_graph(96, k=8, seed=0)
        bop = banded_halo_laplacian(L, mesh, rows_per_step=1)
        model = NodeClassifier(bop, input_features=3, num_classes=2,
                               hidden=[], K=3)
        params = model.init(jax.random.PRNGKey(0))
        x = jnp.zeros((bop.m_padded, 3), jnp.float32)
        with pytest.raises(ValueError, match="sharded"):
            serve.export_serving(model, params, x,
                                 str(tmp_path / "nope"))

    def test_int8_meta_reflects_actual_conversion(self, tmp_path):
        """Round 5: DENSE operators now have an int8 twin (the 20NEWS
        auto-format, DESIGN.md §14), so a dense-operator model
        converts and the metadata must record it; a BCOO model still
        passes through unchanged and the metadata must say so."""
        z = gc.grid(12)
        W = gc.knn_graph(z, k=8)
        L = gc.laplacian(W, normalized=True)
        op = device_laplacian(L, fmt="dense")
        model = NodeClassifier(op, input_features=4, num_classes=3,
                               hidden=[], K=3)
        params = model.init(jax.random.PRNGKey(5))
        x = jnp.asarray(np.random.default_rng(7).normal(
            size=(op.m_padded, 4)), jnp.float32)
        d = str(tmp_path / "dense")
        serve.export_serving(model, params, x, d, int8=True)
        ls = serve.load_serving(d)
        assert ls.meta["int8"] is True
        assert ls.meta["int8_requested"] is True
        assert ls.meta["quantized_operators"] == 1

        # BCOO (CPU-test fallback format) has no twin: pass-through.
        opb = device_laplacian(L, fmt="bcoo")
        modelb = NodeClassifier(opb, input_features=4, num_classes=3,
                                hidden=[], K=3)
        db = str(tmp_path / "bcoo")
        serve.export_serving(modelb, model.init(jax.random.PRNGKey(6)),
                             x[: opb.m_padded], db, int8=True)
        lsb = serve.load_serving(db)
        assert lsb.meta["int8"] is False
        assert lsb.meta["int8_requested"] is True
        assert lsb.meta["quantized_operators"] == 0

    def test_forecaster_exports(self, tmp_path):
        """The forecasting family (GConvLSTM variants) shares the
        apply(params, x) serving surface, so it exports unchanged."""
        from cnn_graph_tpu.data.synthetic import city_graph
        from cnn_graph_tpu.models import GConvForecaster

        L, _ = city_graph(12, k=8, seed=0)  # 144 regions
        op = device_laplacian(L, fmt="banded",
                              rescale=True)
        model = GConvForecaster(op, seq_closeness=4, seq_period=2,
                                seq_trend=2, variant="glstm_gconv",
                                num_hidden=8, K=3)
        params = model.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(6)
        C = 2 * (4 + 2 + 2)
        x = jnp.asarray(rng.normal(size=(2, op.m, C)), jnp.float32)
        y_ref = np.asarray(jax.jit(model.apply)(params, x))

        d = str(tmp_path / "forecaster")
        serve.export_serving(model, params, x, d)
        y_l = np.asarray(serve.load_serving(d)(x))
        rel = np.linalg.norm(y_l - y_ref) / np.linalg.norm(y_ref)
        assert rel < 0.2, rel
