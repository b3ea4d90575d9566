"""Training-infrastructure tests: GConvRNN sequence model, checkpoint
resume, metrics logging, numerics guarding."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnn_graph_tpu.graphs import construction as gc
from cnn_graph_tpu.models import GConvRNN
from cnn_graph_tpu.ops import device_laplacian
from cnn_graph_tpu.train import TrainConfig, Trainer


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    z = rng.uniform(size=(24, 2)).astype(np.float32)
    W = gc.knn_graph(z, k=4)
    L = gc.laplacian(W, normalized=True)
    return device_laplacian(L, fmt="dense")


@pytest.fixture(scope="module")
def seq_data(setup):
    """Per-step node labels determined by the node's input sign — learnable
    by a gLSTM with a per-step head."""
    op = setup
    rng = np.random.default_rng(1)
    B, M, Fin, T = 32, 24, 2, 5
    x = rng.normal(size=(B, M, Fin, T)).astype(np.float32)
    y = (x.sum(axis=2) > 0).astype(np.int64)  # [B, M, T]
    y = np.transpose(y, (0, 2, 1))  # [B, T, M]
    return x, y


class TestGConvRNN:
    def test_shapes(self, setup, seq_data):
        op = setup
        x, y = seq_data
        model = GConvRNN(op, num_units=8, feat_in=2, num_classes=2, K=3,
                         num_layers=2)
        params = model.init(jax.random.PRNGKey(0))
        logits = model.apply(params, jnp.asarray(x[:4]))
        assert logits.shape == (4, 5, 24, 2)

    def test_learns_sign_task(self, setup, seq_data):
        op = setup
        x, y = seq_data
        model = GConvRNN(op, num_units=8, feat_in=2, num_classes=2, K=3)
        cfg = TrainConfig(num_epochs=40, learning_rate=5e-3, batch_size=16,
                          eval_frequency=40, decay_steps=100, seed=0)
        tr = Trainer(model, cfg, task="sequence")
        tr.fit(x, y, x[:8], y[:8], verbose=False)
        _, m = tr.evaluate(x[:8], y[:8])
        assert m["accuracy"] > 80.0

    def test_grad_clip_and_numerics_guard(self, setup, seq_data):
        op = setup
        x, y = seq_data
        model = GConvRNN(op, num_units=4, feat_in=2, num_classes=2)
        cfg = TrainConfig(num_epochs=2, learning_rate=1e-3, batch_size=16,
                          eval_frequency=10, decay_steps=10,
                          grad_clip=1.0, check_numerics=True)
        tr = Trainer(model, cfg, task="sequence")
        hist, _, _ = tr.fit(x, y, x[:8], y[:8], verbose=False)
        assert len(hist) >= 1
        assert np.isfinite(hist[-1])


class TestCheckpointResume:
    def test_fit_resumes_from_checkpoint(self, setup, seq_data, tmp_path):
        op = setup
        x, y = seq_data
        ckdir = str(tmp_path / "ck")

        def make_trainer():
            model = GConvRNN(op, num_units=4, feat_in=2, num_classes=2)
            cfg = TrainConfig(num_epochs=10, learning_rate=1e-3,
                              batch_size=16, eval_frequency=10,
                              decay_steps=50, checkpoint_dir=ckdir)
            return Trainer(model, cfg, task="sequence")

        t1 = make_trainer()
        t1.fit(x, y, x[:8], y[:8], verbose=False)
        steps_total = int(10 * x.shape[0] / 16)
        from cnn_graph_tpu.train.checkpoint import CheckpointManager

        mngr = CheckpointManager(ckdir)
        assert mngr.latest_step() == steps_total
        mngr.close()

        # A fresh trainer resumes from the saved step (prints + restores).
        t2 = make_trainer()
        rng = jax.random.PRNGKey(0)
        t2.params = t2.model.init(rng)
        t2.opt_state = t2.optimizer.init(t2.params)
        hist, _, _ = t2.fit(x, y, x[:8], y[:8], verbose=False)
        # Resumed at the final step -> at most one eval entry.
        assert len(hist) <= 1
        # Restored params equal the first trainer's final params.
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(a, b, atol=1e-6),
            t2.params, t1.params,
        )


class TestMetricsLogger:
    def test_jsonl_stream(self, setup, seq_data, tmp_path):
        op = setup
        x, y = seq_data
        log_path = str(tmp_path / "metrics.jsonl")
        model = GConvRNN(op, num_units=4, feat_in=2, num_classes=2)
        cfg = TrainConfig(num_epochs=5, learning_rate=1e-3, batch_size=16,
                          eval_frequency=5, decay_steps=50,
                          log_path=log_path)
        tr = Trainer(model, cfg, task="sequence")
        tr.fit(x, y, x[:8], y[:8], verbose=False)

        lines = [json.loads(l) for l in open(log_path)]
        assert lines[0]["event"] == "start"
        assert lines[-1]["event"] == "end"
        steps = [l for l in lines if "val_metric" in l]
        assert len(steps) >= 2
        assert all("loss_ema" in l and "step" in l for l in steps)


class TestOptimizerVariants:
    @pytest.mark.parametrize("opt", ["sgd", "rmsprop"])
    def test_sgd_rmsprop_paths(self, setup, seq_data, opt):
        # gconvRNN's optimizer surface (gconvRNN.py:381-417): sgd/rmsprop.
        op = setup
        x, y = seq_data
        model = GConvRNN(op, num_units=4, feat_in=2, num_classes=2)
        cfg = TrainConfig(num_epochs=3, learning_rate=1e-2, batch_size=16,
                          eval_frequency=6, decay_steps=20, optimizer=opt,
                          momentum=0.9)
        tr = Trainer(model, cfg, task="sequence")
        hist, losses, _ = tr.fit(x, y, x[:8], y[:8], verbose=False)
        assert np.isfinite(losses[-1])

    def test_no_decay_constant_lr(self, setup, seq_data):
        op = setup
        x, y = seq_data
        model = GConvRNN(op, num_units=4, feat_in=2, num_classes=2)
        cfg = TrainConfig(num_epochs=1, learning_rate=1e-3, batch_size=16,
                          eval_frequency=5, decay_rate=1, decay_steps=None)
        tr = Trainer(model, cfg, task="sequence")
        hist, _, _ = tr.fit(x, y, x[:8], y[:8], verbose=False)
        assert len(hist) >= 1

    def test_predict_without_labels(self, setup, seq_data):
        op = setup
        x, y = seq_data
        model = GConvRNN(op, num_units=4, feat_in=2, num_classes=2)
        cfg = TrainConfig(num_epochs=1, learning_rate=1e-3, batch_size=16,
                          eval_frequency=5, decay_steps=10)
        tr = Trainer(model, cfg, task="sequence")
        tr.fit(x, y, x[:8], y[:8], verbose=False)
        # Unlabeled predict path with a partial final batch (17 % 16 != 0).
        preds = tr.predict(x[:17])
        assert preds.shape[0] == 17


class TestGraphArraysThreading:
    """Guard the no-closure-literals rule (DESIGN.md §9): graph data must
    ride through jit as arguments, so lowered modules stay small."""

    def test_trainer_chunk_hlo_stays_small(self):
        """Lower the Trainer's ACTUAL train_chunk program over a multi-
        thousand-node operator: if the model (and its operator arrays)
        were ever closed over again instead of threaded as the gtree
        argument, the lowered module would embed megabytes of literals
        (DESIGN.md §9) and this bound would blow past by >100x."""
        import jax.numpy as jnp

        from cnn_graph_tpu.models import ResGNN
        from cnn_graph_tpu.train import TrainConfig, Trainer

        rng = np.random.default_rng(0)
        z = rng.uniform(size=(3000, 2)).astype(np.float32)
        W = gc.knn_graph(z, k=4)
        L = gc.laplacian(W, normalized=True)
        op = device_laplacian(L, fmt="bsr", block_size=128)  # ~several MB of blocks
        model = ResGNN(op, input_features=2, K=2, nfilter=4,
                       nres_layer_count=1)
        trainer = Trainer(model, TrainConfig(batch_size=4), "regression")

        params = model.init(jax.random.PRNGKey(0))
        opt_state = trainer.optimizer.init(params)
        mp = op.m_padded
        lowered = trainer._jitted["train_chunk"].lower(
            trainer._gtree, params, opt_state, jnp.float32(-1.0),
            jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct((16, mp, 2), jnp.float32),
            jax.ShapeDtypeStruct((16, mp, 2), jnp.float32),
            jax.ShapeDtypeStruct((3, 4), jnp.int32),
        )
        size = len(lowered.as_text())
        blocks_bytes = op.blocks.size * 4
        assert blocks_bytes > 1_000_000  # the guard is only meaningful
        assert size < 500_000, f"train_chunk HLO is {size} bytes"

    def test_with_graph_arrays_swaps_without_mutating(self, setup):
        from cnn_graph_tpu.models import NodeClassifier
        from cnn_graph_tpu.models import common as mcommon

        op = setup
        model = NodeClassifier(op, input_features=2, num_classes=3,
                               hidden=[8], K=2)
        gtree = mcommon.graph_arrays(model)
        scaled = jax.tree.map(lambda a: a * 2 if a.dtype == jnp.float32 else a,
                              gtree)
        clone = mcommon.with_graph_arrays(model, scaled)
        assert clone is not model
        assert clone.op is not model.op
        assert model.op is op  # original untouched
        np.testing.assert_allclose(
            np.asarray(clone.op.mat), 2 * np.asarray(op.mat)
        )


class TestMeshDataParallel:
    """User-facing batch DP through TrainConfig.mesh (SURVEY.md §2.3:
    "batch sharding across a mesh axis; the first parallelism to
    implement").  Same seeds, same data: the sharded trainer must match
    the single-device one to accumulation-order precision."""

    def _scenario(self):
        from cnn_graph_tpu.models import ChebNet

        rng = np.random.default_rng(0)
        z = rng.uniform(size=(48, 2)).astype(np.float32)
        W = gc.knn_graph(z, k=4)
        L = gc.laplacian(W, normalized=True)
        op = device_laplacian(L, fmt="dense")
        model = ChebNet([op], F=[4], K=[3], p=[1], M=[3],
                        dropout=1.0)
        x = rng.normal(size=(64, op.m)).astype(np.float32)
        y = rng.integers(0, 3, size=64).astype(np.int64)
        return model, x, y

    def _fit(self, mesh):
        model, x, y = self._scenario()
        cfg = TrainConfig(num_epochs=2, batch_size=16, eval_frequency=4,
                          learning_rate=0.05, decay_steps=None, seed=7,
                          mesh=mesh)
        tr = Trainer(model, cfg, task="classification")
        hist, losses, _ = tr.fit(x, y, x[:32], y[:32], verbose=False)
        return tr, hist, losses

    def test_dp_parity_with_single_device(self):
        from cnn_graph_tpu.parallel import make_mesh

        mesh = make_mesh(data=len(jax.devices()), nodes=1)
        tr0, hist0, loss0 = self._fit(None)
        tr1, hist1, loss1 = self._fit(mesh)

        flat0 = jax.tree_util.tree_leaves(jax.device_get(tr0.params))
        flat1 = jax.tree_util.tree_leaves(jax.device_get(tr1.params))
        for a, b in zip(flat0, flat1):
            np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(loss0, loss1, rtol=1e-3, atol=1e-4)

    def test_dp_batches_actually_shard(self):
        """The lowered train step must shard the gathered batch over the
        'data' axis (not silently replicate the compute)."""
        from cnn_graph_tpu.parallel import make_mesh

        mesh = make_mesh(data=len(jax.devices()), nodes=1)
        model, x, y = self._scenario()
        cfg = TrainConfig(num_epochs=1, batch_size=16, eval_frequency=4,
                          mesh=mesh)
        tr = Trainer(model, cfg, task="classification")
        params = model.init(jax.random.PRNGKey(0))
        import optax

        opt_state = tr.optimizer.init(params)
        txt = tr._jitted["train_step"].lower(
            tr._gtree, params, opt_state, jnp.float32(-1.0),
            jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct(x.shape, jnp.float32),
            jax.ShapeDtypeStruct(y.shape, jnp.int64),
            jax.ShapeDtypeStruct((16,), jnp.int32),
        ).as_text()
        assert "sharding" in txt

    def test_batch_not_divisible_raises(self):
        from cnn_graph_tpu.parallel import make_mesh

        model, _, _ = self._scenario()
        mesh = make_mesh(data=len(jax.devices()), nodes=1)
        with pytest.raises(AssertionError, match="divisible"):
            Trainer(model, TrainConfig(batch_size=9, mesh=mesh),
                    task="classification")


class TestMeshDpTp:
    """Node-sharded TRAINING through the user-facing Trainer: a model over a BandedHaloLaplacian, driven by
    ``Trainer.fit`` on a dp x tp mesh — batches shard over 'data',
    the operator's shard_map partitions Laplacian rows + activations
    over 'nodes'.  Must match the single-device trainer over the
    equivalent single-chip banded operator to accumulation-order
    precision (the sharded oracle runs the same f32-accumulated window
    einsum as the single-chip fallback)."""

    def _scenario(self, op):
        from cnn_graph_tpu.models import ResGNN

        rng = np.random.default_rng(0)
        m = op.m
        model = ResGNN(op, input_features=3, K=3, nfilter=4,
                       nres_layer_count=1, out_features=2)
        x = rng.normal(size=(32, m, 3)).astype(np.float32)
        y = rng.normal(size=(32, m, 2)).astype(np.float32)
        return model, x, y

    def _fit(self, op, mesh):
        model, x, y = self._scenario(op)
        cfg = TrainConfig(num_epochs=2, batch_size=8, eval_frequency=4,
                          learning_rate=0.01, decay_steps=None, seed=7,
                          mesh=mesh)
        tr = Trainer(model, cfg, task="regression")
        hist, losses, _ = tr.fit(x, y, x[:8], y[:8], verbose=False)
        return tr, hist, losses

    def test_dp_tp_parity_with_single_device(self):
        from cnn_graph_tpu.data.synthetic import city_graph
        from cnn_graph_tpu.parallel import banded_halo_laplacian, make_mesh

        n = len(jax.devices())
        nodes = 4 if n % 4 == 0 else n
        mesh = make_mesh(data=n // nodes, nodes=nodes)
        L, _ = city_graph(32, k=8, seed=0)  # 1024 nodes, bandable

        hop = banded_halo_laplacian(L, mesh, rows_per_step=1)
        op0 = device_laplacian(L, fmt="banded",
                               ragged=False, rows_per_step=1)

        tr0, hist0, loss0 = self._fit(op0, None)
        tr1, hist1, loss1 = self._fit(hop, mesh)

        flat0 = jax.tree_util.tree_leaves(jax.device_get(tr0.params))
        flat1 = jax.tree_util.tree_leaves(jax.device_get(tr1.params))
        for a, b in zip(flat0, flat1):
            np.testing.assert_allclose(a, b, atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(loss0, loss1, rtol=1e-3, atol=1e-4)
