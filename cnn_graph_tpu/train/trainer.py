"""Training runtime: jitted steps, device-resident data, periodic eval.

The device-resident replacement for the reference's ``GraphModel`` runtime
(lib/graph_model.py): where the reference drives a ``tf.Session`` from a
Python loop with per-step ``feed_dict`` transfers and fetches every
registered tensor each step (graph_model.py:142-163), this trainer

* keeps the full training set device-resident and gathers each batch
  on-device from an index vector, so the host->device path per step is a
  [batch] int32 array;
* runs loss/grad/update/EMA as ONE jitted function with donated state, so
  steps queue asynchronously and the host only syncs at eval points;
* samples batches without replacement, epoch-permutation style (the
  deque-based sampler of graph_model.py:139-147, minus the deque);
* evaluates periodically with a batched, padded, jitted predict
  (graph_model.py:64-94 semantics, including zero-padding the last batch).

Optimizers: Adam with staircase exponential LR decay (graph_model.py:277-310)
plus the sgd / rmsprop / gradient-clipping options of the self-contained
gconvRNN trainer (gconvRNN.py:381-417), expressed as an optax chain.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    num_epochs: int = 20
    learning_rate: float = 0.1
    decay_rate: float = 0.95
    decay_steps: int | None = None
    momentum: float = 0.9
    batch_size: int = 100
    eval_frequency: int = 200
    optimizer: str = "adam"  # adam | sgd | rmsprop
    grad_clip: float | None = None  # global-norm clip (gconvRNN.py:399)
    seed: int = 2017
    loss_ema_decay: float = 0.9  # graph_model.py:266
    check_numerics: bool = False  # skip non-finite updates (gconvRNN.py:400)
    checkpoint_dir: str | None = None  # enables periodic save + resume
    checkpoint_keep: int = 5
    log_path: str | None = None  # JSONL metrics stream
    # Batch data parallelism (SURVEY.md §2.3 "the first parallelism to
    # implement"): a jax.sharding.Mesh with a 'data' axis.  Batches are
    # sharded P('data') inside every jitted program, parameters and
    # optimizer state ride replicated, and XLA inserts the gradient
    # psum over the mesh — the train step itself is unchanged.
    #
    # dp x tp: the mesh may ALSO carry a 'nodes' axis when the model's
    # operator is a sharded halo operator built over the same mesh
    # (parallel.banded_halo_laplacian / sparse_halo_laplacian) — the
    # operator's own shard_map partitions Laplacian rows + node
    # activations over 'nodes' inside the unchanged step, composing
    # with the batch sharding (step-parity-tested vs single-device:
    # tests/test_training_infra.py::TestMeshDpTp).
    mesh: Any = None


class Trainer:
    """Drives a model exposing ``init(key)``, ``loss(params, x, y, train,
    rng)`` and ``apply(params, x)``.

    ``task`` selects the prediction head + eval metric:
    ``regression`` — ReLU prediction head and MSE (graph_model.py:233-244,
    :116); ``classification`` — argmax head, accuracy + weighted F1.
    """

    def __init__(self, model, config: TrainConfig, task: str = "regression"):
        assert task in ("regression", "classification", "sequence")
        self.model = model
        self.config = config
        self.task = task
        self.params = None
        self.opt_state = None
        self._build()

    # ---- construction ----

    def _schedule(self):
        c = self.config
        if c.decay_rate != 1 and c.decay_steps:
            return optax.exponential_decay(
                c.learning_rate,
                transition_steps=c.decay_steps,
                decay_rate=c.decay_rate,
                staircase=True,
            )
        return c.learning_rate

    def _build(self):
        c = self.config
        sched = self._schedule()
        if c.optimizer == "adam":
            opt = optax.adam(sched)
        elif c.optimizer == "sgd":
            opt = (
                optax.sgd(sched, momentum=c.momentum)
                if c.momentum
                else optax.sgd(sched)
            )
        elif c.optimizer == "rmsprop":
            opt = optax.rmsprop(sched, decay=0.9)
        else:
            raise ValueError(f"unknown optimizer {c.optimizer!r}")
        if c.grad_clip:
            opt = optax.chain(optax.clip_by_global_norm(c.grad_clip), opt)
        if c.check_numerics:
            # The reference raises via tf.check_numerics on any non-finite
            # gradient (gconvRNN.py:400-402); skipping the bad update and
            # counting is the recoverable equivalent.
            opt = optax.apply_if_finite(opt, max_consecutive_errors=100)
        self.optimizer = opt

        model, task = self.model, self.task

        # The model's graph data (Laplacian operators, eigenbases) is a jit
        # ARGUMENT to every device program below: closing over it would
        # embed the arrays as HLO literals and the compile payload would
        # grow with the graph (models/common.py:GRAPH_ARRAY_FIELDS).
        from cnn_graph_tpu.models import common as mcommon

        self._gtree = mcommon.graph_arrays(model)

        if c.mesh is not None:
            assert "data" in c.mesh.axis_names, c.mesh
            n_dp = c.mesh.shape["data"]
            assert c.batch_size % n_dp == 0, (
                f"batch_size {c.batch_size} not divisible by the mesh's "
                f"data axis ({n_dp})"
            )

        def shard_batch(x):
            """Constrain a batch-leading array to P('data') — the GSPMD
            annotation that turns the unchanged step into a DP program."""
            if c.mesh is None:
                return x
            from jax.sharding import NamedSharding, PartitionSpec as P

            spec = NamedSharding(
                c.mesh, P("data", *([None] * (x.ndim - 1)))
            )
            return jax.lax.with_sharding_constraint(x, spec)

        def train_step(gtree, params, opt_state, ema, rng, data, labels, idx):
            m = mcommon.with_graph_arrays(model, gtree)
            x = shard_batch(jnp.take(data, idx, axis=0))
            y = shard_batch(jnp.take(labels, idx, axis=0))
            rng, step_rng = jax.random.split(rng)
            loss, grads = jax.value_and_grad(m.loss)(
                params, x, y, train=True, rng=step_rng
            )
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            ema = jnp.where(
                ema < 0, loss, c.loss_ema_decay * ema + (1 - c.loss_ema_decay) * loss
            )
            return params, opt_state, ema, rng, loss

        train_step_jit = jax.jit(train_step, donate_argnums=(1, 2, 3, 4))
        self._train_step = lambda *a: train_step_jit(self._gtree, *a)

        def train_chunk(gtree, params, opt_state, ema, rng, data, labels,
                        idx_chunk):
            """Run idx_chunk.shape[0] steps as ONE device program via
            lax.scan — the host stays out of the per-step path
            entirely."""

            def body(carry, idx):
                params, opt_state, ema, rng = carry
                params, opt_state, ema, rng, loss = train_step(
                    gtree, params, opt_state, ema, rng, data, labels, idx
                )
                return (params, opt_state, ema, rng), loss

            (params, opt_state, ema, rng), losses = jax.lax.scan(
                body, (params, opt_state, ema, rng), idx_chunk
            )
            return params, opt_state, ema, rng, losses

        train_chunk_jit = jax.jit(train_chunk, donate_argnums=(1, 2, 3, 4))
        self._train_chunk = lambda *a: train_chunk_jit(self._gtree, *a)

        def predict_batch(gtree, params, x):
            x = shard_batch(x)
            out = mcommon.with_graph_arrays(model, gtree).apply(params, x)
            if task == "regression":
                return jax.nn.relu(out)  # graph_model.py:241
            return out  # logits; argmax on host side

        predict_batch_jit = jax.jit(predict_batch)
        self._predict_batch = lambda *a: predict_batch_jit(self._gtree, *a)

        def eval_batch(gtree, params, x, y):
            x, y = shard_batch(x), shard_batch(y)
            m = mcommon.with_graph_arrays(model, gtree)
            out = m.apply(params, x)
            loss = m.loss(params, x, y)
            return (jax.nn.relu(out) if task == "regression" else out), loss

        eval_batch_jit = jax.jit(eval_batch)
        self._eval_batch = lambda *a: eval_batch_jit(self._gtree, *a)

        def eval_scan(gtree, params, data_b, labels_b):
            """Batched evaluation as one device program: ``data_b`` is
            [nb, B, ...]; returns stacked predictions + per-batch losses."""

            def body(_, xy):
                x, y = xy
                pred, loss = eval_batch(gtree, params, x, y)
                return None, (pred, loss)

            _, (preds, losses) = jax.lax.scan(body, None, (data_b, labels_b))
            return preds, losses

        eval_scan_jit = jax.jit(eval_scan)
        self._eval_scan = lambda *a: eval_scan_jit(self._gtree, *a)

        # The raw jitted programs (gtree-first signatures), exposed for
        # introspection — tests lower these to assert the no-closure-
        # literals rule holds for the ACTUAL trainer programs.
        self._jitted = {
            "train_step": train_step_jit,
            "train_chunk": train_chunk_jit,
            "predict_batch": predict_batch_jit,
            "eval_batch": eval_batch_jit,
            "eval_scan": eval_scan_jit,
        }

    # ---- high-level API (fit / predict / evaluate) ----

    def fit(self, train_data, train_labels, val_data, val_labels,
            verbose: bool = True):
        """Train; returns ``(metric_history, val_losses, t_step_seconds)``
        exactly like GraphModel.fit (graph_model.py:196-197)."""
        c = self.config
        t_wall = time.time()
        rng = jax.random.PRNGKey(c.seed)
        if self.params is None:
            rng, init_rng = jax.random.split(rng)
            self.params = self.model.init(init_rng)
        self.opt_state = self.optimizer.init(self.params)

        n = train_data.shape[0]
        data = jnp.asarray(train_data)
        labels = jnp.asarray(train_labels)
        if c.mesh is not None:
            # Device-resident dataset and all train-state leaves ride
            # replicated; only the per-step batch (constrained P('data')
            # inside the jitted step) is sharded.
            from cnn_graph_tpu.parallel.mesh import replicated

            repl = replicated(c.mesh)
            data = jax.device_put(data, repl)
            labels = jax.device_put(labels, repl)
            self.params = jax.device_put(self.params, repl)
            self.opt_state = jax.device_put(self.opt_state, repl)
        num_steps = int(c.num_epochs * n / c.batch_size)

        ema = jnp.float32(-1.0)
        sampler = _EpochSampler(n, c.seed)
        metric_hist, loss_hist = [], []
        val_batched = self._device_batches(val_data, val_labels)

        # Optional checkpoint/resume and metrics stream.
        mngr = None
        logger = None
        step = 0
        if c.checkpoint_dir:
            from cnn_graph_tpu.train.checkpoint import CheckpointManager

            mngr = CheckpointManager(c.checkpoint_dir,
                                     max_to_keep=c.checkpoint_keep)
            if mngr.latest_step() is not None:
                self.params, self.opt_state, step = mngr.restore(
                    self.params, self.opt_state
                )
                if verbose:
                    print(f"resumed from checkpoint at step {step}")
        if c.log_path:
            from cnn_graph_tpu.utils.logging import MetricsLogger

            logger = MetricsLogger(c.log_path)

        params, opt_state = self.params, self.opt_state
        while step < num_steps:
            # One device program per eval interval (scan over the steps).
            chunk = min(c.eval_frequency, num_steps - step)
            idx = jnp.asarray(
                np.stack(
                    [sampler.next_batch(c.batch_size) for _ in range(chunk)]
                )
            )
            params, opt_state, ema, rng, losses = self._train_chunk(
                params, opt_state, ema, rng, data, labels, idx
            )
            step += chunk
            if step % c.eval_frequency == 0 or step == num_steps:
                self.params, self.opt_state = params, opt_state
                string, metrics = self._evaluate_device(
                    params, val_batched, val_labels
                )
                metric_hist.append(metrics["main"])
                loss_hist.append(metrics["loss"])
                if logger:
                    logger.log(
                        step,
                        loss_ema=float(jax.device_get(ema)),
                        val_metric=metrics["main"],
                        val_loss=metrics["loss"],
                    )
                if mngr:
                    mngr.save(step, params, opt_state)
                if verbose:
                    epoch = step * c.batch_size / n
                    print(
                        f"step {step} / {num_steps} (epoch {epoch:.2f} / "
                        f"{c.num_epochs}):"
                    )
                    print(
                        f"  loss_average = {float(jax.device_get(ema)):.2e}"
                    )
                    print(f"  validation {string}")
                    print(f"  time: wall {time.time() - t_wall:.0f}s")

        self.params, self.opt_state = params, opt_state
        if mngr:
            mngr.wait()
            mngr.close()
        if logger:
            logger.close()
        t_step = (time.time() - t_wall) / num_steps
        return metric_hist, loss_hist, t_step

    def predict(self, data, labels=None):
        """Batched inference with zero-padded final batch
        (graph_model.py:64-94).  Returns predictions, and the
        size-weighted mean loss when labels are given."""
        c = self.config
        n = data.shape[0]
        preds = []
        total_loss = 0.0
        for begin in range(0, n, c.batch_size):
            end = min(begin + c.batch_size, n)
            batch = np.zeros((c.batch_size,) + data.shape[1:], data.dtype)
            batch[: end - begin] = data[begin:end]
            xb = jnp.asarray(batch)
            if labels is not None:
                yb = np.zeros((c.batch_size,) + labels.shape[1:], labels.dtype)
                yb[: end - begin] = labels[begin:end]
                out, loss = self._eval_batch(self.params, xb, jnp.asarray(yb))
                total_loss += float(jax.device_get(loss))
            else:
                out = self._predict_batch(self.params, xb)
            preds.append(jax.device_get(out)[: end - begin])
        predictions = np.concatenate(preds, axis=0)
        if labels is not None:
            return predictions, total_loss * c.batch_size / n
        return predictions

    def evaluate(self, data, labels):
        """Metrics + report line.  Regression: MSE over all outputs
        (graph_model.py:116); classification: accuracy and weighted F1."""
        outputs, loss = self.predict(data, labels)
        return self._metrics(outputs, labels, loss)

    # ---- internals ----

    def _metrics(self, outputs, labels, loss):
        if self.task == "regression":
            mse = float(np.sum((labels - outputs) ** 2) / outputs.size)
            string = f"mse: {mse:.5f} ({len(labels):d}), loss: {loss:.2e}"
            return string, {"main": mse, "mse": mse, "loss": loss,
                            "predictions": outputs}
        if self.task == "sequence":
            # Per-(batch, step, node) classification (GConvRNN head).
            pred = np.argmax(outputs, axis=-1)
            accuracy = 100.0 * float(np.mean(pred == labels))
            string = (
                f"seq accuracy: {accuracy:.2f} ({len(labels):d}), "
                f"loss: {loss:.2e}"
            )
            return string, {"main": accuracy, "accuracy": accuracy,
                            "loss": loss, "predictions": pred}
        pred_classes = np.argmax(outputs, axis=1)
        accuracy = 100.0 * float(np.mean(pred_classes == labels))
        f1 = 100.0 * _weighted_f1(labels, pred_classes)
        string = (
            f"accuracy: {accuracy:.2f} ({len(labels):d}), "
            f"f1 (weighted): {f1:.2f}, loss: {loss:.2e}"
        )
        return string, {"main": accuracy, "accuracy": accuracy, "f1": f1,
                        "loss": loss, "predictions": pred_classes}

    def _device_batches(self, data, labels):
        """Pad to a whole number of batches and ship to device once."""
        B = self.config.batch_size
        n = data.shape[0]
        nb = -(-n // B)
        pad = nb * B - n
        if pad:
            data = np.concatenate(
                [data, np.zeros((pad,) + data.shape[1:], data.dtype)]
            )
            labels = np.concatenate(
                [labels, np.zeros((pad,) + labels.shape[1:], labels.dtype)]
            )
        return (
            jnp.asarray(data.reshape((nb, B) + data.shape[1:])),
            jnp.asarray(labels.reshape((nb, B) + labels.shape[1:])),
            n,
        )

    def _evaluate_device(self, params, batched, labels):
        """Evaluate on pre-batched device data with one program + one fetch."""
        data_b, labels_b, n = batched
        preds, losses = self._eval_scan(params, data_b, labels_b)
        preds, losses = jax.device_get((preds, losses))
        outputs = preds.reshape((-1,) + preds.shape[2:])[:n]
        loss = float(losses.sum()) * self.config.batch_size / n
        return self._metrics(outputs, labels, loss)


class _EpochSampler:
    """Without-replacement batch sampler: every sample is used once per
    epoch before any repeats (graph_model.py:144-147, deque-free)."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.buffer = np.empty((0,), np.int64)

    def next_batch(self, batch_size: int) -> np.ndarray:
        while len(self.buffer) < batch_size:
            self.buffer = np.concatenate(
                [self.buffer, self.rng.permutation(self.n)]
            )
        out, self.buffer = self.buffer[:batch_size], self.buffer[batch_size:]
        return out.astype(np.int32)


def _weighted_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Support-weighted F1 (sklearn 'weighted' average), NumPy-only."""
    classes, counts = np.unique(y_true, return_counts=True)
    f1s = []
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom else 0.0)
    return float(np.sum(np.asarray(f1s) * counts) / counts.sum())
