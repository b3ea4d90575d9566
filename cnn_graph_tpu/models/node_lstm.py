"""Plain per-node LSTM baseline: no graph structure at all.

The reference's humanflow workflow judges the graph models against a
per-node LSTM trained on each region's own in/out-flow series — the
``load_lstm_data`` loader exists for exactly that
(/root/reference/nips2016/humantraffic.py:354-383: one dataset per node,
85/15 train/test).  The reference would train M separate models in a
Python loop; here all M node-LSTMs train in ONE jitted program: the
parameters carry a leading node axis and every matmul is a batched
``einsum`` over it (one batched program in place of a model-per-node
loop).

Weights use the gLSTM family's Uniform(-0.1, 0.1) initializer.  The MSE
loss / ReLU prediction head contract matches the other regression models
(Trainer task="regression").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cnn_graph_tpu.models import common

__all__ = ["PerNodeLSTM", "stack_lstm_collection"]


def stack_lstm_collection(collection: list[dict]) -> dict:
    """Stack ``load_lstm_data``'s per-node datasets into node-batched
    arrays: ``train_data`` [S, n_nodes, 2*seq], ``train_labels``
    [S, n_nodes, 2] (same for test).  All nodes share the sample count
    (same series length), so the stack is rectangular."""
    out = {}
    for key in ("train_data", "train_labels", "test_data", "test_labels"):
        out[key] = np.stack([c[key] for c in collection], axis=1).astype(
            np.float32
        )
    return out


class PerNodeLSTM:
    """M independent 2-feature LSTMs (one per node), trained jointly.

    ``x``: [B, n_nodes, 2*seq] — the load_lstm_data window layout
    (in-flow window then out-flow window); timestep t feeds features
    ``(in[t], out[t])``.  Output: [B, n_nodes, 2] next-step (in, out).
    """

    FEAT = 2

    def __init__(self, n_nodes: int, seq: int, num_hidden: int = 32,
                 forget_bias: float = 1.0):
        self.n_nodes = n_nodes
        self.seq = seq
        self.num_hidden = num_hidden
        self.forget_bias = forget_bias

    def init(self, key: jax.Array):
        n, h, f = self.n_nodes, self.num_hidden, self.FEAT
        k = jax.random.split(key, 4)
        return {
            "Wx": common.uniform_init(k[0], (n, f, 4 * h)),
            "Wh": common.uniform_init(k[1], (n, h, 4 * h)),
            "b": jnp.zeros((n, 4 * h), jnp.float32),
            "Wo": common.uniform_init(k[2], (n, h, f)),
            "bo": jnp.zeros((n, f), jnp.float32),
        }

    def apply(self, params, x: jax.Array, *, train: bool = False, rng=None):
        B, n, twoseq = x.shape
        assert n == self.n_nodes and twoseq == 2 * self.seq, x.shape
        h_dim = self.num_hidden
        # [B, n, 2*seq] -> time-major [seq, B, n, 2] of (in_t, out_t).
        seq_x = jnp.stack([x[:, :, : self.seq], x[:, :, self.seq:]], -1)
        seq_x = jnp.transpose(seq_x, (2, 0, 1, 3))

        def step(carry, xt):
            c, h = carry
            pre = (
                jnp.einsum("bnf,nfh->bnh", xt, params["Wx"])
                + jnp.einsum("bnh,nhg->bng", h, params["Wh"])
                + params["b"]
            )
            z = jnp.tanh(pre[..., :h_dim])
            i = jax.nn.sigmoid(pre[..., h_dim:2 * h_dim])
            f = jax.nn.sigmoid(pre[..., 2 * h_dim:3 * h_dim]
                               + self.forget_bias)
            o = jax.nn.sigmoid(pre[..., 3 * h_dim:])
            c = f * c + i * z
            h = o * jnp.tanh(c)
            return (c, h), None

        zeros = jnp.zeros((B, n, h_dim), x.dtype)
        (_, h), _ = jax.lax.scan(step, (zeros, zeros), seq_x)
        return jnp.einsum("bnh,nhf->bnf", h, params["Wo"]) + params["bo"]

    def loss(self, params, x, y, *, train: bool = False, rng=None):
        pred = self.apply(params, x, train=train, rng=rng)
        return jnp.mean((y - pred) ** 2)
