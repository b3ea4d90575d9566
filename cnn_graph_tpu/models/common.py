"""Shared model building blocks: initializers, bias+activation variants,
fully-connected layers, dropout.

Functional init/apply style: every block is a pair of pure functions over an
explicit parameter pytree — no global variable scopes, no reuse tricks (the
reference leans on ``tf.get_variable`` + ``reuse_variables`` try/except,
gconv_lstm.py:136-175; here parameters are just pytree leaves).

Initializer parity: weights ~ TruncatedNormal(0, 0.1), biases = 0.1
(lib/graph_model.py:326-342); the gLSTM gate weights use Uniform(-0.1, 0.1)
(lib/gconv_lstm.py:98-133).
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp

__all__ = [
    "trunc_normal",
    "uniform_init",
    "bias_init",
    "bias_act",
    "fc_init",
    "fc_apply",
    "dropout",
    "graph_arrays",
    "with_graph_arrays",
    "quantize_model_operators",
]

# Model attributes holding device-resident graph data (Laplacian operators,
# Fourier eigenbases, spline bases).  These must be threaded through jit as
# ARGUMENTS, not closed over: closure-captured arrays are embedded in the
# serialized HLO as literals, and the compile payload then grows with the
# graph (at 10k nodes a closed-over block-sparse operator already inflates
# the module >5000x; see DESIGN.md §9).
GRAPH_ARRAY_FIELDS = ("op", "operators", "fourier_u", "_bases")


def graph_arrays(model) -> dict:
    """The model's device-resident graph data as a pytree (for passing as a
    jit argument).  Pair with :func:`with_graph_arrays` inside the trace."""
    return {
        f: getattr(model, f)
        for f in GRAPH_ARRAY_FIELDS
        if getattr(model, f, None) is not None
    }


def with_graph_arrays(model, tree: dict):
    """A shallow copy of ``model`` with its graph-data fields replaced by
    (possibly traced) ``tree`` leaves.  Models rebuild any internal cells
    from these fields per call, so a top-level swap propagates."""
    clone = copy.copy(model)
    for f, v in tree.items():
        setattr(clone, f, v)
    return clone


def quantize_model_operators(model, sample_x: float = 1.0,
                             headroom: float = 2.0):
    """A copy of ``model`` with every graph operator replaced by its
    int8-quantized twin — the one-call serving entry point.

    ``sample_x`` is the expected activation max of the model's INPUT (the
    recurrence itself uses a dynamic runtime scale inside ``cheby_conv``,
    so this only seeds the operators' default ``act_scale`` for direct
    ``spmm_q`` use).  Every single-chip format has a twin: banded
    (planar/city graphs), DENSE (the auto-chosen format for block-dense
    scattered graphs like the 20NEWS embedding-kNN topology), and BSR
    (scattered graphs above the dense budget) — mixed
    stacks are fine, each ``cheby_conv`` dispatches per operator.
    Sharded banded-halo / sparse-halo operators quantize to their
    sharded int8 twins (int8 carries over the halo exchange — half
    the halo bytes).  BCOO (CPU-test fallback) passes through
    unchanged.  See ``experiments/node_classification.py --int8``.
    """
    from cnn_graph_tpu.ops.laplacian import (
        BandedLaplacian,
        BlockSparseLaplacian,
        DenseLaplacian,
        quantize_banded,
        quantize_block_sparse,
        quantize_dense,
    )
    from cnn_graph_tpu.parallel.banded_halo import (
        BandedHaloLaplacian,
        quantize_banded_halo,
    )
    from cnn_graph_tpu.parallel.sparse_halo import (
        BandedSparseHaloLaplacian,
        SparseHaloLaplacian,
        quantize_sparse_halo,
    )

    def q(op):
        if isinstance(op, BandedLaplacian):
            return quantize_banded(op, headroom=headroom, sample_x=sample_x)
        if isinstance(op, DenseLaplacian):
            return quantize_dense(op, headroom=headroom, sample_x=sample_x)
        if isinstance(op, BlockSparseLaplacian):
            return quantize_block_sparse(op, headroom=headroom,
                                         sample_x=sample_x)
        if isinstance(op, BandedHaloLaplacian):
            return quantize_banded_halo(op, headroom=headroom,
                                        sample_x=sample_x)
        if isinstance(op, (SparseHaloLaplacian, BandedSparseHaloLaplacian)):
            return quantize_sparse_halo(op, headroom=headroom,
                                        sample_x=sample_x)
        return op

    tree = {}
    for f in ("op", "operators"):
        v = getattr(model, f, None)
        if v is None:
            continue
        tree[f] = [q(o) for o in v] if isinstance(v, list) else q(v)
    return with_graph_arrays(model, tree)


def trunc_normal(key, shape, std: float = 0.1, dtype=jnp.float32) -> jax.Array:
    """Truncated normal(0, std) on [-2 std, 2 std] — the reference's default
    weight initializer (``tf.truncated_normal_initializer(0, 0.1)``)."""
    return std * jax.random.truncated_normal(key, -2.0, 2.0, shape, dtype)


def uniform_init(key, shape, scale: float = 0.1, dtype=jnp.float32) -> jax.Array:
    """Uniform(-scale, scale) — the gLSTM gate-weight initializer."""
    return jax.random.uniform(key, shape, dtype, minval=-scale, maxval=scale)


def bias_init(shape, value: float = 0.1, dtype=jnp.float32) -> jax.Array:
    return jnp.full(shape, value, dtype)


def bias_act_init(variant: str, m: int, f: int):
    """Parameters for a bias+activation block.

    ``b1relu``: one bias per filter; ``b2relu``: one per vertex per filter;
    ``b1tanh``: one per filter, tanh.  (graph_conv.py:178-199.  Note the fork
    commented the b1relu bias out, graph_conv.py:181-187; we keep the
    upstream-intended bias — initialized at 0.1 like every reference bias.)
    """
    if variant in ("b1relu", "b1tanh"):
        return {"b": bias_init((1, 1, f))}
    if variant == "b2relu":
        return {"b": bias_init((1, m, f))}
    raise ValueError(f"unknown bias/activation variant {variant!r}")


def bias_act(params, x: jax.Array, variant: str) -> jax.Array:
    if variant in ("b1relu", "b2relu"):
        return jax.nn.relu(x + params["b"])
    if variant == "b1tanh":
        return jnp.tanh(x + params["b"])
    raise ValueError(f"unknown bias/activation variant {variant!r}")


def fc_init(key, m_in: int, m_out: int):
    """Dense layer parameters (lib/graph_conv.py:220-226)."""
    return {
        "w": trunc_normal(key, (m_in, m_out)),
        "b": bias_init((m_out,)),
    }


def fc_apply(params, x: jax.Array, relu: bool = True) -> jax.Array:
    y = jnp.dot(x, params["w"], preferred_element_type=x.dtype) + params["b"]
    return jax.nn.relu(y) if relu else y


def dropout(key, x: jax.Array, keep_prob: float, train: bool) -> jax.Array:
    """Inverted dropout with keep probability (the reference feeds keep-prob
    through a placeholder, graph_model.py:47; 1.0 or eval mode is identity)."""
    if not train or keep_prob >= 1.0:
        return x
    mask = jax.random.bernoulli(key, keep_prob, x.shape)
    return jnp.where(mask, x / keep_prob, 0.0)
