"""Binary-tree graph pooling.

The coarsening permutation (graphs/coarsening.py) lays each coarse node's
children out contiguously, so pooling by a power-of-two factor p is a
reshape + reduction over p-sized groups — one fused elementwise pass
(the reference routes this through 4-D ``tf.nn.max_pool``/``avg_pool``,
lib/graph_conv.py:201-218).

Fake-node contract: fake vertices carry 0 (coarsening.perm_data), so
max-pooling picks the real sibling — preserved exactly, including the
interaction with ReLU (outputs are >= 0 so 0 never wins over a real
activation).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["max_pool", "avg_pool"]


def max_pool(x: jax.Array, p: int) -> jax.Array:
    """Max-pool groups of ``p`` consecutive nodes. [B, M, F] -> [B, M/p, F]."""
    if p <= 1:
        return x
    B, M, F = x.shape
    assert M % p == 0, f"node count {M} not divisible by pool size {p}"
    return jnp.max(x.reshape(B, M // p, p, F), axis=2)


def avg_pool(x: jax.Array, p: int) -> jax.Array:
    """Average-pool groups of ``p`` consecutive nodes."""
    if p <= 1:
        return x
    B, M, F = x.shape
    assert M % p == 0, f"node count {M} not divisible by pool size {p}"
    return jnp.mean(x.reshape(B, M // p, p, F), axis=2)
