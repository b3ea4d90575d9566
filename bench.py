"""Benchmark: Chebyshev recurrence throughput and training steps on the GPU.

Runs every section in this one process (one JAX process per card) and
prints ONE JSON line:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "details": {"device": {...}, "card": "...", sections...}}

Sections (all timed with ``block_until_ready`` after a warm-up call):

* ``mnist``      — the reference's headline config (28x28 8-NN grid,
  K=25, F=32, batch 100, dense operator): conv-chain edge rate and the
  ChebNet (F=[32,64], K=[25,25], M=[512,10]) train step;
* ``city50k``    — a 50,176-node planar city graph (8-NN, RCM, banded):
  bf16 and int8 K=25 chains at C=512 (the headline is the faster), and
  the NodeClassifier train step single-conv and deep (hidden=[512]);
* ``city100k``   — the same chains at 99,856 nodes;
* ``scattered``  — a 10k-node 64-D embedding kNN graph (k=16) as a dense
  operator (the 20NEWS topology serves dense) and a 50k-node 8-D kNN
  graph (k=10) through the XLA BSR path.

``vs_baseline`` is the headline rate over the single-GPU memory roofline
of the reference's ``tf.sparse_tensor_dense_matmul`` at the same feature
width (2*C*4 bytes/edge) on an A100-80GB (2.0 TB/s); the reference
publishes no numbers of its own (BASELINE.md).

A run without a GPU fails: nothing here falls back to the CPU.
"""

import json
import subprocess
import sys
import time

import numpy as np


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().replace("\n", " | ")


def _chain_rate(op, x, K, quant=False):
    """Steady seconds per hop of the K-term chain (``cheby_finals``)."""
    import jax

    from cnn_graph_tpu.ops import cheby_finals
    from cnn_graph_tpu.utils.profiling import time_steady

    if quant:
        x = op.quantize(x.astype(np.float32))
    f = jax.jit(lambda o, v: cheby_finals(o, v, K))
    first, med = time_steady(f, op, x)
    return {"us_per_hop": med / (K - 1) * 1e6,
            "edges_per_s": op.nnz * (K - 1) / med,
            "compile_s": first,
            "format": type(op).__name__}


def _node_train(op, hidden, K=25, C=512, n_classes=16):
    """Steady ms per NodeClassifier fwd+bwd+Adam step over ``op``."""
    import jax
    import jax.numpy as jnp
    import optax

    from cnn_graph_tpu.models import NodeClassifier
    from cnn_graph_tpu.utils.profiling import time_steady

    rng = np.random.default_rng(2)
    m = op.m_padded
    model = NodeClassifier(op, input_features=C, num_classes=n_classes,
                           hidden=hidden, K=K)
    params = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    state = opt.init(params)
    feats = jnp.asarray(rng.normal(size=(m, C)), jnp.float32)
    y = jnp.asarray(rng.integers(0, n_classes, m), jnp.int32)
    mask = jnp.ones((m,), bool)

    @jax.jit
    def step(op, params, state, feats, y, mask):
        mm = NodeClassifier(op, input_features=C, num_classes=n_classes,
                            hidden=hidden, K=K)
        loss, g = jax.value_and_grad(mm.loss)(params, feats, y, mask)
        up, state = opt.update(g, state, params)
        return optax.apply_updates(params, up), state, loss

    args = (op, params, state, feats, y, mask)
    first, med = time_steady(step, *args)
    loss = float(step(*args)[2])
    assert np.isfinite(loss), loss
    layers = len(hidden) + 1
    return {"ms_per_step": med * 1e3, "compile_s": first,
            "forward_hops": layers * (K - 1),
            "adjoint_hops": (layers - 1) * (K - 1)}


def _mnist(K=25, B=100, F=32):
    import jax
    import jax.numpy as jnp
    import optax

    from cnn_graph_tpu.graphs import coarsening, construction as gc
    from cnn_graph_tpu.models import ChebNet
    from cnn_graph_tpu.models import common as mcommon
    from cnn_graph_tpu.ops import cheby_conv, device_laplacian
    from cnn_graph_tpu.utils.profiling import time_steady

    W = gc.knn_graph(gc.grid(28), k=8)
    graphs, _ = coarsening.coarsen(W, levels=4, seed=2017, verbose=False)
    Ls = [gc.laplacian(g, normalized=True) for g in graphs]
    ops = [device_laplacian(L, fmt="dense") for L in Ls]
    rng = np.random.default_rng(0)
    m0 = ops[0].m
    x = jnp.asarray(rng.normal(size=(B, m0, F)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(K, F, F)) * 0.05, jnp.float32)
    conv = jax.jit(cheby_conv)
    first_c, med_c = time_steady(conv, x, ops[0], w)

    model = ChebNet(ops, F=[32, 64], K=[K, K], p=[4, 4], M=[512, 10],
                    dropout=0.5)
    gtree = mcommon.graph_arrays(model)  # graph data as jit arguments
    params = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    state = opt.init(params)
    xb = jnp.asarray(rng.normal(size=(B, m0)), jnp.float32)
    yb = jnp.asarray(rng.integers(0, 10, B), jnp.int32)

    @jax.jit
    def step(gtree, params, state, xb, yb, key):
        m = mcommon.with_graph_arrays(model, gtree)
        loss, g = jax.value_and_grad(m.loss)(params, xb, yb,
                                             train=True, rng=key)
        up, state = opt.update(g, state, params)
        return optax.apply_updates(params, up), state, loss

    first_s, med_s = time_steady(step, gtree, params, state, xb, yb,
                                 jax.random.PRNGKey(1))
    return {"graph_nodes": int(m0), "graph_nnz": int(ops[0].nnz),
            "conv_ms": med_c * 1e3,
            "conv_edges_per_s": ops[0].nnz * (K - 1) / med_c,
            "train_step_ms": med_s * 1e3,
            "epoch_s": med_s * 550,  # 55k samples / batch 100
            "compile_s": first_c + first_s}


def _city(side, K=25, C=512, train=True):
    import jax.numpy as jnp

    from cnn_graph_tpu.data.synthetic import city_graph
    from cnn_graph_tpu.ops import device_laplacian, quantize_banded

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    L, _ = city_graph(side, k=8, seed=0)
    op = device_laplacian(L, fmt="auto", dtype=jnp.bfloat16)
    setup_s = time.perf_counter() - t0
    x = jnp.asarray(rng.normal(size=(op.m_padded, C)), jnp.bfloat16)
    out = {"nodes": int(op.m), "nnz": int(op.nnz), "setup_s": setup_s,
           "bf16": _chain_rate(op, x, K),
           "int8": _chain_rate(quantize_banded(op, sample_x=3.0), x, K,
                               quant=True)}
    if train:
        out["train_single"] = _node_train(op, [])
        out["train_deep"] = _node_train(op, [512])
    return out


def _scattered(K=5, C=512, n_emb=10000, n_knn=50000):
    import jax.numpy as jnp

    from cnn_graph_tpu.graphs import construction as gc
    from cnn_graph_tpu.ops import (
        device_laplacian,
        quantize_block_sparse,
        quantize_dense,
    )

    def graph(n, dim, k, seed):
        rng = np.random.default_rng(seed)
        centres = rng.normal(0, 1, (20, dim))
        z = (centres[rng.integers(0, 20, n)]
             + rng.normal(0, 0.6, (n, dim))).astype(np.float32)
        dist, idx = gc.knn(z, k=k, algorithm="auto")
        W = gc.adjacency(dist, idx)
        perm = gc.bandwidth_reducing_permutation(W)
        return gc.laplacian(W[perm][:, perm].tocsr(), normalized=True)

    rng = np.random.default_rng(0)
    op = device_laplacian(graph(n_emb, 64, 16, 0), fmt="dense",
                          dtype=jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=(op.m_padded, C)), jnp.bfloat16)
    out = {"emb10k": {"nodes": int(op.m), "nnz": int(op.nnz),
                      "bf16": _chain_rate(op, x, K),
                      "int8": _chain_rate(quantize_dense(op, sample_x=3.0),
                                          x, K, quant=True)}}
    bop = device_laplacian(graph(n_knn, 8, 10, 1), fmt="bsr",
                           dtype=jnp.bfloat16)
    xb = jnp.asarray(rng.normal(size=(bop.m_padded, C)), jnp.bfloat16)
    out["knn50k_bsr"] = {
        "nodes": int(bop.m),
        "nonzero_tiles": bop.n_tiles,
        "stored_tiles": int(bop.blocks.shape[0]),  # grouped rows, padded
        "bf16": _chain_rate(bop, xb, 25),
        "int8": _chain_rate(quantize_block_sparse(bop, sample_x=3.0), xb,
                            25, quant=True)}
    return out


def main():
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform {devices[0].platform!r})")
    from cnn_graph_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    card = _card()
    print(f"benchmarking on {card} ({device})", file=sys.stderr)

    details = {"device": device, "card": card, "jax": jax.__version__}
    details["mnist"] = _mnist()
    details["city50k"] = _city(224)
    details["city100k"] = _city(316, train=False)
    details["scattered"] = _scattered()

    big = details["city50k"]
    best = max(("bf16", "int8"), key=lambda k: big[k]["edges_per_s"])
    headline = big[best]["edges_per_s"] / 1e9
    anchor = 2.0e12 / (8 * 512) / 1e9  # Gedges/s, A100 roofline at C=512
    details["headline_source"] = f"city50k_{best}"
    print(json.dumps({
        "metric": "chebyshev_spmm_edge_throughput", "value": headline,
        "unit": "Gedges/s/card", "vs_baseline": headline / anchor,
        "details": details,
    }))


if __name__ == "__main__":
    main()
