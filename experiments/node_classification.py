#!/usr/bin/env python
"""Large-graph transductive node classification (ogbn-style config).

BASELINE.json config 5 extends the reference family with node
classification at scale (papers100M, multi-host edge-partitioned
Chebyshev).  This driver trains a NodeClassifier over a synthetic
community graph through the block-sparse operator (single chip) or the
sparse-halo operator on a device mesh (``--mesh-nodes``; on the CPU with
JAX_PLATFORMS=cpu and a virtual device count).

Run:
  python experiments/node_classification.py --nodes 100000
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python experiments/node_classification.py --nodes 4096 --mesh-nodes 4
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _common  # noqa: F401  (persistent compile cache)


def build_graph(n_nodes, n_classes, feat_dim, seed):
    """Planted-partition graph on a planar layout: communities are
    spatial patches, so the kNN graph is RCM-bandable AND label-correlated."""
    import numpy as np
    from cnn_graph_tpu.graphs import construction as gc

    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_nodes)))
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([xs.ravel(), ys.ravel()], 1)[:n_nodes].astype(np.float32)
    pos += rng.normal(0, 0.3, pos.shape).astype(np.float32)

    # Community = spatial patch id hashed to a class.
    patch = (pos[:, 0] // (side / 8)).astype(int) * 8 + (
        pos[:, 1] // (side / 8)
    ).astype(int)
    labels = (patch % n_classes).astype(np.int64)

    # Features: class signature + noise.
    signatures = rng.normal(0, 1, (n_classes, feat_dim)).astype(np.float32)
    feats = signatures[labels] + rng.normal(0, 1.0, (n_nodes, feat_dim)
                                            ).astype(np.float32)

    dist, idx = gc.knn(pos, k=8, algorithm="auto")
    W = gc.adjacency(dist, idx)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return gc.laplacian(W, normalized=True), feats[perm], labels[perm]


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=100000)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--hidden", type=int, nargs="*", default=[64])
    p.add_argument("--K", type=int, default=3)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--train-frac", type=float, default=0.1)
    p.add_argument("--mesh-nodes", type=int, default=0,
                   help=">0: edge-partition over a (data=1, nodes=N) mesh")
    p.add_argument("--halo", choices=["sparse", "banded", "sparse-banded"],
                   default="banded",
                   help="sharded operator: banded ring-ppermute halo "
                        "(RCM city graphs), general block-sparse "
                        "all_to_all halo, or the all_to_all halo with a "
                        "per-shard banded kernel (locally-bandable "
                        "graphs)")
    p.add_argument("--int8", action="store_true",
                   help="after f32 training, quantize the operator to the "
                        "int8 serving path and report the accuracy delta + "
                        "inference timing (single chip, or sharded with "
                        "--mesh-nodes under any --halo: int8 carries over "
                        "the halo exchange, half the halo bytes)")
    p.add_argument("--export", metavar="DIR", default=None,
                   help="after training, write a deployable serving "
                        "artifact (StableHLO + leaves; cnn_graph_tpu."
                        "serve.export_serving) to DIR — int8 when --int8 "
                        "is set, f32 otherwise (single chip only)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from cnn_graph_tpu.models import NodeClassifier
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.parallel import (
        banded_halo_laplacian,
        make_mesh,
        sparse_halo_laplacian,
    )

    t0 = time.time()
    L, feats, labels = build_graph(args.nodes, args.classes, args.features,
                                   args.seed)
    print(f"graph: {L.shape[0]} nodes, {L.nnz} nnz "
          f"({time.time() - t0:.1f}s host precompute)")

    mesh = None
    if args.mesh_nodes > 0:
        mesh = make_mesh(data=jax.device_count() // args.mesh_nodes,
                         nodes=args.mesh_nodes)
        if args.halo == "banded":
            op = banded_halo_laplacian(L, mesh)
            print(f"banded-halo operator: band {tuple(op.band.shape[1:])} "
                  f"/shard, halo {op.halo_left}+{op.halo_right} block-rows "
                  f"via ring ppermute, mesh {dict(mesh.shape)}")
        elif args.halo == "sparse-banded":
            op = sparse_halo_laplacian(L, mesh, fmt="banded")
            print(f"sparse-banded operator: band "
                  f"{tuple(op.band.shape[2:])} x {op.band.shape[1]} "
                  f"block-rows/shard, halo {op.halo} rows/peer, "
                  f"mesh {dict(mesh.shape)}")
        else:
            op = sparse_halo_laplacian(L, mesh)
            print(f"sparse-halo operator: {op.n_tiles} nonzero tiles, "
                  f"{op.blocks.shape[1]} tile slots/shard, "
                  f"halo {op.halo} rows/peer, mesh {dict(mesh.shape)}")
    else:
        op = device_laplacian(L, fmt="auto")
        print(f"operator: {type(op).__name__}")

    m = op.m_padded
    fp = np.zeros((m, args.features), np.float32)
    fp[: len(feats)] = feats
    yp = np.zeros((m,), np.int64)
    yp[: len(labels)] = labels
    rng = np.random.default_rng(args.seed)
    mask = np.zeros(m, bool)
    mask[: len(labels)] = rng.random(len(labels)) < args.train_frac
    test_mask = np.zeros(m, bool)
    test_mask[: len(labels)] = ~mask[: len(labels)]

    features = jnp.asarray(fp)
    y = jnp.asarray(yp)
    train_mask = jnp.asarray(mask)

    def make_model(operator):
        return NodeClassifier(operator, input_features=args.features,
                              num_classes=args.classes, hidden=args.hidden,
                              K=args.K, dropout=0.8)

    model = make_model(op)
    params = model.init(jax.random.PRNGKey(args.seed))
    opt = optax.adam(args.learning_rate)
    state = opt.init(params)

    # The operator and the node data are jit ARGUMENTS, not closures:
    # closure-captured arrays become compile-time constants embedded in
    # the serialized module, which blows up compile payloads at large
    # graph sizes (operators are pytrees, so passing them is free).
    @jax.jit
    def run(operator, params, state, key, features, y, train_mask):
        m = make_model(operator)

        def step(carry, _):
            params, state, key = carry
            key, sk = jax.random.split(key)
            loss, grads = jax.value_and_grad(m.loss)(
                params, features, y, train_mask, train=True, rng=sk
            )
            updates, state = opt.update(grads, state, params)
            return (optax.apply_updates(params, updates), state, key), loss

        (params, state, _), losses = jax.lax.scan(
            step, (params, state, key), None, length=args.steps
        )
        return params, state, losses

    @jax.jit
    def masked_accuracy(operator, params, features, y, mask):
        return make_model(operator).accuracy(params, features, y, mask)

    ctx = mesh if mesh is not None else _null_ctx()
    with ctx:
        t0 = time.time()
        params, state, losses = run(op, params, state,
                                    jax.random.PRNGKey(1), features, y,
                                    train_mask)
        jax.block_until_ready(losses)
        wall = time.time() - t0
        train_acc = float(masked_accuracy(op, params, features, y,
                                          train_mask))
        test_acc = float(masked_accuracy(op, params, features, y,
                                         jnp.asarray(test_mask)))
    losses = np.asarray(losses)
    print(f"trained {args.steps} steps in {wall:.1f}s "
          f"({wall / args.steps * 1000:.1f} ms/step incl. compile)")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} | "
          f"train acc {train_acc:.3f} | test acc {test_acc:.3f}")

    if args.int8:
        # Serving path: quantize the trained graph operator to int8 and
        # run the SAME model/params through it (cheby_conv dispatches on
        # the quantized protocol).  Reports the accuracy
        # delta vs f32 and steady-state inference time.  With
        # --mesh-nodes --halo banded, the quantized SHARDED operator
        # serves with int8 carries over the halo exchange.
        from cnn_graph_tpu.ops import (
            quantize_banded,
            quantize_block_sparse,
            quantize_dense,
        )
        from cnn_graph_tpu.ops.laplacian import (
            BandedLaplacian,
            BlockSparseLaplacian,
            DenseLaplacian,
        )
        from cnn_graph_tpu.parallel import (
            BandedHaloLaplacian,
            BandedSparseHaloLaplacian,
            SparseHaloLaplacian,
            quantize_banded_halo,
            quantize_sparse_halo,
        )

        sample = float(np.abs(fp).max())
        if isinstance(op, BandedHaloLaplacian):
            qop = quantize_banded_halo(op, sample_x=sample)
        elif isinstance(op, (SparseHaloLaplacian,
                             BandedSparseHaloLaplacian)):
            qop = quantize_sparse_halo(op, sample_x=sample)
        elif isinstance(op, DenseLaplacian):
            # Every single-chip format has an int8 twin: the trained
            # operator quantizes in place, whatever fmt="auto" picked.
            qop = quantize_dense(op, sample_x=sample)
        elif isinstance(op, BlockSparseLaplacian):
            qop = quantize_block_sparse(op, sample_x=sample)
        else:
            band_op = (op if isinstance(op, BandedLaplacian)
                       else device_laplacian(L, fmt="banded"))
            qop = quantize_banded(band_op, sample_x=sample)
        with ctx:
            int8_acc = float(masked_accuracy(qop, params, features, y,
                                             jnp.asarray(test_mask)))
        print(f"int8 test acc {int8_acc:.4f} "
              f"(delta vs f32 {int8_acc - test_acc:+.4f})")

        n_spmm = (len(args.hidden) + 1) * (args.K - 1)
        iters = 20

        @jax.jit
        def infer_chain(operator, params, features):
            m = make_model(operator)

            def body(carry, _):
                logits = m.apply(params, carry)
                # fold the output back into the input so the chain is
                # data-dependent (XLA would CSE independent repeats)
                carry = carry * (1.0 + 1e-6 * jnp.tanh(jnp.mean(logits)))
                return carry, ()

            out, _ = jax.lax.scan(body, features, None, length=iters)
            return jnp.mean(out ** 2)

        for name, o in (("f32 ", op), ("int8", qop)):
            with ctx:
                s = float(jax.device_get(infer_chain(o, params, features)))
                assert np.isfinite(s)
                t0 = time.time()
                jax.device_get(infer_chain(o, params, features))
                dt = (time.time() - t0) / iters
            print(f"{name} inference {dt * 1000:7.2f} ms/graph  "
                  f"{op.nnz * n_spmm / dt / 1e9:6.3f} Gedges/s "
                  f"({n_spmm} spmm/inference)")

    if args.export:
        assert mesh is None, (
            "--export is the single-chip artifact; shard at the serving "
            "layer by graph partition instead"
        )
        from cnn_graph_tpu import serve

        serve.export_serving(model, params, features, args.export,
                             int8=args.int8,
                             sample_x=float(np.abs(fp).max()))
        print(f"serving artifact written to {args.export} "
              f"(int8={args.int8}); load with "
              f"cnn_graph_tpu.serve.load_serving")


class _null_ctx:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


if __name__ == "__main__":
    main()
