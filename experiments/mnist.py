#!/usr/bin/env python
"""MNIST grid-graph classification: the reference's headline experiment.

28x28 8-NN grid graph, 4-level Graclus coarsening, ChebNet with the paper
config (F=[32,64], K=[25,25], p=[4,4], M=[512,10] — nips2016/mnist.ipynb
cells 14-17; paper Table 2 reports 99.14% with it).  Uses real IDX files
when ``--data-dir`` is given, else the synthetic class-structured digits
(this environment cannot download datasets).

Run:  python experiments/mnist.py [--data-dir /path/to/mnist] [--epochs 20]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _common  # noqa: F401  (persistent compile cache)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--K", type=int, default=25)
    p.add_argument("--filter", default="chebyshev",
                   choices=["chebyshev", "fourier", "spline", "lanczos"])
    p.add_argument("--mesh-data", type=int, default=0,
                   help="batch data parallelism: shard each batch over "
                        "an N-device 'data' mesh axis (TrainConfig.mesh)")
    p.add_argument("--n-train", type=int, default=55000,
                   help="synthetic-data size when no --data-dir")
    p.add_argument("--edge-noise", dest="edge_noise", type=float,
                   default=0.0,
                   help="fraction of graph edges replaced with random "
                        "ones (robustness experiment, mnist.ipynb cell 3)")
    p.add_argument("--seed", type=int, default=2017)
    args = p.parse_args()

    import numpy as np
    from cnn_graph_tpu.data.mnist import (
        load_mnist, mnist_graph_data, synthetic_mnist,
    )
    from cnn_graph_tpu.models import ChebNet
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.train import TrainConfig, Trainer

    if args.data_dir:
        tr_x, tr_y, te_x, te_y = load_mnist(args.data_dir)
        # Reference split: 55k train / 5k val (mnist.ipynb cell 5).  For
        # smaller drops (e.g. the IDX fixture test) fall back to 90/10
        # with at least one validation sample.
        n_tr = min(55000, max(len(tr_x) - max(len(tr_x) // 10, 1), 1))
        splits = {
            "train_data": tr_x[:n_tr], "train_labels": tr_y[:n_tr],
            "val_data": tr_x[n_tr:], "val_labels": tr_y[n_tr:],
            "test_data": te_x, "test_labels": te_y,
        }
    else:
        print("no --data-dir: using synthetic class-structured digits")
        splits = synthetic_mnist(n_train=args.n_train, seed=args.seed)

    splits, Ls, perm = mnist_graph_data(splits, k=8, levels=4,
                                        seed=args.seed,
                                        edge_noise=args.edge_noise)
    ops = [device_laplacian(L) for L in Ls]

    model = ChebNet(
        ops, F=[32, 64], K=[args.K, args.K], p=[4, 4], M=[512, 10],
        laplacians=Ls, filter=args.filter, dropout=0.5,
        regularization=5e-4,
    )
    mesh = None
    if args.mesh_data:
        from cnn_graph_tpu.parallel import make_mesh

        mesh = make_mesh(data=args.mesh_data, nodes=1)
        print(f"data-parallel training over mesh {dict(mesh.shape)}")
    n = splits["train_data"].shape[0]
    cfg = TrainConfig(
        num_epochs=args.epochs, learning_rate=args.learning_rate,
        decay_rate=0.95, decay_steps=n // args.batch_size,
        batch_size=args.batch_size, eval_frequency=200, seed=args.seed,
        mesh=mesh,
    )
    trainer = Trainer(model, cfg, task="classification")
    hist, losses, t_step = trainer.fit(
        splits["train_data"], splits["train_labels"],
        splits["val_data"], splits["val_labels"],
    )
    string, metrics = trainer.evaluate(
        splits["test_data"], splits["test_labels"]
    )
    print(f"test  {string}")
    print(f"time per step: {t_step * 1000:.2f} ms")


if __name__ == "__main__":
    main()
