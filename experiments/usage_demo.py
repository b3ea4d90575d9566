#!/usr/bin/env python
"""End-to-end classification demo: the usage.ipynb scenario as a CLI.

Synthetic community-structured features -> kNN feature graph -> coarsening
-> ChebNet (F=[32,64], K=[20,20], p=[4,2], M=[512,C]) -> fit/evaluate,
reproducing usage.ipynb cells 3-18 (the reference's CPU-runnable
walkthrough).  Run:  python experiments/usage_demo.py [--epochs 40]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _common  # noqa: F401  (persistent compile cache)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=10000)
    p.add_argument("--d", type=int, default=100)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=2e-3)
    p.add_argument("--pool", choices=["max", "average"], default="average")
    p.add_argument("--filter", default="chebyshev",
                   choices=["chebyshev", "fourier", "spline"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import numpy as np
    from cnn_graph_tpu.data.synthetic import community_classification
    from cnn_graph_tpu.graphs import construction as gc
    from cnn_graph_tpu.models import ChebNet
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.train import TrainConfig, Trainer
    from cnn_graph_tpu.utils.harness import ModelPerf

    splits, graphs, _ = community_classification(
        n=args.n, d=args.d, seed=args.seed
    )
    Ls = [gc.laplacian(g, normalized=True) for g in graphs]
    ops = [device_laplacian(L) for L in Ls]

    C = int(splits["train_labels"].max()) + 1
    model = ChebNet(
        ops, F=[32, 64], K=[20, 20], p=[4, 2], M=[512, C],
        laplacians=Ls, filter=args.filter, pool=args.pool,
        dropout=0.5, regularization=5e-4,
    )
    cfg = TrainConfig(
        num_epochs=args.epochs, learning_rate=args.learning_rate,
        decay_rate=0.95, decay_steps=args.n // args.batch_size,
        batch_size=args.batch_size, eval_frequency=200, seed=2017,
    )
    trainer = Trainer(model, cfg, task="classification")

    perf = ModelPerf()
    perf.test(
        trainer, "cgconv_softmax", vars(args),
        splits["train_data"], splits["train_labels"],
        splits["val_data"], splits["val_labels"],
        splits["test_data"], splits["test_labels"],
    )
    perf.show()


if __name__ == "__main__":
    main()
