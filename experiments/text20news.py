#!/usr/bin/env python
"""20NEWS-style text classification over a word-embedding graph.

The reference's nips2016/20news.ipynb pipeline: clean -> vectorize ->
filter short documents -> keep top-M words -> normalize -> embed -> kNN
word graph -> ChebNet GC32 (F=[32], K=[5], M=[C]); paper Table 4 reports
68.26%.  Uses the real corpus when sklearn has it cached locally, else a
synthetic topic corpus (no network egress here).  Also prints the
classical-baseline table (lib/utils.py:223-248 equivalent).

Run:  python experiments/text20news.py [--synthetic] [--top-words 1000]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _common  # noqa: F401  (persistent compile cache)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--top-words", type=int, default=1000)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--baselines", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import numpy as np
    from cnn_graph_tpu.data.text import Text20News, synthetic_text_dataset
    from cnn_graph_tpu.graphs import construction as gc
    from cnn_graph_tpu.models import ChebNet
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.train import TrainConfig, Trainer
    from cnn_graph_tpu.utils.harness import baseline

    if args.synthetic:
        ds = synthetic_text_dataset(n_docs=2000, vocab_size=1200,
                                    n_classes=8, seed=args.seed)
    else:
        try:
            ds = Text20News(subset="all")
        except RuntimeError as e:
            print(f"{e}\nfalling back to --synthetic")
            ds = synthetic_text_dataset(n_docs=2000, vocab_size=1200,
                                        n_classes=8, seed=args.seed)

    ds.clean_text(num="substitute")
    ds.vectorize(stop_words="english" if not args.synthetic else None)
    ds.remove_short_documents(nwords=20, vocab="full")
    ds.keep_top_words(args.top_words, Mprint=5)
    ds.normalize("l1")
    emb = ds.embed(size=args.embed_dim, seed=args.seed)

    W = gc.knn_graph(emb, k=args.knn)
    L = gc.laplacian(W, normalized=True)
    op = device_laplacian(L)

    X = np.asarray(ds.data.todense(), np.float32)
    y = ds.labels.astype(np.int64)
    n = len(y)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(n)
    X, y = X[order], y[order]
    ntr, nva = int(n * 0.7), int(n * 0.1)

    if args.baselines:
        baseline(X[:ntr], y[:ntr], X[ntr + nva:], y[ntr + nva:])

    C = int(y.max()) + 1
    model = ChebNet([op], F=[32], K=[5], p=[1], M=[C],
                    dropout=0.5, regularization=1e-3)
    cfg = TrainConfig(num_epochs=args.epochs, learning_rate=5e-3,
                      decay_rate=0.95, decay_steps=max(ntr // 100, 1),
                      batch_size=100, eval_frequency=100, seed=args.seed)
    trainer = Trainer(model, cfg, task="classification")
    trainer.fit(X[:ntr], y[:ntr], X[ntr:ntr + nva], y[ntr:ntr + nva])
    string, _ = trainer.evaluate(X[ntr + nva:], y[ntr + nva:])
    print(f"test  {string}")


if __name__ == "__main__":
    main()
