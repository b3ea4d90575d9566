#!/usr/bin/env python
"""RCV1 text classification over a word graph (rcv1.ipynb equivalent).

The reference's rcv1.ipynb: fetch RCV1, keep selected categories, keep
single-label documents, vectorize/normalize, embed words, kNN word graph,
ChebNet classification.  RCV1 requires a local sklearn cache (no egress
here); without it the script falls back to a synthetic corpus shaped like
the selected-category subset.

Run:  python experiments/rcv1.py [--classes C15 C18 C31 ...]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _common  # noqa: F401  (persistent compile cache)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--classes", nargs="*", default=["CCAT", "ECAT", "GCAT",
                                                    "MCAT"])
    p.add_argument("--top-words", type=int, default=1000)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import numpy as np
    from cnn_graph_tpu.data.text import TextRCV1, synthetic_text_dataset
    from cnn_graph_tpu.graphs import construction as gc
    from cnn_graph_tpu.models import ChebNet
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.train import TrainConfig, Trainer

    try:
        ds = TextRCV1()
        ds.remove_classes(args.classes)
        ds.select_documents()
        ds.vocab = [f"w{i}" for i in range(ds.data.shape[1])]
        # RCV1 ships pre-vectorized tf-idf; keep the top words FIRST so
        # the word-similarity space below stays [top_words, dim]-sized.
        ds.keep_top_words(args.top_words, Mprint=0)
        X = ds.data
        # Word embedding = truncated SVD of the doc-term matrix (word
        # loadings), replacing word2vec for pre-vectorized input.
        import scipy.sparse.linalg

        _, s, vt = scipy.sparse.linalg.svds(
            X.astype(np.float64), k=min(64, X.shape[1] - 1), rng=args.seed
        )
        emb = (vt.T * s).astype(np.float32)
    except RuntimeError as e:
        print(f"{e}\nfalling back to a synthetic corpus")
        ds = synthetic_text_dataset(n_docs=1500, vocab_size=800,
                                    n_classes=len(args.classes),
                                    seed=args.seed)
        ds.clean_text()
        ds.vectorize()
        ds.keep_top_words(args.top_words, Mprint=0)
        ds.normalize("l1")
        emb = ds.embed(size=64, seed=args.seed)
        X = ds.data

    W = gc.knn_graph(np.asarray(emb, np.float64), k=args.knn)
    L = gc.laplacian(W, normalized=True)
    op = device_laplacian(L)

    Xd = np.asarray(X.todense(), np.float32)
    y = ds.labels.astype(np.int64)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(y))
    Xd, y = Xd[order], y[order]
    ntr, nva = int(len(y) * 0.7), int(len(y) * 0.1)

    C = int(y.max()) + 1
    model = ChebNet([op], F=[32], K=[5], p=[1], M=[C], dropout=0.5,
                    regularization=1e-3)
    cfg = TrainConfig(num_epochs=args.epochs, learning_rate=5e-3,
                      decay_rate=0.95, decay_steps=max(ntr // 100, 1),
                      batch_size=100, eval_frequency=100, seed=args.seed)
    trainer = Trainer(model, cfg, task="classification")
    trainer.fit(Xd[:ntr], y[:ntr], Xd[ntr:ntr + nva], y[ntr:ntr + nva])
    string, _ = trainer.evaluate(Xd[ntr + nva:], y[ntr + nva:])
    print(f"test  {string}")


if __name__ == "__main__":
    main()
