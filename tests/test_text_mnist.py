"""Tests for the text toolkit and MNIST pipeline (synthetic corpora)."""

import numpy as np
import pytest

from cnn_graph_tpu.data.mnist import mnist_graph_data, synthetic_mnist
from cnn_graph_tpu.data.text import TextDataset, synthetic_text_dataset


class TestTextToolkit:
    @pytest.fixture(scope="class")
    def corpus(self):
        ds = synthetic_text_dataset(n_docs=200, vocab_size=120, n_classes=4,
                                    seed=0)
        ds.clean_text()
        ds.vectorize()
        return ds

    def test_clean_text_rules(self):
        ds = TextDataset()
        ds.documents = ["Hello WORLD 123, costs $5!"]
        ds.labels = np.array([0])
        ds.clean_text(num="substitute")
        assert ds.documents[0] == "hello world num costs dollar num"

    def test_vectorize_shapes(self, corpus):
        N, M = corpus.data.shape
        assert N == 200
        assert M == len(corpus.vocab) <= 120

    def test_remove_short_documents(self):
        ds = synthetic_text_dataset(n_docs=50, seed=1)
        ds.documents[0] = "w0001 w0002"  # 2 words only
        ds.clean_text()
        ds.vectorize()
        n_before = ds.data.shape[0]
        ds.remove_short_documents(nwords=10, vocab="full")
        assert ds.data.shape[0] < n_before

    def test_keep_top_words(self, corpus):
        import copy

        ds = copy.deepcopy(corpus)
        ds.keep_top_words(50, Mprint=0)
        assert len(ds.vocab) == 50
        assert ds.data.shape[1] == 50

    def test_embed_clusters_by_class_band(self, corpus):
        emb = corpus.embed(size=16, seed=0)
        assert emb.shape == (len(corpus.vocab), 16)
        assert np.all(np.isfinite(emb))
        # Words from the same class band should be closer on average than
        # words from different bands.
        def wid(w):  # decode the base-26 synthetic word id
            return sum((ord(c) - 97) * 26**k for k, c in enumerate(w[1:]))

        idx = {w: i for i, w in enumerate(corpus.vocab)}
        band0 = [idx[w] for w in corpus.vocab if wid(w) < 30][:10]
        band2 = [idx[w] for w in corpus.vocab if 60 <= wid(w) < 90][:10]
        if len(band0) >= 5 and len(band2) >= 5:
            def norm_rows(a):
                return a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-9)
            e = norm_rows(emb)
            within = e[band0] @ e[band0].T
            across = e[band0] @ e[band2].T
            assert within.mean() > across.mean()

    def test_normalize_unit_l1(self, corpus):
        import copy

        ds = copy.deepcopy(corpus)
        ds.normalize("l1")
        sums = np.asarray(np.abs(ds.data).sum(axis=1)).ravel()
        np.testing.assert_allclose(sums[sums > 0], 1.0, atol=1e-9)


class TestMnistPipeline:
    def test_synthetic_shapes(self):
        s = synthetic_mnist(n_train=200, n_val=50, n_test=100, seed=0)
        assert s["train_data"].shape == (200, 784)
        assert s["test_labels"].shape == (100,)
        assert s["train_data"].min() >= 0

    def test_graph_pipeline(self):
        s = synthetic_mnist(n_train=100, n_val=20, n_test=30, seed=0)
        out, Ls, perm = mnist_graph_data(s, k=8, levels=4)
        assert len(Ls) == 5
        assert out["train_data"].shape[1] == Ls[0].shape[0]
        assert Ls[0].shape[0] >= 784
        # Permutation preserves pixel values (plus zero fake nodes).
        assert out["train_data"].sum() == pytest.approx(
            s["train_data"].sum(), rel=1e-5
        )

    def test_classes_separable_by_template(self):
        # Nearest-template classification should be far above chance,
        # i.e. the synthetic data carries class signal for the benchmark.
        s = synthetic_mnist(n_train=500, n_val=10, n_test=200, seed=0)
        templates = np.stack([
            s["train_data"][s["train_labels"] == c].mean(axis=0)
            for c in range(10)
        ])
        pred = np.argmax(s["test_data"] @ templates.T, axis=1)
        acc = np.mean(pred == s["test_labels"])
        assert acc > 0.5

    def test_load_mnist_missing_raises(self, tmp_path):
        from cnn_graph_tpu.data.mnist import load_mnist

        with pytest.raises(FileNotFoundError, match="cannot download"):
            load_mnist(str(tmp_path))

    def test_load_mnist_reads_idx_fixture_bitexact(self, tmp_path):
        """Hand-crafted IDX files (the exact on-disk MNIST format,
        including one .gz member) round-trip bit-exactly, so real-data
        parity is one file-drop away."""
        import gzip
        import struct

        from cnn_graph_tpu.data.mnist import load_mnist

        rng = np.random.default_rng(3)
        tr_img = rng.integers(0, 256, (2, 28, 28)).astype(np.uint8)
        tr_lab = np.array([3, 7], np.uint8)
        te_img = rng.integers(0, 256, (1, 28, 28)).astype(np.uint8)
        te_lab = np.array([9], np.uint8)

        def idx_bytes(arr):
            header = struct.pack(">HBB", 0, 0x08, arr.ndim)
            header += struct.pack(f">{arr.ndim}I", *arr.shape)
            return header + arr.tobytes()

        (tmp_path / "train-images-idx3-ubyte").write_bytes(idx_bytes(tr_img))
        (tmp_path / "train-labels-idx1-ubyte").write_bytes(idx_bytes(tr_lab))
        # Cover the gzip branch with the test-set pair.
        with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
            f.write(idx_bytes(te_img))
        (tmp_path / "t10k-labels-idx1-ubyte").write_bytes(idx_bytes(te_lab))

        trx, try_, tex, tey = load_mnist(str(tmp_path))
        assert trx.shape == (2, 784) and trx.dtype == np.float32
        np.testing.assert_array_equal(trx * 255.0,
                                      tr_img.reshape(2, 784).astype(np.float32))
        np.testing.assert_array_equal(try_, tr_lab.astype(np.int64))
        np.testing.assert_array_equal(tex * 255.0,
                                      te_img.reshape(1, 784).astype(np.float32))
        np.testing.assert_array_equal(tey, te_lab.astype(np.int64))

    def test_edge_noise_perturbs_graph_and_degrades_gracefully(self):
        """``edge_noise`` rewires the pipeline's grid graph (parity with
        replace_random_edges in mnist.ipynb cell 3) and a small model
        still trains well above chance through the perturbed graph."""
        import jax

        from cnn_graph_tpu.models import ChebNet
        from cnn_graph_tpu.ops import device_laplacian
        from cnn_graph_tpu.train import TrainConfig, Trainer

        s = synthetic_mnist(n_train=300, n_val=50, n_test=100, seed=0)
        clean, Ls0, _ = mnist_graph_data(s, k=8, levels=4, edge_noise=0.0)
        noisy, Ls1, _ = mnist_graph_data(s, k=8, levels=4, edge_noise=0.2)
        # The finest Laplacian actually changed (rewiring also shifts the
        # coarsening, so padded sizes may differ too).
        assert (Ls0[0].shape != Ls1[0].shape
                or (Ls0[0] != Ls1[0]).nnz > 0)

        ops = [device_laplacian(L) for L in Ls1]
        model = ChebNet(ops, F=[8], K=[5], p=[4], M=[10], dropout=1.0)
        cfg = TrainConfig(num_epochs=4, learning_rate=2e-3, batch_size=50,
                          eval_frequency=100, seed=0)
        trainer = Trainer(model, cfg, task="classification")
        trainer.fit(noisy["train_data"], noisy["train_labels"],
                    noisy["val_data"], noisy["val_labels"])
        _, metrics = trainer.evaluate(noisy["test_data"],
                                      noisy["test_labels"])
        assert metrics["accuracy"] > 0.3  # graceful: well above 0.1 chance
