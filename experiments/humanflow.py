#!/usr/bin/env python
"""Human-flow forecasting: ResGNN / gconvLSTM over a city region graph.

The counterpart of nips2016/humanflow*.py + gconvTest.py: load
a HumanTraffic dataset directory (.mat files), build the region-graph
Laplacian from the edge matrix, train a forecasting model, and report
RMSE (after reverse-normalization, humanflow.py:183-184) and MAPE over
targets > 20 (gconvTest.py:178-183).  Without ``--data-dir`` a synthetic
flow dataset with the same structure is fabricated.

Run:
  python experiments/humanflow.py --model resgnn --nres 4
  python experiments/humanflow.py --model glstm --variant glstm_gconv
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _common  # noqa: F401  (persistent compile cache)


def write_synthetic(data_dir, nodes, seed):
    """Fabricate a HumanTraffic-shaped dataset directory (.mat files)
    from ``data.synthetic.synthetic_flow``."""
    import numpy as np
    import scipy.io
    from cnn_graph_tpu.data.synthetic import synthetic_flow

    in_m, out_m, edges = synthetic_flow(
        n_nodes=nodes, n_steps=1400, seed=seed
    )
    rng = np.random.default_rng(seed + 1)
    frac = rng.uniform(0.3, 0.7, in_m.shape)
    split_in = np.stack([in_m * frac, in_m * (1 - frac)], axis=2)
    frac = rng.uniform(0.3, 0.7, out_m.shape)
    split_out = np.stack([out_m * frac, out_m * (1 - frac)], axis=2)
    scipy.io.savemat(
        os.path.join(data_dir, "ln_data.mat"),
        {"inmatrix": in_m, "outmatrix": out_m,
         "split_in_traffic": split_in, "split_out_traffic": split_out},
    )
    scipy.io.savemat(os.path.join(data_dir, "edge_matrix.mat"),
                     {"edge_matrix": edges})
    # BJ-style files: grid-shaped node count for the bj loader, and a
    # cluster variant with a missing-data (-1) stretch.
    scipy.io.savemat(os.path.join(data_dir, "bj_data.mat"),
                     {"inmatrix": in_m, "outmatrix": out_m})
    in_bad = in_m.copy()
    in_bad[:, 700:705] = -1
    scipy.io.savemat(os.path.join(data_dir, "bj_clus.mat"),
                     {"inmatrix": in_bad, "outmatrix": out_m})


def build_dataset(args):
    from cnn_graph_tpu.data.humantraffic import HumanTraffic

    data_dir = args.data_dir
    if data_dir is None:
        print("no --data-dir: fabricating a synthetic flow dataset")
        data_dir = tempfile.mkdtemp(prefix="flow_")
        write_synthetic(data_dir, args.nodes, args.seed)

    ht = HumanTraffic(data_dir)
    loaders = {
        "ln_period": lambda: ht.load_ln_data_period(
            args.seq, args.seq_period, args.seq_trend, args.datafile
        ),
        "street": lambda: ht.load_lndata_street(args.seq, args.datafile),
        "unisolate": lambda: ht.load_unisolate_data(args.seq),
        "threshold": lambda: ht.load_data(args.seq),
        "split_ln": lambda: ht.load_split_ln_data(args.seq, args.datafile),
        "split_ln_period": lambda: ht.load_split_ln_data_period(
            args.seq, args.seq_period, args.seq_trend, args.datafile
        ),
        "bj": lambda: (*ht.load_bj_data(args.seq), None),
        "bj_clus": lambda: ht.load_bj_clus_data(args.seq),
        "bj_clus_period": lambda: ht.load_bj_clus_period_trend(args.seq),
    }
    out = loaders[args.loader]()
    tr, va, te, trl, val, tel = out[:6]
    edges = out[6] if len(out) > 6 else None
    if edges is None:
        # bj_data ships no edge matrix (humantraffic.py:163): build an
        # 8-NN grid graph over the region lattice like humanflow.py:73-88.
        import math

        from cnn_graph_tpu.graphs import construction as _gc

        side = int(math.isqrt(tr.shape[1]))
        assert side * side == tr.shape[1], "bj grid must be square"
        edges = _gc.knn_graph(_gc.grid(side), k=8)
    return ht, (tr, va, te, trl, val, tel), edges


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--datafile", default="ln_data.mat")
    p.add_argument("--loader", default="ln_period",
                   choices=["ln_period", "street", "unisolate", "threshold",
                            "split_ln", "split_ln_period", "bj", "bj_clus",
                            "bj_clus_period"])
    p.add_argument("--model", default="resgnn",
                   choices=["resgnn", "glstm", "lstm"],
                   help="'lstm' is the graph-free per-node LSTM baseline "
                        "the graph models are judged against "
                        "(humantraffic.py:354-383 load_lstm_data)")
    p.add_argument("--variant", default="glstm_gconv")
    p.add_argument("--filter", default="chebyshev",
                   choices=["chebyshev", "fourier"],
                   help="spectral filter for resgnn (the fork's shortlong "
                        "experiments run ResGNN with fourier)")
    p.add_argument("--seq", type=int, default=4)
    p.add_argument("--seq-period", dest="seq_period", type=int, default=1)
    p.add_argument("--seq-trend", dest="seq_trend", type=int, default=1)
    p.add_argument("--nres", type=int, default=4)
    p.add_argument("--nfilter", type=int, default=64)
    p.add_argument("--K", type=int, default=2)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--nodes", type=int, default=64,
                   help="synthetic graph size without --data-dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-predictions", default=None,
                   help=".mat path for test predictions (gconvTest.py:171)")
    return p.parse_args(argv)


def build(args, edges, tr):
    """The graph model (resgnn | glstm) and its TrainConfig."""
    from scipy.sparse import csr_matrix
    from cnn_graph_tpu.graphs import construction as gc
    from cnn_graph_tpu.models import GConvForecaster, ResGNN
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.train import TrainConfig

    L = gc.laplacian(csr_matrix(edges), normalized=True)
    op = device_laplacian(L)

    C = tr.shape[2]
    if args.model == "resgnn":
        fourier_u = None
        if args.filter == "fourier":
            import jax.numpy as jnp

            _, U = gc.fourier(L)
            fourier_u = jnp.asarray(U, jnp.float32)
        model = ResGNN(op, input_features=C, K=args.K,
                       nfilter=args.nfilter, nres_layer_count=args.nres,
                       filter=args.filter, fourier_u=fourier_u)
    else:
        model = GConvForecaster(
            op, seq_closeness=args.seq, seq_period=args.seq_period,
            seq_trend=args.seq_trend, variant=args.variant,
            num_hidden=args.nfilter, K=args.K,
        )
        print("model:", model.to_string())

    cfg = TrainConfig(
        num_epochs=args.epochs, learning_rate=args.learning_rate,
        decay_rate=0.95, decay_steps=max(tr.shape[0] // args.batch_size, 1),
        batch_size=args.batch_size, eval_frequency=100, seed=args.seed,
    )
    return model, cfg


def main():
    args = parse_args()

    import numpy as np
    import scipy.io
    from cnn_graph_tpu.train import TrainConfig, Trainer
    from cnn_graph_tpu.utils.metrics import mape, rmse

    ht, (tr, va, te, trl, val, tel), edges = build_dataset(args)

    if args.model == "lstm":
        # Graph-free baseline: M independent per-node LSTMs trained in
        # one jitted program (models/node_lstm.py).  The reference's
        # loader has no val split (85/15 train/test,
        # humantraffic.py:354-383); test doubles as the fit-time eval.
        from cnn_graph_tpu.models import PerNodeLSTM, stack_lstm_collection

        coll = ht.load_lstm_data(args.seq, 0, args.datafile)
        d = stack_lstm_collection(coll)
        model = PerNodeLSTM(n_nodes=d["train_data"].shape[1], seq=args.seq,
                            num_hidden=args.nfilter)
        cfg = TrainConfig(
            num_epochs=args.epochs, learning_rate=args.learning_rate,
            decay_rate=0.95,
            decay_steps=max(d["train_data"].shape[0] // args.batch_size, 1),
            batch_size=args.batch_size, eval_frequency=100, seed=args.seed,
        )
        trainer = Trainer(model, cfg, task="regression")
        trainer.fit(d["train_data"], d["train_labels"],
                    d["test_data"], d["test_labels"])
        string, metrics = trainer.evaluate(d["test_data"], d["test_labels"])
        print(f"test  {string}")
        preds_real = ht.reverse_normalize(metrics["predictions"])
        targets_real = ht.reverse_normalize(d["test_labels"])
        print(f"RMSE (real units): {rmse(targets_real, preds_real):.4f}")
        print(f"MAPE (targets>20): {mape(targets_real, preds_real):.4f}")
        if args.save_predictions:
            scipy.io.savemat(
                args.save_predictions,
                {"predictions": preds_real, "targets": targets_real},
            )
            print(f"saved predictions to {args.save_predictions}")
        return

    model, cfg = build(args, edges, tr)
    trainer = Trainer(model, cfg, task="regression")
    trainer.fit(tr.astype(np.float32), trl.astype(np.float32),
                va.astype(np.float32), val.astype(np.float32))
    string, metrics = trainer.evaluate(
        te.astype(np.float32), tel.astype(np.float32)
    )
    print(f"test  {string}")

    preds_real = ht.reverse_normalize(metrics["predictions"])
    targets_real = ht.reverse_normalize(tel)
    print(f"RMSE (real units): {rmse(targets_real, preds_real):.4f}")
    print(f"MAPE (targets>20): {mape(targets_real, preds_real):.4f}")

    if args.save_predictions:
        scipy.io.savemat(
            args.save_predictions,
            {"predictions": preds_real, "targets": targets_real},
        )
        print(f"saved predictions to {args.save_predictions}")


if __name__ == "__main__":
    main()
