#!/usr/bin/env python
"""Hyper-parameter sweep over forecasting models (gconvTest.py equivalent).

Grid: sequence lengths x learning rates x variants x layer counts, each
trial isolated (one failure doesn't kill the grid, gconvTest.py:113-114),
reporting RMSE + MAPE per combo and a final ranking.

Run:  python experiments/gconv_sweep.py [--data-dir DIR] [--trials-limit N]
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _common  # noqa: F401  (persistent compile cache)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--nodes", type=int, default=48)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--trials-limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import itertools

    import numpy as np
    import scipy.io
    from scipy.sparse import csr_matrix
    from cnn_graph_tpu.data.humantraffic import HumanTraffic
    from cnn_graph_tpu.data.synthetic import synthetic_flow
    from cnn_graph_tpu.graphs import construction as gc
    from cnn_graph_tpu.models import GConvForecaster
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.train import TrainConfig, Trainer
    from cnn_graph_tpu.utils.metrics import mape, rmse

    data_dir = args.data_dir
    if data_dir is None:
        data_dir = tempfile.mkdtemp(prefix="flow_")
        in_m, out_m, edges = synthetic_flow(
            n_nodes=args.nodes, n_steps=1400, seed=args.seed
        )
        scipy.io.savemat(os.path.join(data_dir, "ln_data.mat"),
                         {"inmatrix": in_m, "outmatrix": out_m})
        scipy.io.savemat(os.path.join(data_dir, "edge_matrix.mat"),
                         {"edge_matrix": edges})

    # The gconvTest.py:82-111 grid, trimmed to tractable defaults.
    grid = list(itertools.product(
        [3, 4],                      # seq_num_closeness
        [1e-3, 5e-3],                # learning rate
        ["glstm", "glstm_gconv"],    # infer variant
        [1, 2],                      # lstm layer count
    ))
    if args.trials_limit:
        grid = grid[: args.trials_limit]
    print(f"sweep: {len(grid)} trials")

    results = []
    for seq, lr, variant, layers in grid:
        tag = f"seq={seq} lr={lr} variant={variant} layers={layers}"
        try:
            ht = HumanTraffic(data_dir)
            # gLSTM variants reshape channels by the closeness length, so
            # they need closeness-only windows (the reference's mixed grid
            # simply let such combos fail inside its try/except,
            # gconvTest.py:113-114; we load matching windows instead).
            tr, va, te, trl, val, tel, edges = ht.load_ln_data_period(
                seq, 0, 0
            )
            L = gc.laplacian(csr_matrix(edges), normalized=True)
            op = device_laplacian(L)
            model = GConvForecaster(
                op, seq_closeness=seq, variant=variant,
                num_hidden=32, lstm_layer_count=layers,
            )
            cfg = TrainConfig(
                num_epochs=args.epochs, learning_rate=lr,
                decay_steps=max(tr.shape[0] // 50, 1), batch_size=50,
                eval_frequency=10**9, seed=args.seed,
            )
            trainer = Trainer(model, cfg, task="regression")
            trainer.fit(tr.astype(np.float32), trl.astype(np.float32),
                        va.astype(np.float32), val.astype(np.float32),
                        verbose=False)
            _, metrics = trainer.evaluate(
                te.astype(np.float32), tel.astype(np.float32)
            )
            r = rmse(ht.reverse_normalize(tel),
                     ht.reverse_normalize(metrics["predictions"]))
            m = mape(ht.reverse_normalize(tel),
                     ht.reverse_normalize(metrics["predictions"]))
            print(f"{model.to_string()} | RMSE {r:.4f} | MAPE {m:.4f}")
            results.append((tag, r, m))
        except Exception as e:  # per-trial isolation
            print(f"{tag} FAILED: {type(e).__name__}: {e}")
            results.append((tag, float("inf"), float("inf")))

    print("\n=== ranking (by RMSE) ===")
    for tag, r, m in sorted(results, key=lambda t: t[1]):
        print(f"RMSE {r:9.4f}  MAPE {m:7.4f}  {tag}")


if __name__ == "__main__":
    main()
