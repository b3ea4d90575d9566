#!/usr/bin/env python
"""Halo-exchange bytes of the sharded banded operator, per shard count.

For n shards over the ``nodes`` mesh axis, prints the per-hop halo bytes
the banded-halo operator moves, the graph cut of the contiguous row
partition, the ideal exchange (every remote node referenced, once) and
the interior fraction available to hide the exchange behind
(overlap=True's budget).  Shapes only: it runs on virtual CPU devices.
The timed four-device path is ``python chip_smoke.py --multichip``.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python experiments/multichip.py comm [side] [n ...]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _common  # noqa: E402,F401


def main_comm(argv):
    """Exchanged bytes vs graph cut per shard count, CPU mesh."""
    import jax
    import numpy as np

    from cnn_graph_tpu.data.synthetic import city_graph
    from cnn_graph_tpu.parallel import banded_halo_laplacian, make_mesh

    side = int(argv[0]) if argv else 224
    C, e = 512, 2  # bf16 activations; int8 serving carries halve MB/hop
    L, _ = city_graph(side, k=8, seed=0)
    m = L.shape[0]
    print(f"nodes={m} nnz={L.nnz} C={C} bf16 "
          f"(int8 serving: MB/hop and MB_ideal halve)")
    print(f"{'n':>2} {'h_l':>4} {'h_r':>4} {'MB/hop':>8} {'MB_int8':>8} "
          f"{'cut_edges':>10} "
          f"{'bnd_nodes':>10} {'MB_ideal':>9} {'ratio':>6} {'interior%':>9}")
    for n in argv[1:] or (2, 4, 8):
        n = int(n)
        if jax.device_count() % n:
            print(f"{n:>2}  (skipped: device_count={jax.device_count()})")
            continue
        mesh = make_mesh(data=jax.device_count() // n, nodes=n)
        op = banded_halo_laplacian(L, mesh)
        br = op.block_shape[0]
        # total bytes moved per hop: each directed halo is sent by n-1
        # shards (the two end shards have one neighbour each).
        bytes_hop = (n - 1) * (op.halo_left + op.halo_right) * br * C * e
        # graph cut for this contiguous row partition
        rows_per = op.rows_per_shard
        shard_of = np.minimum(np.arange(m) // rows_per, n - 1)
        coo = L.tocoo()
        cross = shard_of[coo.row] != shard_of[coo.col]
        cut = int(cross.sum())
        # ideal exchange: every REMOTE node actually referenced, once
        bnd = len(np.unique(coo.col[cross]))
        ideal = bnd * C * e
        nbr_s = rows_per // br
        interior = 1 - (op.boundary_pre + op.boundary_suf) / nbr_s
        print(f"{n:>2} {op.halo_left:>4} {op.halo_right:>4} "
              f"{bytes_hop/2**20:>8.2f} {bytes_hop/2/2**20:>8.2f} "
              f"{cut:>10d} {bnd:>10d} "
              f"{ideal/2**20:>9.2f} {bytes_hop/max(ideal,1):>6.2f} "
              f"{interior*100:>8.1f}%")


MODES = {"comm": main_comm}

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        sys.exit(0)
    if len(sys.argv) < 2 or sys.argv[1] not in MODES:
        print(__doc__)
        sys.exit(1)
    MODES[sys.argv[1]](sys.argv[2:])
