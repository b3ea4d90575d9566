#!/usr/bin/env python
"""Smoke run of the main paths on one GPU, through the public API.

Phases, all in this one process (one JAX process per card):

  mnist_chebnet  the flagship ChebNet at full width (28x28 8-NN grid, 4
                 Graclus levels, K=[25,25], F=[32,64], p=[4,4],
                 M=[512,10], batch 100, dense operators): Trainer.fit on
                 synthetic MNIST-shaped digits; one forward against the
                 same parameters under highest matmul precision.
  city50k_train  city_graph(224) (50,176 nodes, k=8, RCM) through
                 device_laplacian(fmt="auto", bf16), asserted banded:
                 NodeClassifier K=25, 512 features, 16 classes, hidden=[]
                 and hidden=[512] (the adjoint chain) Adam steps; the K=25
                 cheby_finals chain at C=512 against a float64 SciPy
                 recurrence, for the bf16 operator and a float32 one.
  city50k_serve  the city model trained on a planted-partition task,
                 served int8 through serve.compile_serving (5 requests),
                 accuracy against the float model, and the
                 export_serving/load_serving round trip on "cuda".
  formats        dense, banded, BSR and BCOO (and the int8 twins) on the
                 city graph and a scattered 10k-node 64-D kNN graph
                 (k=16): a K=5 chain at C=512 against SciPy.
  forecast       a few training steps of experiments/humanflow.py
                 --model glstm in its default configuration.

Each phase prints one ``phase=...`` line: compile seconds, steady-state
time (``block_until_ready``), peak device memory, the largest error
against its reference, and the tolerance with its reason.  A failing
phase makes the script exit non-zero.  ``--multichip`` runs only the
four-card path (banded-halo training, sparse-halo hops, int8 banded-halo
chain) against the single-card operators.

Run:  python chip_smoke.py [--phases a,b] [--multichip] [--side N]

With no GPU the script prints no result and exits 2.  Otherwise the last
line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PHASES = ("mnist_chebnet", "city50k_train", "city50k_serve", "formats",
          "forecast")
MULTICHIP = "multichip"


def select_phases(spec: str | None, multichip: bool) -> list[str]:
    """The phases to run: ``--multichip`` alone, else ``--phases`` (a
    comma list, in the canonical order) or all of them."""
    if multichip:
        if spec:
            raise ValueError("--multichip runs only the four-card path")
        return [MULTICHIP]
    if not spec:
        return list(PHASES)
    wanted = [p.strip() for p in spec.split(",") if p.strip()]
    unknown = sorted(set(wanted) - set(PHASES))
    if unknown:
        raise ValueError(f"unknown phases {unknown}; choose from {PHASES}")
    return [p for p in PHASES if p in wanted]


def result_line(devices) -> str:
    """The final JSON line, with the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def card_info() -> str:
    """``nvidia-smi``'s name and power limit of each card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def run_phases(phases, funcs, ctx) -> bool:
    """Run each phase; print its summary line, or its traceback and a
    FAIL line.  Returns whether every phase passed."""
    out = sys.stdout
    ok = True
    for name in phases:
        t0 = time.perf_counter()
        try:
            rec = funcs[name](ctx)
        except Exception:  # noqa: BLE001 — report, keep going, exit non-zero
            traceback.print_exc()
            print(f"phase={name} status=FAIL wall_s="
                  f"{time.perf_counter() - t0:.1f}", file=out, flush=True)
            ok = False
            continue
        fields = " ".join(f"{k}={v}" for k, v in rec.items())
        print(f"phase={name} status=ok wall_s="
              f"{time.perf_counter() - t0:.1f} {fields}", file=out,
              flush=True)
    return ok


# ---------------------------------------------------------------- helpers


class Ctx:
    """Per-run settings shared by the phases."""

    def __init__(self, side: int, scattered_n: int, seed: int = 0):
        self.side = side
        self.scattered_n = scattered_n
        self.seed = seed
        self._city = None

    def city(self):
        """``(L, positions)`` of city_graph(side), built once."""
        if self._city is None:
            from cnn_graph_tpu.data.synthetic import city_graph

            self._city = city_graph(self.side, k=8, seed=self.seed)
        return self._city


def peak_gb() -> float:
    """Process peak of device memory in use so far (GB)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 1e9


def check(name: str, err: float, tol: float, why: str) -> str:
    """Raise unless ``err <= tol``; return the report fragment."""
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: error {err:.3e} > tol {tol:.1e} "
                             f"({why})")
    return f"{err:.3e}<={tol:g} [{why}]"


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scipy_chain(L, x: np.ndarray, K: int) -> np.ndarray:
    """T_{K-1}(L~) x in float64 on the host (L~ = rescaled Laplacian)."""
    from cnn_graph_tpu.graphs.construction import rescale_laplacian

    Lr = rescale_laplacian(L, lmax=2.0).tocsr().astype(np.float64)
    x = x.astype(np.float64)
    if K == 1:
        return x
    t0, t1 = x, Lr @ x
    for _ in range(2, K):
        t0, t1 = t1, 2.0 * (Lr @ t1) - t0
    return t1


def detail(msg: str):
    print(f"  {msg}", flush=True)


def plain_chain(op, x, K: int):
    """T_{K-1} x on a banded operator through the XLA path
    (``laplacian.band_windows``) — the kernel's plain reference, with the
    same two-hops-per-iteration loop as ``ops.cheby_finals``."""
    import jax
    import jax.numpy as jnp

    from cnn_graph_tpu.ops.laplacian import band_windows, quant_emit

    def mm(v, acc):
        return band_windows(op.band, op.base, op.sched, op.levels,
                            op.rows_per_step, op.block_shape, v, acc)

    if hasattr(op, "band_scale"):
        def hop(a, b):
            return quant_emit(mm(a, jnp.int32), op.band_scale, b)
    else:
        def hop(a, b):  # b None: the plain SpMM
            y = mm(a, jnp.float32)
            if b is not None:
                y = 2.0 * y - b.astype(jnp.float32)
            return y.astype(a.dtype)

    def body(_, c):
        p, q = c
        r = hop(q, p)
        return r, hop(r, q)

    p, q = jax.lax.fori_loop(0, (K - 2) // 2, body, (x, hop(x, None)))
    return hop(q, p) if (K - 2) % 2 else q


# ----------------------------------------------------------------- phases


def phase_mnist(ctx):
    import jax

    from cnn_graph_tpu.data.mnist import mnist_graph_data, synthetic_mnist
    from cnn_graph_tpu.models import ChebNet
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.train import TrainConfig, Trainer

    splits = synthetic_mnist(n_train=2000, n_val=500, n_test=200,
                             seed=2017)
    splits, Ls, _perm = mnist_graph_data(splits, k=8, levels=4, seed=2017)
    ops = [device_laplacian(L, fmt="dense") for L in Ls]
    model = ChebNet(ops, F=[32, 64], K=[25, 25], p=[4, 4], M=[512, 10],
                    dropout=0.5)
    cfg = TrainConfig(num_epochs=1.0, learning_rate=1e-3, decay_rate=0.95,
                      decay_steps=20, batch_size=100, eval_frequency=10,
                      seed=2017)
    trainer = Trainer(model, cfg, task="classification")
    args = (splits["train_data"], splits["train_labels"],
            splits["val_data"], splits["val_labels"])
    t0 = time.perf_counter()
    _, losses1, _ = trainer.fit(*args, verbose=False)   # 20 steps
    first_s = time.perf_counter() - t0
    _, losses2, t_step = trainer.fit(*args, verbose=False)  # 20 more
    losses = list(losses1) + list(losses2)
    detail(f"mnist val loss by 10 steps: {losses}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"loss not finite and falling: {losses}")

    x = jax.numpy.asarray(splits["test_data"][:100])
    fwd = jax.jit(model.apply)
    y = np.asarray(fwd(trainer.params, x))
    with jax.default_matmul_precision("highest"):
        y_hi = np.asarray(jax.jit(model.apply)(trainer.params, x))
    err = float(np.abs(y - y_hi).max() / np.abs(y_hi).max())
    return {
        "steps": 40, "first_fit_s": f"{first_s:.1f}",
        "step_ms": f"{t_step * 1e3:.2f}",
        "peak_mem_gb": f"{peak_gb():.2f}",
        "loss": f"{losses[0]:.3f}->{losses[-1]:.3f}",
        "fwd_vs_highest": check(
            "mnist forward", err, 2e-2,
            "default precision runs float32 matmuls in TF32 (10-bit "
            "mantissa) through two K=25 convs and two dense layers; "
            "max abs error relative to max |logit|"),
    }


def _node_step(hidden, C, n_classes, K, lr=1e-3):
    """An Adam optimizer and a jitted NodeClassifier step over the
    operator passed as its first argument."""
    import jax
    import optax

    from cnn_graph_tpu.models import NodeClassifier

    opt = optax.adam(lr)

    @jax.jit
    def step(op, params, state, x, y, mask):
        m = NodeClassifier(op, input_features=C, num_classes=n_classes,
                           hidden=hidden, K=K)
        loss, g = jax.value_and_grad(m.loss)(params, x, y, mask)
        up, state = opt.update(g, state, params)
        return optax.apply_updates(params, up), state, loss

    return opt, step


def phase_city_train(ctx):
    import jax
    import jax.numpy as jnp

    from cnn_graph_tpu.models import NodeClassifier
    from cnn_graph_tpu.ops import (
        cheby_finals,
        device_laplacian,
        quantize_banded,
    )
    from cnn_graph_tpu.ops.laplacian import BandedLaplacian
    from cnn_graph_tpu.utils.profiling import time_steady

    L, _ = ctx.city()
    K, C, n_classes = 25, 512, 16
    t0 = time.perf_counter()
    op = device_laplacian(L, fmt="auto", dtype=jnp.bfloat16)
    setup_s = time.perf_counter() - t0
    if not isinstance(op, BandedLaplacian):
        raise AssertionError(f"fmt='auto' picked {type(op).__name__}")
    detail(f"city graph: {op.m} nodes, nnz {op.nnz}, banded levels "
           f"{op.levels}, {op.band.shape[0]} blocks, pack {setup_s:.1f}s")
    rng = np.random.default_rng(ctx.seed)
    x = jnp.asarray(rng.normal(size=(op.m_padded, C)), jnp.float32)
    y = jnp.asarray(rng.integers(0, n_classes, op.m_padded), jnp.int32)
    mask = jnp.ones((op.m_padded,), bool)
    rec = {}
    for hidden in ([], [512]):
        model = NodeClassifier(op, input_features=C, num_classes=n_classes,
                               hidden=hidden, K=K)
        params = model.init(jax.random.PRNGKey(ctx.seed))
        opt, step = _node_step(hidden, C, n_classes, K)
        state = opt.init(params)
        first, med = time_steady(step, op, params, state, x, y, mask)
        losses = []
        for _ in range(3):
            params, state, loss = step(op, params, state, x, y, mask)
            losses.append(float(loss))
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"hidden={hidden}: losses {losses}")
        tag = "deep" if hidden else "single"
        detail(f"train hidden={hidden}: compile+first {first:.1f}s, step "
               f"{med * 1e3:.2f} ms, losses {losses}")
        rec[f"{tag}_compile_s"] = f"{first:.1f}"
        rec[f"{tag}_step_ms"] = f"{med * 1e3:.2f}"

    xh = np.zeros((op.m_padded, C), np.float32)
    xh[: op.m] = rng.normal(size=(op.m, C))
    want = scipy_chain(L, xh[: op.m], K)
    chain = jax.jit(lambda o, v: cheby_finals(o, v, K))
    plain = jax.jit(lambda o, v: plain_chain(o, v, K))
    xb = jnp.asarray(xh, jnp.bfloat16)
    first, med = time_steady(chain, op, xb)
    got = np.asarray(chain(op, xb), np.float32)
    e_bf16 = rel_l2(got[: op.m], want)
    _, med_p = time_steady(plain, op, xb)
    e_vs_plain = rel_l2(got, np.asarray(plain(op, xb), np.float32))
    detail(f"bf16 K=25 chain: kernel {med * 1e3:.2f} ms "
           f"({med / (K - 1) * 1e6:.1f} us/hop), XLA plain "
           f"{med_p * 1e3:.2f} ms ({med_p / (K - 1) * 1e6:.1f} us/hop); "
           f"rel-L2 vs float64 {e_bf16:.3e}, vs plain {e_vs_plain:.3e}")
    q = quantize_banded(op, sample_x=3.0)
    xq = q.quantize(jnp.asarray(xh))
    _, med_q = time_steady(chain, q, xq)
    _, med_qp = time_steady(plain, q, xq)
    diff_q = int((np.asarray(chain(q, xq)) != np.asarray(plain(q, xq))).sum())
    detail(f"int8 K=25 chain: kernel {med_q * 1e3:.2f} ms "
           f"({med_q / (K - 1) * 1e6:.1f} us/hop), XLA plain "
           f"{med_qp * 1e3:.2f} ms ({med_qp / (K - 1) * 1e6:.1f} us/hop); "
           f"{diff_q} elements differ")
    if diff_q:
        raise AssertionError(f"int8 kernel chain differs from the XLA "
                             f"int8 path in {diff_q} elements")
    op32 = device_laplacian(L, fmt="auto", dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        chain32 = jax.jit(lambda o, v: cheby_finals(o, v, K))
        first32, med32 = time_steady(chain32, op32, jnp.asarray(xh))
        got32 = np.asarray(chain32(op32, jnp.asarray(xh)))
    e_f32 = rel_l2(got32[: op.m], want)
    detail(f"f32 (highest) K=25 chain: {med32 * 1e3:.2f} ms, rel-L2 "
           f"{e_f32:.3e}")
    rec.update({
        "chain_bf16_ms": f"{med * 1e3:.2f}",
        "chain_bf16_plain_ms": f"{med_p * 1e3:.2f}",
        "chain_int8_ms": f"{med_q * 1e3:.2f}",
        "chain_int8_plain_ms": f"{med_qp * 1e3:.2f}",
        "int8_vs_plain": "bit-exact",
        "bf16_vs_plain": check(
            "bf16 kernel vs plain", e_vs_plain, 2e-2,
            "same bf16 operands and float32 accumulation, another "
            "summation order, 24 bf16 roundings of the carries"),
        "peak_mem_gb": f"{peak_gb():.2f}",
        "chain_bf16_err": check(
            "bf16 chain", e_bf16, 5e-2,
            "bf16 band and carries (8-bit mantissa) over 24 hops; rel-L2 "
            "vs float64 SciPy"),
        "chain_f32_err": check(
            "f32 chain", e_f32, 1e-4,
            "float32 at highest precision over 24 hops; rel-L2 vs "
            "float64 SciPy"),
    })
    return rec


def _planted_task(positions, m_padded, C, n_classes, seed):
    """Spatial-patch labels with class-signature features (host)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(positions.shape[0]))
    patch = ((positions[:, 0] // (side / 8)).astype(int) * 8
             + (positions[:, 1] // (side / 8)).astype(int))
    labels = (patch % n_classes).astype(np.int64)
    sig = rng.normal(0, 1, (n_classes, C)).astype(np.float32)
    feats = sig[labels] + rng.normal(0, 1.0, (len(labels), C)).astype(
        np.float32)
    n = len(labels)
    fp = np.zeros((m_padded, C), np.float32)
    fp[:n] = feats
    yp = np.zeros((m_padded,), np.int64)
    yp[:n] = labels
    train = np.zeros(m_padded, bool)
    train[:n] = rng.random(n) < 0.1
    test = np.zeros(m_padded, bool)
    test[:n] = ~train[:n]
    return fp, yp, train, test


def phase_city_serve(ctx):
    import jax
    import jax.numpy as jnp

    from cnn_graph_tpu.models import NodeClassifier
    from cnn_graph_tpu.ops import device_laplacian
    from cnn_graph_tpu.serve import (
        compile_serving,
        export_serving,
        load_serving,
    )
    from cnn_graph_tpu.utils.profiling import time_steady

    L, positions = ctx.city()
    K, C, n_classes, steps = 25, 512, 16, 60
    op = device_laplacian(L, fmt="auto", dtype=jnp.bfloat16)
    fp, yp, train, test = _planted_task(positions, op.m_padded, C,
                                        n_classes, ctx.seed + 1)
    model = NodeClassifier(op, input_features=C, num_classes=n_classes,
                           hidden=[], K=K)
    params = model.init(jax.random.PRNGKey(ctx.seed))
    opt, step = _node_step([], C, n_classes, K, lr=1e-2)
    state = opt.init(params)
    feats, y, tmask = map(jnp.asarray, (fp, yp, train))
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(op, params, state, feats, y, tmask)
    loss = float(loss)
    detail(f"trained {steps} steps in {time.perf_counter() - t0:.1f}s, "
           f"loss {loss:.4f}")
    if not np.isfinite(loss):
        raise AssertionError(f"serving model loss {loss}")

    float_logits = np.asarray(jax.jit(model.apply)(params, feats))
    serving = compile_serving(model, params, feats, int8=True)
    rng = np.random.default_rng(ctx.seed + 2)
    requests = [fp + rng.normal(0, 0.1, fp.shape).astype(np.float32)
                for _ in range(5)]
    outs = [np.asarray(serving(jnp.asarray(r))) for r in requests]
    if not all(np.all(np.isfinite(o)) for o in outs):
        raise AssertionError("non-finite int8 serving output")
    _, req_s = time_steady(serving, feats)
    q_logits = np.asarray(serving(feats))
    acc_f = float((float_logits.argmax(1) == yp)[test].mean())
    acc_q = float((q_logits.argmax(1) == yp)[test].mean())
    detail(f"{len(outs)} int8 requests answered; steady request "
           f"{req_s * 1e3:.2f} ms; test acc float {acc_f:.4f} int8 "
           f"{acc_q:.4f}")

    with tempfile.TemporaryDirectory() as d:
        export_serving(model, params, feats, d, int8=True,
                       platforms=["cuda"])
        loaded = load_serving(d)
        meta = loaded.meta
        got = np.asarray(loaded(feats))
    detail(f"export meta: int8={meta['int8']} triton={meta['triton_kernels']}"
           f" platforms={meta['platforms']}")
    if not np.array_equal(got, q_logits):
        raise AssertionError(
            "export/load round trip is not bit-identical: max diff "
            f"{np.abs(got - q_logits).max():.3e}")
    return {
        "requests": len(outs), "request_ms": f"{req_s * 1e3:.2f}",
        "peak_mem_gb": f"{peak_gb():.2f}",
        "acc_float": f"{acc_f:.4f}", "acc_int8": f"{acc_q:.4f}",
        "acc_delta": check(
            "int8 accuracy", acc_f - acc_q, 0.02,
            "int8 band and carries, one global scale each; test-node "
            "accuracy drop vs the float model"),
        "roundtrip": "bit-identical",
    }


def _scattered_graph(n, dim, k, seed):
    """Embedding kNN graph: ``n`` points in ``dim`` dimensions drawn
    around 20 seeded cluster centres, k-NN (exact, cKDTree), RCM."""
    from cnn_graph_tpu.graphs import construction as gc

    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 1, (20, dim))
    z = (centres[rng.integers(0, 20, n)]
         + rng.normal(0, 0.6, (n, dim))).astype(np.float32)
    dist, idx = gc.knn(z, k=k, algorithm="auto")
    W = gc.adjacency(dist, idx)
    perm = gc.bandwidth_reducing_permutation(W)
    W = W[perm][:, perm].tocsr()
    return gc.laplacian(W, normalized=True)


def phase_formats(ctx):
    import jax
    import jax.numpy as jnp

    from cnn_graph_tpu.ops import (
        cheby_finals,
        device_laplacian,
        quantize_banded,
        quantize_block_sparse,
        quantize_dense,
    )
    from cnn_graph_tpu.utils.profiling import time_steady

    K, C = 5, 512
    graphs = {"city": ctx.city()[0],
              "scattered": _scattered_graph(ctx.scattered_n, 64, 16,
                                            ctx.seed)}
    tols = {
        "float32": (1e-4, "float32 at highest precision, 4 hops"),
        "bfloat16": (3e-2, "bf16 band and carries, 4 hops"),
        "int8": (0.15, "int8 band and carries with one global scale "
                       "each, 4 hops"),
    }
    rec, worst = {}, {}
    chain = jax.jit(lambda o, v: cheby_finals(o, v, K))
    for gname, L in graphs.items():
        rng = np.random.default_rng(ctx.seed + 3)
        x = rng.normal(size=(L.shape[0], C)).astype(np.float32)
        want = scipy_chain(L, x, K)
        cases = [("dense", dict(fmt="dense")),
                 ("banded", dict(fmt="banded")),
                 ("banded_bf16", dict(fmt="banded", dtype=jnp.bfloat16)),
                 ("bsr", dict(fmt="bsr")),
                 ("bcoo", dict(fmt="bcoo"))]
        quant = {"dense": quantize_dense, "banded": quantize_banded,
                 "bsr": quantize_block_sparse}
        for name, kw in cases:
            try:
                op = device_laplacian(L, **kw)
            except ValueError as e:  # e.g. a scattered graph's band
                detail(f"{gname}/{name}: not applicable ({e})")
                rec[f"{gname}_{name}"] = "n/a"
                continue
            xp = np.zeros((op.m_padded, C), np.float32)
            xp[: L.shape[0]] = x
            twins = [(name, op)]
            if name in quant:
                twins.append((name + "_int8", quant[name](op, sample_x=3.0)))
            for tname, o in twins:
                if hasattr(o, "cheby_hop_q"):
                    xq = o.quantize(jnp.asarray(xp))
                    first, med = time_steady(chain, o, xq)
                    got = np.asarray(o.dequantize(chain(o, xq)))
                    dt = "int8"
                else:
                    dt = str(jnp.dtype(o.compute_dtype))
                    xd = jnp.asarray(xp, o.compute_dtype)
                    with jax.default_matmul_precision("highest"):
                        first, med = time_steady(chain, o, xd)
                        got = np.asarray(chain(o, xd), np.float32)
                err = rel_l2(got[: L.shape[0]], want)
                tol, why = tols[dt]
                detail(f"{gname}/{tname} [{type(o).__name__}, {dt}]: K=5 "
                       f"chain {med * 1e3:.2f} ms ({med / (K - 1) * 1e6:.1f}"
                       f" us/hop), compile {first:.1f}s, rel-L2 {err:.3e}")
                check(f"{gname}/{tname}", err, tol, why)
                rec[f"{gname}_{tname}_us_hop"] = f"{med / (K - 1) * 1e6:.1f}"
                worst[dt] = max(worst.get(dt, 0.0), err)
            del op, twins
    rec["peak_mem_gb"] = f"{peak_gb():.2f}"
    for dt, err in worst.items():
        tol, why = tols[dt]
        rec[f"max_err_{dt}"] = f"{err:.3e}<={tol:g} [{why}; rel-L2]"
    return rec


def phase_forecast(ctx):
    import jax
    import jax.numpy as jnp

    from cnn_graph_tpu.train import Trainer

    sys.path.insert(0, str(ROOT / "experiments"))
    import humanflow

    with tempfile.TemporaryDirectory() as d:
        humanflow.write_synthetic(d, nodes=64, seed=ctx.seed)
        args = humanflow.parse_args(["--model", "glstm", "--data-dir", d])
        ht, (tr, va, _te, trl, val, _tel), edges = humanflow.build_dataset(
            args)
    model, cfg = humanflow.build(args, edges, tr)
    cfg.num_epochs = 20.5 * args.batch_size / tr.shape[0]  # 20 steps a fit
    cfg.eval_frequency = 10
    trainer = Trainer(model, cfg, task="regression")
    data = (tr.astype(np.float32), trl.astype(np.float32),
            va.astype(np.float32), val.astype(np.float32))
    t0 = time.perf_counter()
    _, l1, _ = trainer.fit(*data, verbose=False)
    first_s = time.perf_counter() - t0
    _, l2, t_step = trainer.fit(*data, verbose=False)
    losses = list(l1) + list(l2)
    detail(f"glstm val loss by 10 steps: {losses}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"loss not finite and falling: {losses}")
    x = jnp.asarray(va[:args.batch_size].astype(np.float32))
    y = np.asarray(jax.jit(model.apply)(trainer.params, x))
    with jax.default_matmul_precision("highest"):
        y_hi = np.asarray(jax.jit(model.apply)(trainer.params, x))
    err = float(np.abs(y - y_hi).max() / np.abs(y_hi).max())
    return {
        "steps": 40, "first_fit_s": f"{first_s:.1f}",
        "step_ms": f"{t_step * 1e3:.2f}", "peak_mem_gb": f"{peak_gb():.2f}",
        "loss": f"{losses[0]:.4f}->{losses[-1]:.4f}",
        "fwd_vs_highest": check(
            "glstm forward", err, 2e-2,
            "TF32 gate matmuls over a 4+1+1-step window; max abs error "
            "relative to max |output|"),
    }


def phase_multichip(ctx):
    """The four-card matrix at city_graph(side) size, each against the
    single-card operator on device 0."""
    import jax
    import jax.numpy as jnp

    from cnn_graph_tpu.models import NodeClassifier
    from cnn_graph_tpu.ops import device_laplacian, quantize_banded
    from cnn_graph_tpu.parallel import (
        banded_halo_laplacian,
        make_mesh,
        quantize_banded_halo,
        sparse_halo_laplacian,
    )
    from cnn_graph_tpu.utils.profiling import time_steady

    n = len(jax.devices())
    if n != 4:
        raise AssertionError(f"--multichip needs 4 devices, found {n}")
    mesh = make_mesh(data=1, nodes=n)
    L, _ = ctx.city()
    rng = np.random.default_rng(ctx.seed)
    rec = {}

    def spread(op, name):
        """Every data field must be split over all n devices."""
        for leaf in jax.tree.leaves(op):
            if not hasattr(leaf, "addressable_shards"):
                continue
            devs = {s.device for s in leaf.addressable_shards}
            rows = {s.data.shape[0] for s in leaf.addressable_shards}
            if len(devs) != n or rows != {leaf.shape[0] // n}:
                raise AssertionError(
                    f"{name}: a field of shape {leaf.shape} sits on "
                    f"{len(devs)} device(s) with row blocks {rows}")

    # Banded-halo training step (bf16: the Triton kernel per shard) vs
    # the single-card banded operator.
    K, C, n_classes, hidden = 25, 512, 16, [512]
    bop = banded_halo_laplacian(L, mesh, dtype=jnp.bfloat16)
    spread(bop, "banded-halo")
    sop = device_laplacian(L, fmt="banded", dtype=jnp.bfloat16)
    mp = bop.m_padded
    x = rng.normal(size=(mp, C)).astype(np.float32)
    y = rng.integers(0, n_classes, mp).astype(np.int32)
    model = NodeClassifier(bop, input_features=C, num_classes=n_classes,
                           hidden=hidden, K=K)
    params = model.init(jax.random.PRNGKey(ctx.seed))

    def loss_grad(op, params, x, y, mask):
        m = NodeClassifier(op, input_features=C, num_classes=n_classes,
                           hidden=hidden, K=K)
        return jax.value_and_grad(m.loss)(params, x, y, mask)

    lg = jax.jit(loss_grad)
    m1 = sop.m_padded
    x1 = np.zeros((m1, C), np.float32)
    y1 = np.zeros((m1,), np.int32)
    k = min(m1, mp)
    x1[:k], y1[:k] = x[:k], y[:k]
    mask1 = np.zeros((m1,), bool)
    mask1[: L.shape[0]] = True
    mask4 = np.zeros((mp,), bool)
    mask4[: L.shape[0]] = True
    args4 = (params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask4))
    args1 = (params, jnp.asarray(x1), jnp.asarray(y1), jnp.asarray(mask1))
    with mesh:
        first, med = time_steady(lg, bop, *args4)
        l4, g4 = lg(bop, *args4)
    first1, med1 = time_steady(lg, sop, *args1)
    l1, g1 = lg(sop, *args1)
    e_loss = abs(float(l4) - float(l1)) / abs(float(l1))
    gflat4 = np.concatenate([np.ravel(v) for v in jax.tree.leaves(g4)])
    gflat1 = np.concatenate([np.ravel(v) for v in jax.tree.leaves(g1)])
    e_grad = rel_l2(gflat4, gflat1)
    detail(f"banded-halo fwd+bwd (hidden={hidden}, K={K}) on {n} cards: "
           f"{med * 1e3:.2f} ms (compile {first:.1f}s); one card "
           f"{med1 * 1e3:.2f} ms; loss rel diff {e_loss:.2e}, grad rel-L2 "
           f"{e_grad:.2e}")
    rec["halo_train_ms"] = f"{med * 1e3:.2f}"
    rec["one_card_train_ms"] = f"{med1 * 1e3:.2f}"
    rec["halo_loss_err"] = check(
        "banded-halo loss", e_loss, 5e-3,
        "bf16 carries (one ulp is 3.9e-3), reductions split over 4 "
        "shards; a wrong halo or shard gives O(1)")
    rec["halo_grad_err"] = check(
        "banded-halo grads", e_grad, 5e-2,
        "bf16 forward and adjoint chains over 24 hops; rel-L2 over all "
        "parameters")

    # Sparse-halo hops (float32, highest precision) vs one card.
    ref = device_laplacian(L, fmt="banded", dtype=jnp.float32)
    Cs = 64
    for fmt in ("bsr", "banded"):
        shop = sparse_halo_laplacian(L, mesh, fmt=fmt)
        spread(shop, f"sparse-halo[{fmt}]")
        m_s = shop.m_padded
        a = np.zeros((max(m_s, ref.m_padded), Cs), np.float32)
        a[: L.shape[0]] = rng.normal(size=(L.shape[0], Cs))
        b = rng.normal(size=a.shape).astype(np.float32)
        b[L.shape[0]:] = 0
        hop = jax.jit(lambda o, u, v: o.cheby_hop(u, v))
        with jax.default_matmul_precision("highest"):
            with mesh:
                _, med = time_steady(hop, shop, jnp.asarray(a[:m_s]),
                                     jnp.asarray(b[:m_s]))
                got = np.asarray(hop(shop, jnp.asarray(a[:m_s]),
                                     jnp.asarray(b[:m_s])))
            want = np.asarray(hop(ref, jnp.asarray(a[: ref.m_padded]),
                                  jnp.asarray(b[: ref.m_padded])))
        e = rel_l2(got[: L.shape[0]], want[: L.shape[0]])
        detail(f"sparse-halo[{fmt}] hop {med * 1e3:.3f} ms, rel-L2 vs one "
               f"card {e:.3e}")
        rec[f"sparse_{fmt}_err"] = check(
            f"sparse-halo[{fmt}]", e, 1e-5,
            "float32 highest precision, one hop")

    # Int8 banded-halo chain: bit-equal with the single-card quantized
    # chain (integer sums are exact).
    bop32 = banded_halo_laplacian(L, mesh, dtype=jnp.float32)
    qop = quantize_banded_halo(bop32, sample_x=3.0)
    spread(qop, "int8 banded-halo")
    sq = quantize_banded(device_laplacian(L, fmt="banded",
                                          dtype=jnp.float32, ragged=False),
                         sample_x=3.0)
    mq = max(qop.m_padded, sq.m_padded)
    xq = np.zeros((mq, C), np.int8)
    xq[: L.shape[0]] = rng.integers(-100, 100, (L.shape[0], C))

    def chain_q(q, v, K=5):
        b = [v, q.spmm_q(v)]
        for _ in range(2, K):
            b.append(q.cheby_hop_q(b[-1], b[-2]))
        return jnp.stack(b)

    with mesh:
        got = np.asarray(jax.jit(chain_q)(qop,
                                          jnp.asarray(xq[: qop.m_padded])))
    want = np.asarray(jax.jit(chain_q)(sq, jnp.asarray(xq[: sq.m_padded])))
    diff = int((got[:, : L.shape[0]] != want[:, : L.shape[0]]).sum())
    detail(f"int8 banded-halo K=5 chain: {diff} elements differ from the "
           "single-card quantized chain")
    if diff:
        raise AssertionError(f"int8 sharded chain differs in {diff} places")
    rec["int8_chain"] = "bit-equal"
    rec["peak_mem_gb_dev0"] = f"{peak_gb():.2f}"
    return rec


FUNCS = {
    "mnist_chebnet": phase_mnist,
    "city50k_train": phase_city_train,
    "city50k_serve": phase_city_serve,
    "formats": phase_formats,
    "forecast": phase_forecast,
    MULTICHIP: phase_multichip,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default=None,
                   help=f"comma list from {', '.join(PHASES)}")
    p.add_argument("--multichip", action="store_true",
                   help="run only the four-card path")
    p.add_argument("--side", type=int, default=224,
                   help="city graph side (224 -> 50,176 nodes)")
    p.add_argument("--scattered-n", type=int, default=10000)
    args = p.parse_args(argv)
    phases = select_phases(args.phases, args.multichip)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r});"
              " nothing measured", file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    from cnn_graph_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    print(f"card: {card_info()}", flush=True)
    print(f"jax {jax.__version__}; {len(devices)} x "
          f"{devices[0].device_kind}; compile cache {cache}; XLA_FLAGS="
          f"{os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    ok = run_phases(phases, FUNCS, Ctx(args.side, args.scattered_n))
    if not ok:
        return 1
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
