"""Smoke tests for the experiment CLIs: --help works for every driver
(imports resolve, arg wiring is valid) without touching any device."""

import os
import subprocess
import sys
from pathlib import Path

import pytest


def _cpu_env(**extra):
    """Environment for a CPU-only child run of an experiment script."""
    return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": os.environ.get("HOME", ""), "JAX_PLATFORMS": "cpu",
            **extra}

EXPERIMENTS = sorted(
    p.name for p in (Path(__file__).parent.parent / "experiments").glob("*.py")
    if not p.name.startswith("_")
)


@pytest.mark.parametrize("script", EXPERIMENTS)
def test_cli_help(script):
    proc = subprocess.run(
        [sys.executable, f"experiments/{script}", "--help"],
        capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).parent.parent,
        env=_cpu_env(),
    )
    assert proc.returncode == 0, proc.stderr[-500:]
    assert "usage" in proc.stdout.lower()


def test_expected_driver_set():
    # The reference's experiment surface mapped to drivers (PARITY.md #33-35).
    expected = {"usage_demo.py", "mnist.py", "humanflow.py",
                "gconv_sweep.py", "text20news.py", "rcv1.py",
                "node_classification.py"}
    assert expected.issubset(set(EXPERIMENTS))


def test_mnist_cli_real_data_path_end_to_end(tmp_path):
    """The FULL real-data path of experiments/mnist.py (--data-dir ->
    load_mnist -> graph build -> ChebNet -> Trainer fit/evaluate) runs
    over hand-crafted IDX files, so the only untested step on the
    MNIST-parity path is the dataset download itself (RUNBOOK.md;
    reference: nips2016/mnist.ipynb cells 14-17)."""
    import gzip
    import struct

    import numpy as np

    rng = np.random.default_rng(5)

    def idx_bytes(arr):
        header = struct.pack(">HBB", 0, 0x08, arr.ndim)
        header += struct.pack(f">{arr.ndim}I", *arr.shape)
        return header + arr.tobytes()

    tr_img = rng.integers(0, 256, (48, 28, 28)).astype(np.uint8)
    tr_lab = (np.arange(48) % 10).astype(np.uint8)
    te_img = rng.integers(0, 256, (8, 28, 28)).astype(np.uint8)
    te_lab = (np.arange(8) % 10).astype(np.uint8)
    (tmp_path / "train-images-idx3-ubyte").write_bytes(idx_bytes(tr_img))
    (tmp_path / "train-labels-idx1-ubyte").write_bytes(idx_bytes(tr_lab))
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(idx_bytes(te_img))
    (tmp_path / "t10k-labels-idx1-ubyte").write_bytes(idx_bytes(te_lab))

    proc = subprocess.run(
        [sys.executable, "experiments/mnist.py",
         "--data-dir", str(tmp_path), "--epochs", "1",
         "--batch-size", "8", "--K", "5"],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).parent.parent,
        env=_cpu_env(),
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "test" in proc.stdout, proc.stdout[-500:]


def test_mnist_cli_mesh_data_parallel():
    """--mesh-data N drives the mesh-aware Trainer end to end on the
    virtual CPU mesh (synthetic digits; SURVEY §2.3 batch DP)."""
    proc = subprocess.run(
        [sys.executable, "experiments/mnist.py",
         "--n-train", "128", "--epochs", "1", "--batch-size", "32",
         "--K", "3", "--mesh-data", "8"],
        capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).parent.parent,
        env=_cpu_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=8"),
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    assert "data-parallel training over mesh" in proc.stdout
    assert "test" in proc.stdout, proc.stdout[-500:]
