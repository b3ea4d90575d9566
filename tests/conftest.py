"""Test configuration: JAX on a virtual 8-device CPU platform.

Must run before the first ``import jax`` anywhere in the test session so the
multi-device sharding tests (tests/test_parallel.py) get an 8-device mesh
without accelerator hardware.  ``JAX_PLATFORMS`` defaults to ``cpu``; the
``gpu``-marked tests run on the card with ``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/`` and skip everywhere else.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest
import scipy.sparse

from cnn_graph_tpu.graphs import construction


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs the GPU; skips elsewhere (see module doc)")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided per test, at run time)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "lowering (its CPU twin is the interpret-mode test)")


@pytest.fixture
def rng():
    return np.random.default_rng(2017)


@pytest.fixture
def small_graph(rng):
    """A 60-node kNN graph with its normalized, rescaled Laplacian."""
    z = rng.uniform(size=(60, 2)).astype(np.float32)
    W = construction.knn_graph(z, k=6)
    L = construction.laplacian(W, normalized=True)
    L_rescaled = construction.rescale_laplacian(L, lmax=2.0)
    return W, L, L_rescaled


@pytest.fixture
def grid_graph():
    """The MNIST-style 28x28 8-NN grid graph."""
    z = construction.grid(28)
    W = construction.knn_graph(z, k=8)
    return W, construction.laplacian(W, normalized=True)
