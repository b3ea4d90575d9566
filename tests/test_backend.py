"""The one backend decision (``ops.backend``) and what it routes: on the
GPU the banded operators call the Triton kernel (run here through the
interpreter), float32 bands and every other backend take XLA.  Also the
compile-cache helper."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnn_graph_tpu.data.synthetic import city_graph
from cnn_graph_tpu.ops import backend, device_laplacian, pallas_band
from cnn_graph_tpu.ops import quantize_banded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestPredicate:
    def test_cpu_takes_xla(self):
        assert not backend.on_gpu()
        for dt in (jnp.float32, jnp.bfloat16, jnp.int8):
            assert not backend.band_kernel(dt)

    @pytest.mark.parametrize("name,want", [("gpu", True), ("rocm", False),
                                           ("cpu", False)])
    def test_on_gpu_follows_the_backend(self, monkeypatch, name, want):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
        assert backend.on_gpu() is want

    @pytest.mark.parametrize("dtype,want", [(jnp.bfloat16, True),
                                            (jnp.int8, True),
                                            (jnp.float32, False)])
    def test_kernel_only_for_bf16_and_int8_on_gpu(self, monkeypatch, dtype,
                                                  want):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert backend.band_kernel(dtype) is want


@pytest.fixture
def kernel_calls(monkeypatch):
    """Pretend to be on the GPU and run the kernel through the
    interpreter, counting its calls."""
    calls = []
    real = pallas_band.banded_call

    def interp(*a, **kw):
        calls.append(kw.get("band_scale"))
        kw["interpret"] = True
        return real(*a, **kw)

    from cnn_graph_tpu.parallel import banded_halo

    monkeypatch.setattr(backend, "on_gpu", lambda: True)
    monkeypatch.setattr(pallas_band, "banded_call", interp)
    monkeypatch.setattr(banded_halo, "banded_call", interp)
    return calls


@pytest.fixture(scope="module")
def city():
    L, _ = city_graph(24, k=8, seed=0)
    return L


class TestRouting:
    def _x(self, op, dtype, seed=0):
        rng = np.random.default_rng(seed)
        return jnp.asarray(rng.normal(size=(op.m_padded, 32)), dtype)

    def test_bf16_matmul_hop_and_hop_c_use_the_kernel(self, city,
                                                      kernel_calls):
        op = device_laplacian(city, fmt="banded", block_size=32,
                              dtype=jnp.bfloat16)
        x, x0, c = (self._x(op, jnp.bfloat16, s) for s in range(3))
        got = [op.matmul(x), op.cheby_hop(x, x0), op.cheby_hop_c(x, x0, c)]
        assert len(kernel_calls) == 3
        kernel_calls.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(backend, "on_gpu", lambda: False)
            want = [op.matmul(x), op.cheby_hop(x, x0),
                    op.cheby_hop_c(x, x0, c)]
        assert not kernel_calls
        for g, w in zip(got, want):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(np.asarray(g, np.float32), w,
                                       atol=3e-2 * np.abs(w).max())

    def test_int8_twin_uses_the_kernel_bit_exactly(self, city,
                                                   kernel_calls):
        op = device_laplacian(city, fmt="banded", block_size=32)
        q = quantize_banded(op, sample_x=3.0)
        xq = q.quantize(self._x(op, jnp.float32))
        x0q = q.quantize(self._x(op, jnp.float32, 1))
        got = np.asarray(q.cheby_hop_q(xq, x0q))
        assert kernel_calls == [q.band_scale]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(backend, "on_gpu", lambda: False)
            want = np.asarray(q.cheby_hop_q(xq, x0q))
        np.testing.assert_array_equal(got, want)

    def test_float32_band_stays_on_xla(self, city, kernel_calls):
        op = device_laplacian(city, fmt="banded", block_size=32)
        op.matmul(self._x(op, jnp.float32))
        assert kernel_calls == []

    def test_gradient_through_kernel_hop(self, city, kernel_calls):
        op = device_laplacian(city, fmt="banded", block_size=32,
                              dtype=jnp.bfloat16)
        x1 = self._x(op, jnp.bfloat16)
        x0 = self._x(op, jnp.bfloat16, 1)
        f = functools.partial(
            lambda o, a, b: jnp.sum(o.cheby_hop(a, b).astype(jnp.float32)),
            op)
        g1, g0 = jax.grad(f, argnums=(0, 1))(x1, x0)
        assert kernel_calls  # forward and the adjoint SpMM both
        np.testing.assert_array_equal(np.asarray(g0, np.float32), -1.0)
        ones = jnp.ones_like(x1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(backend, "on_gpu", lambda: False)
            want = np.asarray(2.0 * op.matmul(ones), np.float32)
        np.testing.assert_allclose(np.asarray(g1, np.float32), want,
                                   atol=3e-2 * np.abs(want).max())

    def test_sharded_banded_halo_uses_the_kernel(self, city, kernel_calls):
        from cnn_graph_tpu.parallel import banded_halo_laplacian, make_mesh

        mesh = make_mesh(data=4, nodes=2)
        Lb, _ = city_graph(48, k=8, seed=0)
        op = banded_halo_laplacian(Lb, mesh, dtype=jnp.bfloat16)
        x1 = self._x(op, jnp.bfloat16)
        x0 = self._x(op, jnp.bfloat16, 1)
        with mesh:
            got = np.asarray(jax.jit(lambda o, a, b: o.cheby_hop(a, b))(
                op, x1, x0), np.float32)
        assert kernel_calls
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(backend, "on_gpu", lambda: False)
            with mesh:
                want = np.asarray(jax.jit(lambda o, a, b: o.cheby_hop(a, b))(
                    op, x1, x0), np.float32)
        np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max())


class TestCompileCache:
    def test_env_directory_is_honoured_and_nothing_set(self, monkeypatch):
        from cnn_graph_tpu.utils import compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_the_checkout_cache(self, monkeypatch):
        from cnn_graph_tpu.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_checkout_cache_is_gitignored(self):
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
