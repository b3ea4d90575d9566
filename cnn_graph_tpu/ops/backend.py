"""The one decision of which code path a trace compiles for."""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["on_gpu", "band_kernel"]


def on_gpu() -> bool:
    """True when the current trace compiles for the GPU.

    On the GPU the tap/dW contractions keep the operator's dtype (bf16 x
    bf16 -> f32 on the tensor cores) and banded operators may run the
    Triton kernel (:func:`band_kernel`).  Everywhere else the XLA paths
    run and tap operands are cast up to float32: the CPU backend, where
    the tests run, has no mixed-precision GEMM.  Interpret mode is never
    chosen here; a test asks for it by calling the kernel with
    ``interpret=True``.
    """
    return jax.default_backend() == "gpu"


def band_kernel(dtype) -> bool:
    """Whether a banded pass over a band of ``dtype`` runs the Triton
    kernel (``ops.pallas_band``): on the GPU, for bfloat16 and int8
    bands.  float32 bands stay on the XLA path, whose float32 matmuls
    measured ~16x faster on an H100 than the kernel's IEEE float32 dot
    (PERF.md)."""
    return on_gpu() and jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16),
                                             jnp.dtype(jnp.int8))
