"""Shared experiment-script setup: importing this module turns on the
persistent XLA compilation cache (``utils.compile_cache``).  The scripts
run on the GPU by default; ``JAX_PLATFORMS=cpu`` runs them on the CPU."""

from cnn_graph_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
