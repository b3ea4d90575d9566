"""Profiling helpers: step timers, steady-state timing, trace capture and
the roofline model.

The reference only wall-clocks around fit/evaluate
(lib/graph_model.py:110-125, utils.py:313-316); here we add a step timer,
``jax.profiler`` trace capture for per-kernel inspection, and the peak
table the roofline shares are taken against.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import jax

__all__ = ["StepTimer", "trace", "time_steady", "device_peaks",
           "spmm_roofline", "PEAKS"]


def time_steady(fn, *args, reps: int = 5):
    """``(first_call_s, median_s)`` of ``fn(*args)``.

    The first call compiles (and warms up); the median is taken over
    ``reps`` further calls, each ended with ``jax.block_until_ready`` so
    the time covers the device work and not only the enqueue.
    """
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times)


class StepTimer:
    """Wall-clock timer that syncs the device before each reading so queued
    async work is attributed to the step that launched it."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            jax.block_until_ready(result)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.times) / max(len(self.times), 1)

    @property
    def min_ms(self) -> float:
        return 1000.0 * min(self.times) if self.times else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Peak rates per ``jax.Device.device_kind``: NVIDIA's H100 SXM data sheet,
# dense (no sparsity), at the full 700 W power limit.  These are
# datasheet values, not measurements; a card set to a lower power limit
# cannot hold them under load.  "float32" is the TF32 tensor-core rate
# (XLA's default precision for float32 matmuls on this card).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 SXM data sheet (dense)",
        "mem_bytes_per_s": 3.35e12,
        "flops": {"bfloat16": 989e12, "float16": 989e12,
                  "float32": 495e12, "int8": 1979e12},
    },
}


def device_peaks(device_kind: str) -> dict:
    """The peak-rate entry for ``device_kind``; an unknown device is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {device_kind!r}; add its data "
            "sheet values to utils.profiling.PEAKS"
        ) from None


def spmm_roofline(op, seconds_per_spmm: float, feature_width: int,
                  device_kind: str) -> dict:
    """Roofline report for one Laplacian SpMM through ``op``.

    Computes the kernel's minimum device-memory traffic (operator storage
    + one activation read + one write at ``feature_width`` columns) and
    its matmul work (including zero-block padding for tiled formats),
    and reports the achieved fraction of whichever bound is tighter
    against ``device_kind``'s data-sheet peaks.
    """
    import numpy as np

    peaks = device_peaks(device_kind)
    e = np.dtype(op.compute_dtype).itemsize
    C = feature_width
    mp = op.m_padded

    if hasattr(op, "band"):  # banded: every stored block is one tap
        br, bc = op.block_shape
        n_blocks = op.band.size // (br * bc)
        op_bytes = op.band.size * e
        flops = 2 * n_blocks * br * bc * C
    elif hasattr(op, "blocks") and op.blocks.ndim == 3:  # block-sparse
        op_bytes = op.blocks.size * e  # grouped rows: every slot is a tap
        flops = 2 * op.blocks.size * C
    elif hasattr(op, "mat"):  # dense
        op_bytes = op.mat.size * e
        flops = 2 * mp * mp * C
    else:
        raise ValueError(
            f"no roofline model for {type(op).__name__} "
            "(sharded operators: model each shard)"
        )

    act_bytes = 2 * mp * C * e  # x read + y write
    bytes_total = op_bytes + act_bytes
    key = str(np.dtype(op.compute_dtype))
    t_mem = bytes_total / peaks["mem_bytes_per_s"]
    t_compute = flops / peaks["flops"][key]
    bound = "memory" if t_mem >= t_compute else "compute"
    t_sol = max(t_mem, t_compute)
    return {
        "bytes": int(bytes_total),
        "flops": int(flops),
        "t_mem_us": t_mem * 1e6,
        "t_compute_us": t_compute * 1e6,
        "bound": bound,
        "sol_us": t_sol * 1e6,
        "achieved_frac_of_sol": t_sol / seconds_per_spmm,
        "useful_edge_flops_frac": 2 * op.nnz * C / flops,
        "peaks": peaks["source"],
    }
