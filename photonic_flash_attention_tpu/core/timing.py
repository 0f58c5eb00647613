"""Kernel timing for the router: per-iteration time from a linear fit.

Per-call wall-clock includes host dispatch and the fetch of the result,
which at serving geometries can exceed the kernel itself. Feeding such
numbers to the adaptive router would rank kernels by dispatch noise.

The estimator: run the kernel N times inside ONE jitted loop with the
output chained into the next iteration's input (nothing is dead-code
eliminated), force completion by fetching a scalar reduction, and take
per-iteration time as the slope of a linear fit across two iteration
counts. The fixed round-trip cancels in the subtraction.

This is what the reference's warmup-then-exploit lifecycle
(reference core/hybrid_router.py:543-597) measures with per-call CUDA
events, made robust to dispatch cost.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .. import platform
from ..utils.logging import get_logger

logger = get_logger("timing")


def default_iters() -> Tuple[int, int, int]:
    """(iters_lo, iters_hi, repeats) per platform.

    On the GPU the slope spans enough kernel time to dominate dispatch
    jitter; on the CPU (tests, interpreted kernels) the plumbing is
    exercised at minimal cost.
    """
    if platform.on_gpu():
        return 8, 40, 2
    return 1, 3, 1


# The slope must span at least this much device time; below it, host
# jitter dominates and the fit is noise. The iteration count auto-extends
# (dynamic trip count: no recompile) until the window clears this.
MIN_SLOPE_SPAN_MS = 20.0
MAX_ITERS = 4000


def measure_ms(
    step_fn: Callable[[jax.Array], jax.Array],
    x0: jax.Array,
    *,
    iters: Optional[Tuple[int, int]] = None,
    repeats: Optional[int] = None,
) -> float:
    """Per-iteration milliseconds of ``step_fn`` (chainable: out ~ in).

    ``step_fn`` must accept and return arrays of the same shape; its
    output is cast back to the input dtype and fed to the next iteration.
    The loop uses ``lax.fori_loop`` with a *dynamic* trip count — one
    compile serves every iteration count, so the window can be extended
    adaptively until the slope spans ``MIN_SLOPE_SPAN_MS`` of device
    time (fast kernels need hundreds of iterations to outweigh host
    jitter). Returns the linear-fit slope in ms, floored at 1e-4.
    """
    lo, hi, rep = default_iters()
    if iters is not None:
        lo, hi = iters
    if repeats is not None:
        rep = repeats

    @jax.jit
    def many(x, n):
        def body(i, c):
            return step_fn(c).astype(c.dtype)

        out = jax.lax.fori_loop(0, n, body, x)
        return jnp.sum(out.astype(jnp.float32))

    def timed(n: int) -> float:
        best = float("inf")
        for _ in range(rep):
            t0 = time.perf_counter()
            float(many(x0, n))
            best = min(best, time.perf_counter() - t0)
        return best

    float(many(x0, lo))  # compile once + warm the fetch path
    t_lo = timed(lo)
    t_hi = timed(hi)
    slope_ms = (t_hi - t_lo) / (hi - lo) * 1e3

    if platform.on_gpu() and iters is None:
        span_ms = max(slope_ms, 1e-4) * (hi - lo)
        if span_ms < MIN_SLOPE_SPAN_MS:
            hi2 = min(
                lo + int((hi - lo) * MIN_SLOPE_SPAN_MS / max(span_ms, 1e-3)),
                MAX_ITERS,
            )
            t_hi2 = timed(hi2)
            slope_ms = (t_hi2 - t_lo) / (hi2 - lo) * 1e3

    return max(slope_ms, 1e-4)
