"""Per-phase wall-clock timing, in the spirit of the reference STimer.

Accumulating stopwatches with a per-phase report printed to stderr
(src/STimer.cc, include/STimer.h), and the device-step timers of
bench.py and chip_smoke.py.  For device-level traces use
``jax.profiler.trace`` around a phase (see cli --profile).
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager

import numpy as np


class STimer:
    """Accumulating stopwatch (Start/Stop/Elapsed like the reference)."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.elapsed += time.perf_counter() - self._t0
            self._t0 = None
        return self.elapsed

    def increment(self, dt: float):
        self.elapsed += dt

    @contextmanager
    def timing(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()


class PhaseTimers:
    """Named accumulating timers with a final report."""

    def __init__(self):
        self._timers: dict[str, STimer] = {}

    def __getitem__(self, name: str) -> STimer:
        if name not in self._timers:
            self._timers[name] = STimer()
        return self._timers[name]

    @contextmanager
    def phase(self, name: str):
        with self[name].timing():
            yield

    def report(self, file=sys.stderr):
        for name, t in self._timers.items():
            print(f"{name} took {t.elapsed:f} seconds", file=file)


def chain_seconds(step, x0, reps=3, trials=2):
    """Device seconds per ``step`` call from an in-jit chain.

    K steps run in one dispatch, each perturbed by the last one's output
    (by 1e-30, below the dtype's resolution) so none can be hoisted; the
    dispatch and fetch cost cancels in (chain(K) - chain(1)) / (K - 1).
    Returns (seconds, compiled chain).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    eps = jnp.asarray(1e-30, x0.dtype)

    def chain(x, k):
        def body(i, carry):
            out = step(x + carry * eps)
            return jnp.real(out[(0,) * out.ndim]).astype(x.dtype)

        return lax.fori_loop(0, k, body, jnp.zeros((), x.dtype))

    compiled = jax.jit(chain).lower(x0, jnp.int32(1)).compile()
    np.asarray(compiled(x0, jnp.int32(1)))  # warm
    K = reps + 1
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        np.asarray(compiled(x0, jnp.int32(1)))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.asarray(compiled(x0, jnp.int32(K)))
        tk = time.perf_counter() - t0
        best = min(best, max(tk - t1, 0.0) / (K - 1))
    return best, compiled


def host_seconds(fn, *args, reps=5):
    """Median host-clock seconds of ``fn(*args)`` through block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
