"""Run-wide backend settings: the compilation cache and the default route.

The default compute route is the complex one -- mode synthesis plus
``jnp.fft`` (cuFFT on a GPU, DUCC on the CPU) -- on every backend: on an
H100 it beat the real-pair matmul-DFT route at 512^3 for float32, float32
PLT and float64 PLT (PERF.md, "Route timings").  ``--pair`` keeps the
real-pair route reachable, and ``--dtype df64`` always takes it (its
two-float transforms exist only in pair form).
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

#: The checkout root: the default compilation cache lives inside it.
CHECKOUT = Path(__file__).resolve().parents[2]

#: Compilation cache used when JAX_COMPILATION_CACHE_DIR is not set.  A
#: fixed path, because the cache key includes it: a directory that moves
#: between runs never hits.
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


@functools.cache
def enable_compilation_cache() -> str:
    """Turn on jax's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (jax reads
    it itself) and no other directory is set here.  Otherwise the cache
    is the fixed ``.jax_cache`` directory of the checkout.
    """
    import jax

    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not d:
        d = str(DEFAULT_CACHE_DIR)
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d


def use_pair_route(dtype_name: str, pair: bool = False) -> bool:
    """Whether a run takes the real-pair (matmul-DFT) route.

    ``dtype_name`` is the CLI's ``--dtype``; ``pair`` is ``--pair``.  Only
    df64 and an explicit ``--pair`` do: the complex route is the measured
    default on the GPU and the reference path on the CPU.
    """
    return pair or dtype_name == "df64"
