"""The XLA draw chain (pcg64 jump + draws + Box-Muller) against the
scalar pcg64 oracle (ops/pcg.py), mode by mode over the generated half."""

import numpy as np
import pytest

import jax.numpy as jnp

from test_modes import make_setup
from zeldovich.ops import pcg
from zeldovich.ops.modes_real import _raw_fields_pair, pk_effective


def oracle_D(seed, ppd, pk, fixed):
    """D = amp * exp(2 pi i T) per mode from the scalar oracle's uniforms."""
    half = ppd // 2
    D = np.zeros((half, ppd, ppd), np.complex128)
    for y in range(half):
        for z in range(ppd):
            for x in range(ppd):
                R, T = pcg.mode_uniforms(seed, y, z, x, ppd)
                p = pk[y, z, x]
                amp = np.sqrt(p) if fixed else np.sqrt(-p * np.log(R))
                D[y, z, x] = amp * np.exp(2j * np.pi * T)
    return D


@pytest.mark.parametrize("ppd", [8, 12])
@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_draw_chain_matches_scalar_oracle(dtype, fixed, ppd):
    over = {"ZD_qPk_fix_to_mean": 1} if fixed else {}
    param, Pk, cfg, tables = make_setup(ppd=ppd, **over)
    assert cfg.fixed_power == fixed
    pk_eff = pk_effective(cfg, tables, dtype)
    half = ppd // 2
    y = jnp.arange(half)[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]
    (D_re, D_im), *_ = _raw_fields_pair(
        y, z, x, cfg, tables, dtype, pk_eff=pk_eff
    )
    got = np.asarray(D_re, np.float64) + 1j * np.asarray(D_im, np.float64)
    want = oracle_D(param.seed, ppd, np.asarray(pk_eff, np.float64), fixed)
    # float64 consumes the exact uniforms; float32 the documented fast
    # draw semantics (pcg_device: ~2^-25 absolute on the uniform, which
    # sqrt(-log R) amplifies to ~1e-6 relative at the smallest R drawn)
    rel = 1e-12 if dtype == jnp.float64 else 1e-5
    np.testing.assert_allclose(
        got, want, atol=rel * np.abs(want).max(), rtol=0
    )
