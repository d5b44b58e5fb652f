"""Exact-primitive f32 transcendentals (ops/accurate.py) and split uniforms."""

import jax.numpy as jnp
import numpy as np

from zeldovich.ops import accurate, pcg_device


def test_sincos_2pi_ulp():
    t = np.random.default_rng(0).uniform(0.0, 1.0, 200000).astype(np.float32)
    c, s = accurate.sincos_2pi(jnp.asarray(t))
    want_c = np.cos(2 * np.pi * t.astype(np.float64))
    want_s = np.sin(2 * np.pi * t.astype(np.float64))
    # absolute error bound (values in [-1, 1]): ~2 ulp of 1.0
    assert np.abs(np.asarray(c, np.float64) - want_c).max() < 4e-7
    assert np.abs(np.asarray(s, np.float64) - want_s).max() < 4e-7


def test_sincos_2pi_split_precision():
    """The t_lo correction recovers sub-f32 angle resolution."""
    rng = np.random.default_rng(1)
    t64 = rng.uniform(0.0, 1.0, 50000)
    t_hi = t64.astype(np.float32)
    t_lo = (t64 - t_hi.astype(np.float64)).astype(np.float32)
    c, s = accurate.sincos_2pi(jnp.asarray(t_hi), jnp.asarray(t_lo))
    want_c = np.cos(2 * np.pi * t64)
    want_s = np.sin(2 * np.pi * t64)
    assert np.abs(np.asarray(c, np.float64) - want_c).max() < 4e-7
    assert np.abs(np.asarray(s, np.float64) - want_s).max() < 4e-7


def test_log_f32_ulp():
    x = np.exp(
        np.random.default_rng(2).uniform(np.log(1e-30), 0.0, 200000)
    ).astype(np.float32)
    got = np.asarray(accurate.log_f32(jnp.asarray(x)), np.float64)
    want = np.log(x.astype(np.float64))
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < 5e-7, rel.max()


def test_log_uniform_matches_f64():
    rng = np.random.default_rng(3)
    r = rng.integers(0, 2**64, 100000, dtype=np.uint64)
    r[:4] = [0, 1, 2**40 - 1, 2**64 - 2]  # tiny-draw corners
    hi, lo = pcg_device.split_uniform_f32(jnp.asarray(r))
    got = np.asarray(accurate.log_uniform(hi, lo), np.float64)
    # exact value: ln((r+1) / 2^64)
    want = np.log((r.astype(np.float64) + 1)) - 64 * np.log(2.0)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert rel.max() < 1e-6, rel.max()


def test_split_uniform_exact():
    rng = np.random.default_rng(4)
    r = rng.integers(0, 2**64, 100000, dtype=np.uint64)
    r[0] = 2**64 - 1  # all-ones guard -> 1.0
    hi, lo = pcg_device.split_uniform_f32(jnp.asarray(r))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    want = np.where(
        r == 2**64 - 1, 1.0, (r.astype(np.float64) + 1) * 2.0**-64
    )
    # one rounded f32 add with |lo| <= 2^-24: error <= 0.5 ulp(2^-24)
    assert np.abs(got - want).max() < 4e-15
