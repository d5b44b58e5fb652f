"""Matmul (four-step) FFT vs numpy, real-pair representation."""

import numpy as np
import pytest

import jax.numpy as jnp

from zeldovich.ops import mmfft


def pair_of(z):
    return jnp.stack([jnp.asarray(z.real), jnp.asarray(z.imag)])


def to_complex(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


@pytest.mark.parametrize("n", [4, 8, 12, 16, 30, 64, 128, 7])
def test_1d_matches_numpy(n):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    for sign in (+1, -1):
        re, im = mmfft.cfft_last(
            jnp.asarray(z.real), jnp.asarray(z.imag), sign
        )
        got = np.asarray(re) + 1j * np.asarray(im)
        want = np.fft.ifft(z, axis=-1) * n if sign == +1 else np.fft.fft(z, axis=-1)
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_3d_matches_numpy():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(2, 16, 16, 16)) + 1j * rng.normal(size=(2, 16, 16, 16))
    got = to_complex(mmfft.ifft3_pair(pair_of(z)))
    want = np.fft.ifftn(z, axes=(1, 2, 3)) * 16**3
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())

    got = to_complex(mmfft.fft3_pair(pair_of(z)))
    want = np.fft.fftn(z, axes=(1, 2, 3))
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_roundtrip():
    rng = np.random.default_rng(2)
    z = rng.normal(size=(8, 8, 8)) + 1j * rng.normal(size=(8, 8, 8))
    p = pair_of(z)
    back = to_complex(mmfft.fft3_pair(mmfft.ifft3_pair(p))) / 8**9 * 8**6
    np.testing.assert_allclose(back, z, atol=1e-10)


def test_f32_accuracy():
    rng = np.random.default_rng(3)
    n = 64
    z = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).astype(np.complex64)
    re, im = mmfft.cfft_last(
        jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32), -1
    )
    got = np.asarray(re) + 1j * np.asarray(im)
    want = np.fft.fft(z.astype(np.complex128), axis=-1)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 5e-6, rel


def test_four_step_path():
    """Sizes above DENSE_MAX take the four-step split path."""
    n = 2048
    rng = np.random.default_rng(4)
    z = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    re, im = mmfft.cfft_last(jnp.asarray(z.real), jnp.asarray(z.imag), -1)
    got = np.asarray(re) + 1j * np.asarray(im)
    want = np.fft.fft(z, axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("axis", [0, 1, 2, 3, -2, -3, -4])
def test_cfft_axis_matches_numpy(axis):
    """Middle-axis transforms (the in-place einsum contraction path)."""
    rng = np.random.default_rng(6)
    z = rng.normal(size=(4, 6, 8, 5)) + 1j * rng.normal(size=(4, 6, 8, 5))
    n = z.shape[axis]
    for sign in (+1, -1):
        re, im = mmfft.cfft_axis(
            jnp.asarray(z.real), jnp.asarray(z.imag), axis, sign
        )
        got = np.asarray(re) + 1j * np.asarray(im)
        want = np.fft.ifft(z, axis=axis) * n if sign == +1 else np.fft.fft(z, axis=axis)
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_cfft_axis_four_step_middle():
    """A > DENSE_MAX middle axis falls back through cfft_last correctly."""
    rng = np.random.default_rng(7)
    old = mmfft.DENSE_MAX
    try:
        mmfft.DENSE_MAX = 8
        z = rng.normal(size=(3, 16, 4)) + 1j * rng.normal(size=(3, 16, 4))
        re, im = mmfft.cfft_axis(jnp.asarray(z.real), jnp.asarray(z.imag), 1, -1)
    finally:
        mmfft.DENSE_MAX = old
    got = np.asarray(re) + 1j * np.asarray(im)
    want = np.fft.fft(z, axis=1)
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_dense_vs_four_step_agree():
    n = 64
    rng = np.random.default_rng(5)
    z = rng.normal(size=(4, n)) + 1j * rng.normal(size=(4, n))
    old = mmfft.DENSE_MAX
    try:
        mmfft.DENSE_MAX = 1
        a = mmfft.cfft_last(jnp.asarray(z.real), jnp.asarray(z.imag), +1)
        mmfft.DENSE_MAX = 1024
        b = mmfft.cfft_last(jnp.asarray(z.real), jnp.asarray(z.imag), +1)
    finally:
        mmfft.DENSE_MAX = old
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-10)
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), atol=1e-10)
