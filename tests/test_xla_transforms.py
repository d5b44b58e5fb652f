"""The real-pair transforms (ops/mmfft and the out-of-core slab kernels)
against numpy.fft, at the shapes the pipeline uses, incl. 2^a 3^b lengths.

Sign +1 is the reference's unnormalized inverse (numpy ifft times n),
sign -1 the forward transform (numpy fft).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from zeldovich.models import outofcore
from zeldovich.ops import mmfft


def numpy_dft(z, axes, sign):
    if sign == +1:
        n = np.prod([z.shape[a] for a in axes])
        return np.fft.ifftn(z, axes=axes) * n
    return np.fft.fftn(z, axes=axes)


def as_pair(z, axis, dtype):
    """Complex z -> real pair stacked at ``axis`` (re first)."""
    return jnp.stack(
        [jnp.asarray(z.real, dtype), jnp.asarray(z.imag, dtype)], axis=axis
    )


def rand_complex(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def assert_close(got, want, rel):
    np.testing.assert_allclose(
        got, want, atol=rel * np.abs(want).max(), rtol=0
    )


@pytest.mark.parametrize("n", [16, 32, 64, 12, 24, 48])
@pytest.mark.parametrize("sign", [+1, -1])
def test_zx_transform_matches_numpy(n, sign):
    """The in-plane (z, x) pass of ifft3_half_pair, float32 at HIGHEST."""
    rng = np.random.default_rng(n)
    z = rand_complex(rng, (3, 4, n, n))
    spm = as_pair(z, 1, jnp.float32)  # (3, 2, 4, n, n)
    re, im = spm[:, 0], spm[:, 1]
    for ax in (-2, -1):
        re, im = mmfft.cfft_axis(re, im, ax, sign)
    want = numpy_dft(z, (-2, -1), sign)
    assert_close(np.asarray(re), want.real, 2e-6)
    assert_close(np.asarray(im), want.imag, 2e-6)


@pytest.mark.parametrize("n", [1152, 1536, 2048])
def test_four_step_matches_numpy(n):
    """Lengths above DENSE_MAX take the four-step split (2^a 3^b too)."""
    assert n > mmfft.DENSE_MAX
    rng = np.random.default_rng(n)
    z = rand_complex(rng, (2, n))
    re, im = mmfft.cfft_last(
        jnp.asarray(z.real), jnp.asarray(z.imag), +1
    )
    want = numpy_dft(z, (-1,), +1)
    assert_close(np.asarray(re) + 1j * np.asarray(im), want, 1e-12)


def hermitian_pm(rng, n, shape_zx, lead=()):
    """Real fields D, F of shape (*lead, n, *shape_zx) and the half-spectrum
    pm-pair of their y-spectra: (*lead, 2 pm, 2 reim, n/2+1, *shape_zx)."""
    h = n // 2
    D = rng.normal(size=(*lead, n, *shape_zx))
    F = rng.normal(size=(*lead, n, *shape_zx))
    Dk = np.fft.fft(D, axis=-3)
    Fk = np.fft.fft(F, axis=-3)
    sp = (Dk + 1j * Fk)[..., : h + 1, :, :]
    sm = (Dk - 1j * Fk)[..., : h + 1, :, :]
    spm = np.stack(
        [np.stack([sp.real, sp.imag], axis=-4),
         np.stack([sm.real, sm.imag], axis=-4)],
        axis=-5,
    )
    return D, F, spm


@pytest.mark.parametrize("n", [12, 16, 24, 32, 48, 64])
def test_c2r_matches_numpy(n):
    """c2r_y_pair inverts both packed fields: out = n * (D, F)."""
    rng = np.random.default_rng(n)
    D, F, spm = hermitian_pm(rng, n, (4, 6), lead=(2,))
    got = np.asarray(mmfft.c2r_y_pair(jnp.asarray(spm)))
    assert got.shape == (2, 2, n, 4, 6)
    assert_close(got[:, 0], n * D, 1e-12)
    assert_close(got[:, 1], n * F, 1e-12)


@pytest.mark.parametrize("n", [2048, 2304])
def test_c2r_assembled_matches_numpy(n):
    """Above DENSE_MAX the c2r assembles the full y-spectrum (four-step)."""
    rng = np.random.default_rng(n)
    D, F, spm = hermitian_pm(rng, n, (1, 2))
    got = np.asarray(mmfft.c2r_y_pair(jnp.asarray(spm)))
    assert_close(got[0], n * D, 1e-11)
    assert_close(got[1], n * F, 1e-11)


@pytest.mark.parametrize("narray", [1, 2, 4])
def test_half_pipeline_matches_numpy(narray):
    """ifft3_half_pair == numpy's 3-D inverse of the Hermitian grid, for
    the density (1), RVZel (2) and PLT (4) leading shapes."""
    n = 16
    rng = np.random.default_rng(narray)
    D = rng.normal(size=(narray, n, n, n))
    F = rng.normal(size=(narray, n, n, n))
    Dk = np.fft.fftn(D, axes=(-3, -2, -1))
    Fk = np.fft.fftn(F, axes=(-3, -2, -1))
    h = n // 2
    sp = (Dk + 1j * Fk)[:, : h + 1]
    sm = (Dk - 1j * Fk)[:, : h + 1]
    spm = np.stack(
        [np.stack([sp.real, sp.imag], 1), np.stack([sm.real, sm.imag], 1)], 1
    )
    got = np.asarray(mmfft.ifft3_half_pair(jnp.asarray(spm)))
    assert got.shape == (narray, 2, n, n, n)
    assert_close(got[:, 0], n**3 * D, 1e-12)
    assert_close(got[:, 1], n**3 * F, 1e-12)


@pytest.mark.parametrize("sign", [+1, -1])
def test_ooc_zx_slab_matches_numpy(sign):
    """The out-of-core y-slab layout (narray, 2, ny, Z, X): the forward
    z/x pass of the f_NL phi round trip, and its inverse twin."""
    rng = np.random.default_rng(5 + sign)
    z = rand_complex(rng, (2, 3, 16, 16))
    slab = as_pair(z, 1, jnp.float64)
    if sign == -1:
        got = np.asarray(outofcore._fwd_zx_pair(slab))
    else:
        p = jnp.swapaxes(slab, 0, 1)
        re, im = p[0], p[1]
        for ax in (-2, -1):
            re, im = mmfft.cfft_axis(re, im, ax, +1)
        got = np.asarray(jnp.swapaxes(jnp.stack([re, im]), 0, 1))
    want = numpy_dft(z, (-2, -1), sign)
    assert_close(got[:, 0] + 1j * got[:, 1], want, 1e-12)


@pytest.mark.parametrize("sign", [+1, -1])
def test_y_slab_matches_numpy(sign):
    """The out-of-core z-slab layout (narray, 2, Y, Bz, X) along y."""
    rng = np.random.default_rng(8 + sign)
    z = rand_complex(rng, (2, 16, 3, 32))
    slab = as_pair(z, 1, jnp.float64)
    p = jnp.swapaxes(slab, 0, 1)
    re, im = mmfft.cfft_axis(p[0], p[1], -3, sign)
    want = numpy_dft(z, (-3,), sign)
    assert_close(np.asarray(re) + 1j * np.asarray(im), want, 1e-12)


@pytest.mark.parametrize("bz", [1, 3, 4, 8, 12, 16])
def test_ooc_y_transform_any_bz(bz):
    """_ifft_y_pair for every z-slab thickness the slab loop can pick."""
    rng = np.random.default_rng(bz)
    n = 32
    z = rand_complex(rng, (2, n, bz, n))
    got = np.asarray(outofcore._ifft_y_pair(as_pair(z, 1, jnp.float64)))
    want = numpy_dft(z, (-3,), +1)
    assert got.shape == (2, 2, n, bz, n)
    assert_close(got[:, 0] + 1j * got[:, 1], want, 1e-12)
