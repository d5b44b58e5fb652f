"""FFT conventions matching the reference (FFTW, unnormalized).

The reference's "inverse" FFT is FFTW sign +1 with no 1/N prefactor
(README.md:127-129, src/zeldovich.cpp:41-135); its forward is sign -1,
also unnormalized.  numpy/JAX ``ifftn`` divides by N per axis, so the
inverse here rescales by N^ndim; ``fftn`` already matches the forward.

Single-device paths; the mesh-sharded pencil FFT lives in
``zeldovich/parallel/pencil_fft.py``.
"""

from __future__ import annotations

import jax.numpy as jnp


def ifft3(a, axes=(-3, -2, -1)):
    """Unnormalized inverse 3-D FFT (FFTW +1 convention)."""
    n = 1
    for ax in axes:
        n *= a.shape[ax]
    return jnp.fft.ifftn(a, axes=axes) * n


def fft3(a, axes=(-3, -2, -1)):
    """Forward 3-D FFT (FFTW -1 convention, unnormalized)."""
    return jnp.fft.fftn(a, axes=axes)


def ifft1(a, axis=-1):
    """Unnormalized inverse 1-D FFT."""
    return jnp.fft.ifft(a, axis=axis) * a.shape[axis]


def fft1(a, axis=-1):
    return jnp.fft.fft(a, axis=axis)
