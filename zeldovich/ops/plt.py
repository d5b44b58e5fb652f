"""Particle Linear Theory eigenmodes: table IO + device trilinear lookup.

The eigenmode table holds, for each point of the ``ppd_e^2 x (ppd_e/2+1)``
half-space k-grid, a unit eigenvector (3 doubles) and an eigenvalue
(1 double): the true growing mode of a perturbed simple-cubic particle
lattice (Marcos et al. 2006; Garrison et al. 2016).  File format matches
the reference loader (src/zeldovich.cpp:794-830): a 4-byte little-endian
int ``ppd_e`` followed by ``ppd_e*ppd_e*(ppd_e/2+1)*4`` float64s.

``eigenmode_lookup`` reproduces get_eigenmode/interp_eigmode
(src/zeldovich.cpp:149-276) as vectorized device gathers: numpy-rfft index
un-wrapping, trilinear interpolation in k-index space with the +/-Nyquist
discontinuity mapped upward, re-normalization of the interpolated
eigenvector, and the ``k^2/(k . e)`` up-weighting.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np


def load_eigmodes(path) -> np.ndarray:
    """Read an eigenmode table -> float64 array (ppd_e, ppd_e, ppd_e//2+1, 4)."""
    raw = Path(path).read_bytes()
    ppd_e = int(np.frombuffer(raw[:4], dtype="<i4")[0])
    nelem = ppd_e * ppd_e * (ppd_e // 2 + 1) * 4
    expect = 4 + nelem * 8
    if len(raw) != expect:
        raise ValueError(
            f"eigenmode file {path}: size {len(raw)} != expected {expect} "
            f"for ppd {ppd_e}"
        )
    table = np.frombuffer(raw[4:], dtype="<f8").reshape(
        ppd_e, ppd_e, ppd_e // 2 + 1, 4
    )
    return table


def save_eigmodes(path, table: np.ndarray):
    """Write a table in the reference binary format."""
    ppd_e = table.shape[0]
    assert table.shape == (ppd_e, ppd_e, ppd_e // 2 + 1, 4)
    with open(path, "wb") as fp:
        np.array([ppd_e], dtype="<i4").tofile(fp)
        np.ascontiguousarray(table, dtype="<f8").tofile(fp)


def _interp_eigmode(ikx, iky, ikz, ppd: int, table, fdt):
    """Trilinear interpolation in k-index space (zeldovich.cpp:154-227).

    ikx, iky in [0, ppd); ikz in [0, ppd/2] (rfft half-space indices).
    Returns (..., 4) interpolated values.
    """
    eig_ppd = table.shape[0]
    halfppd = eig_ppd // 2 + 1
    ppdhalf = eig_ppd // 2

    if eig_ppd % ppd == 0:
        # grid points coincide: direct gather
        step = eig_ppd // ppd
        return table[ikx * step, iky * step, ikz * step].astype(fdt)

    scale = fdt(eig_ppd) / fdt(ppd)
    fx = scale * ikx.astype(fdt)
    fy = scale * iky.astype(fdt)
    fz = scale * ikz.astype(fdt)

    # don't interpolate across the +Nyquist / -Nyquist discontinuity:
    # map the open interval (ppd_e/2, ppd_e/2+1) up to the negative side
    def fix(f):
        return jnp.where((f > ppdhalf) & (f < halfppd), jnp.floor(f + 1), f)

    fx, fy, fz = fix(fx), fix(fy), fix(fz)

    ixl = fx.astype(jnp.int32)
    iyl = fy.astype(jnp.int32)
    izl = fz.astype(jnp.int32)
    # ik_h == eig_ppd wraps to 0 (interpolate between -1 and 0 frequencies)
    ixh = jnp.where(ixl + 1 == eig_ppd, 0, ixl + 1)
    iyh = jnp.where(iyl + 1 == eig_ppd, 0, iyl + 1)
    izh = jnp.where(izl + 1 == eig_ppd, 0, izl + 1)
    # guard: when f is integral at the half-space edge, the high index is
    # unused (weight 0) but must stay in bounds for the z axis
    izh = jnp.minimum(izh, halfppd - 1)

    fx = fx - ixl
    fy = fy - iyl
    fz = fz - izl

    t = table.astype(fdt)
    e = (
        ((1 - fx) * (1 - fy) * (1 - fz))[..., None] * t[ixl, iyl, izl]
        + ((1 - fx) * (1 - fy) * fz)[..., None] * t[ixl, iyl, izh]
        + ((1 - fx) * fy * (1 - fz))[..., None] * t[ixl, iyh, izl]
        + ((1 - fx) * fy * fz)[..., None] * t[ixl, iyh, izh]
        + (fx * (1 - fy) * (1 - fz))[..., None] * t[ixh, iyl, izl]
        + (fx * (1 - fy) * fz)[..., None] * t[ixh, iyl, izh]
        + (fx * fy * (1 - fz))[..., None] * t[ixh, iyh, izl]
        + (fx * fy * fz)[..., None] * t[ixh, iyh, izh]
    )
    return e


def eigenmode_lookup(kx, ky, kz, ppd: int, table, dtype=jnp.float64):
    """get_eigenmode (zeldovich.cpp:229-276), vectorized.

    kx, ky, kz: integer wavenumber arrays (wrapped to [-ppd/2, ppd/2]).
    Returns ((ex, ey, ez), eigenvalue) where the vector carries the
    ``k^2 / (k . e_hat)`` up-weighting (zero where ill-defined).

    Evaluated in float64 whenever jax has it, and returned in ``dtype``:
    the interpolation cancels near the axes (transverse components of
    near-Nyquist modes) and the up-weighting divides by the result, so in
    float32 those modes move by up to ~1e-4 of the field's scale at
    256^3, growing with ppd over the table size.
    """
    import jax

    out_dtype = dtype
    fdt = jnp.float64 if jax.config.jax_enable_x64 else dtype
    ikx = jnp.where(kx < 0, ppd + kx, kx)
    iky = jnp.where(ky < 0, ppd + ky, ky)
    ikz = jnp.where(kz < 0, ppd + kz, kz)
    # rfft convention: use the +kz half-space index
    ikz = jnp.where(ikz > ppd // 2, ppd - ikz, ikz)

    e = _interp_eigmode(ikx, iky, ikz, ppd, table, fdt)
    ex, ey, ez, ev = e[..., 0], e[..., 1], e[..., 2], e[..., 3]
    # the real FFT only stores the +kz half-space: flip the z component
    ez = ez * jnp.where(kz < 0, fdt(-1), fdt(1))

    mag = jnp.sqrt(ex * ex + ey * ey + ez * ez)
    mag = jnp.where(mag == 0, fdt(1), mag)
    ex, ey, ez = ex / mag, ey / mag, ez / mag

    k2 = (kx * kx + ky * ky + kz * kz).astype(fdt)
    dot = kx * ex + ky * ey + kz * ez
    norm = k2 / jnp.where(dot == 0, fdt(1), dot)
    norm = jnp.where((k2 == 0) | (dot == 0) | ~jnp.isfinite(norm), fdt(0), norm)
    vec = tuple((norm * c).astype(out_dtype) for c in (ex, ey, ez))
    return vec, ev.astype(out_dtype)
