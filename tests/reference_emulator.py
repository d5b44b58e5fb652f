"""Serial emulator of the reference mode-generation algorithm.

A deliberately literal, slow re-expression of the reference pipeline's
phase-1 semantics (LoadPlane walk with serial RNG skip bookkeeping, mirrored
Hermitian twin slabs, BlockArray y-shift on reload, y-Nyquist zeroing, ky=0
fix-up) used ONLY as a test oracle for the vectorized/sharded device
implementation.  Keeps its own serial RNG walk so that the closed-form
offset math in zeldovich.ops is independently validated.
"""

from __future__ import annotations

import math

import numpy as np

from zeldovich.ops import pcg
from zeldovich.ops.mt19937 import MT19937
from zeldovich.utils.power import PowerSpectrum


class V1Rng:
    """Scalar GSL-style mt19937 stream with the reference's rejection
    Box-Muller (cgauss<1>, power_spectrum.cpp:310-332)."""

    def __init__(self, seed):
        self._m = MT19937(seed)

    def uniform(self):
        return float(self._m.integers(1)[0]) * 2.0**-32

    def cgauss(self, Pk, fixed_power):
        while True:
            p1 = self.uniform() * 2.0 - 1.0
            p2 = self.uniform() * 2.0 - 1.0
            r2 = p1 * p1 + p2 * p2
            if 0.0 < r2 < 1.0:
                break
        if fixed_power:
            r2 = math.sqrt(Pk / r2)
        else:
            r2 = math.sqrt(-Pk * math.log(r2) / r2)
        return complex(p1 * r2, p2 * r2)


def cgauss_v2(state, Pk, fixed_power):
    """Deterministic Box-Muller (2 draws) -> (complex, new_state)."""
    r1, state = pcg.next_draw(state)
    r2, state = pcg.next_draw(state)
    R = pcg.one_rand(r1)
    theta = pcg.one_rand(r2)
    if fixed_power:
        amp = math.sqrt(Pk)
    else:
        amp = math.sqrt(-Pk * math.log(R))
    theta = 2 * math.pi * theta
    return complex(amp * math.cos(theta), amp * math.sin(theta)), state


def emulate_plane(
    param, Pk, y, state, gen_phi=False, phi_k=None, eig_lookup=None, v1_rng=None
):
    """One LoadPlane call: returns (slab, her_slab, end_state).

    slab, her_slab: [narray][z][x] complex -- the generated plane y and the
    per-field-conjugated mirror (as the reference stores into slabHer, i.e.
    already at reflected (z, x) indices).
    """
    ppd = param.ppd
    half = ppd // 2
    just_density = param.qdensity == 2
    narray = 1 if (gen_phi or just_density) else param.narray

    slab = np.zeros((narray, ppd, ppd), dtype=np.complex128)
    her = np.zeros((narray, ppd, ppd), dtype=np.complex128)

    kmax = int(half * (1.0 / param.k_cutoff) + 0.5)
    k2_cutoff = param.nyquist * param.nyquist / (param.k_cutoff * param.k_cutoff)
    fund = param.fundamental
    # the reference stores fundamental^2 once (zeldovich.cpp:301) and
    # computes k2 = n2 * fund2: same association order here, so boundary
    # comparisons (k2 >= k2_cutoff) and kmag are bit-identical
    fund2 = fund * fund
    H0, c = 100.0, 299792.458
    growth = 1.0 / (1 + param.z_initial)
    if param.qPLTrescale:
        a_ratio = (1.0 / (1 + param.PLT_target_z)) / (1.0 / (1 + param.z_initial))
    else:
        a_ratio = 1.0
    target_f = (math.sqrt(1.0 + 24 * param.f_cluster) - 1) / 4.0

    checkpoint = state if param.version == 2 else None
    nskip = 0
    ky = y
    for z in range(ppd):
        if z == half + 1:
            nskip += (pcg.MAX_PPD - ppd) * pcg.MAX_PPD
        kz = z - ppd if z > half else z
        zher = 0 if z == 0 else ppd - z
        for x in range(ppd):
            if x == half + 1:
                nskip += pcg.MAX_PPD - ppd
            kx = x - ppd if x > half else x
            xher = 0 if x == 0 else ppd - x
            k2 = (kx * kx + ky * ky + kz * kz) * fund2
            kmag = math.sqrt(k2)

            zeroed = (
                abs(kx) == kmax
                or abs(kz) == kmax
                or abs(ky) == kmax
                or (not param.CornerModes and k2 >= k2_cutoff)
                or (
                    param.qonemode
                    and not (
                        kx == param.one_mode[0]
                        and ky == param.one_mode[1]
                        and kz == param.one_mode[2]
                    )
                )
            )
            if zeroed:
                D = 0.0 + 0.0j
                nskip += 1
            elif param.version == 1:
                D = v1_rng.cgauss(Pk.power(kmag), Pk.fixed_power)
            else:
                if nskip:
                    state = pcg.advance(state, 2 * nskip)
                    nskip = 0
                D, state = cgauss_v2(state, Pk.power(kmag), Pk.fixed_power)

            if k2 == 0.0:
                k2 = 1.0
            ik2 = 1.0 / k2

            # the reference computes M from the POST-substitution k2 (so
            # M(origin) uses k2=1.0 and phi(0) = D/M is finite there; the
            # ky=0 fix-up zeroes the origin afterwards) with this exact
            # multiplication order (zeldovich.cpp:380-383)
            M = (
                2.0 * growth * c * c * Pk.infer_Tk(kmag) * k2
                / (3.0 * param.Omega_M * H0 * H0)
            )

            if gen_phi:
                phi = D / M if M != 0 else 0.0
                slab[0, z, x] = phi
                her[0, zher, xher] = np.conj(phi)
                continue

            if phi_k is not None:
                if kx == 0 and ky == 0 and kz == 0:
                    D = 0.0 + 0.0j
                else:
                    D = phi_k[y, z, x] * M

            if D != 0.0:
                if param.qPLT:
                    evec, ev = eig_lookup(kx, ky, kz)
                    f = (math.sqrt(1.0 + 24 * ev * param.f_cluster) - 1) * 0.25
                    rescale = a_ratio ** (target_f - f) if param.qPLTrescale else 1.0
                else:
                    evec, ev = (kx, ky, kz), 1.0
                    f = 1.0
                    rescale = 1.0
                F = rescale * 1j * evec[0] * fund * ik2 * D
                Gv = rescale * 1j * evec[1] * fund * ik2 * D
                H = rescale * 1j * evec[2] * fund * ik2 * D
            else:
                F = Gv = H = 0.0 + 0.0j
                f = 0.0

            if just_density:
                slab[0, z, x] = D
                her[0, zher, xher] = np.conj(D)
            else:
                slab[0, z, x] = D + 1j * F
                slab[1, z, x] = Gv + 1j * H
                her[0, zher, xher] = np.conj(D) + 1j * np.conj(F)
                her[1, zher, xher] = np.conj(Gv) + 1j * np.conj(H)
                if param.qPLT:
                    slab[2, z, x] = 1j * (F * f)
                    slab[3, z, x] = Gv * f + 1j * (H * f)
                    her[2, zher, xher] = 1j * np.conj(F * f)
                    her[3, zher, xher] = np.conj(Gv * f) + 1j * np.conj(H * f)

    if param.version == 2:
        state = pcg.advance(state, 2 * nskip)
        assert pcg.distance(checkpoint, state) == pcg.DRAWS_PER_PLANE

    # ky=0 self-conjugate fix-up (zeldovich.cpp:485-503)
    if y == 0:
        for z in range(half):
            zher = 0 if z == 0 else ppd - z
            xmax = half if z == 0 else ppd
            for x in range(xmax):
                xher = 0 if x == 0 else ppd - x
                slab[:, zher, xher] = her[:, zher, xher]
        slab[:, 0, 0] = 0.0

    return slab, her, state


def emulate_kgrid(param, Pk, gen_phi=False, phi_k=None, eig_lookup=None):
    """The final k-grid [narray][y][z][x] as presented to the inverse FFTs.

    Assembly per the BlockArray semantics: generated plane y lands at final
    index y; its mirror slab (stored at ppd-1-y) lands at ppd-y after the
    reload y-shift (block_array.cpp:277-291); the shifted-out plane wraps to
    the y-Nyquist plane which is then zeroed (zeldovich.cpp:644-650).
    """
    ppd = param.ppd
    half = ppd // 2
    just_density = param.qdensity == 2
    narray = 1 if (gen_phi or just_density) else param.narray
    G = np.zeros((narray, ppd, ppd, ppd), dtype=np.complex128)

    if param.version == 1:
        # per-y-residual MT19937 streams, y-blocks processed serially
        block = ppd // param.numblock
        rngs = [V1Rng(param.seed + i) for i in range(block)]
        order = [
            (yb * block + yr, yr)
            for yb in range(param.numblock // 2)
            for yr in range(block)
        ]
        for y, yr in order:
            slab, her, _ = emulate_plane(
                param, Pk, y, None, gen_phi=gen_phi, phi_k=phi_k,
                eig_lookup=eig_lookup, v1_rng=rngs[yr],
            )
            G[:, y] = slab
            if y >= 1:
                G[:, ppd - y] = her
        G[:, half] = 0.0
        return G

    states = list(pcg.plane_states(param.seed, half))
    for y in range(half):
        slab, her, _ = emulate_plane(
            param, Pk, y, states[y], gen_phi=gen_phi, phi_k=phi_k, eig_lookup=eig_lookup
        )
        G[:, y] = slab
        if y >= 1:
            G[:, ppd - y] = her
    G[:, half] = 0.0
    return G


def inverse_fft3(G):
    """Unnormalized (FFTW sign +1) inverse FFT over the last three axes."""
    n = G.shape[-1]
    return np.fft.ifftn(G, axes=(-3, -2, -1)) * n**3
