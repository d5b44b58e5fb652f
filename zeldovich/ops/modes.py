"""Fused Gaussian-mode synthesis: the hot k-space kernel.

Replaces the reference's serial per-plane walk (``LoadPlane``,
src/zeldovich.cpp:278-515) with a pure elementwise function of the global
grid index (y, z, x):

* the pcg64 stream position of any mode is a closed-form affine jump
  (ops/pcg.py), so every mode is independently generatable on any shard;
* the Hermitian structure is enforced *analytically*: instead of the
  reference's mirrored-slab + disk-transpose + y-shift trick
  (zeldovich.cpp:460-469, block_array.cpp:277-291), each output element
  whose index lies in the "mirror" half simply re-derives its source mode's
  fields and conjugates them.  Zero communication, no reflection gathers --
  the whole op is embarrassingly parallel and shards over any mesh.

The resulting k-grid is elementwise identical to what the reference's
phase-1 (ZeldovichZ + BlockArray round-trip + y-Nyquist zeroing) produces:

* planes ``y in [1, ppd/2)``: raw RNG modes;
* plane ``y = ppd/2``: zero (Nyquist, zeldovich.cpp:644-650);
* planes ``y in (ppd/2, ppd)``: per-field conjugates of plane ``ppd-y`` at
  reflected (z, x);
* plane ``y = 0``: self-conjugate fix-up (zeldovich.cpp:485-503) -- the
  ``z > ppd/2`` half and the ``z = 0, x > ppd/2`` half-line mirror the
  positive half; the origin is zeroed.

Four real fields are packed into two complex arrays ``A = delta + i q_x``,
``B = q_y + i q_z`` (plus two velocity arrays under PLT), matching the
reference packing so the same inverse-FFT decode applies.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.params import Parameters
from . import pcg, pcg_device


@dataclass(frozen=True)
class SynthConfig:
    """Static (trace-time) configuration for the synthesis kernel."""

    ppd: int
    fundamental: float
    kmax_int: int  # Nyquist-index rule: int(half * (1/k_cutoff) + .5),
    #               the reference's ik_cutoff form (zeldovich.cpp:302,350)
    k2_cutoff: float  # physical (nyquist/k_cutoff)^2 sphere
    # integer form of the sphere rule: smallest n2 with n2*fund^2 >=
    # k2_cutoff evaluated in float64 -- the cutoff decision is then exact
    # in EVERY compute dtype (an f32 k2 comparison can flip boundary
    # modes relative to the f64 reference)
    n2_cutoff: int
    corner_modes: bool
    qonemode: bool
    one_mode: tuple[int, int, int]
    fixed_power: bool
    qPLT: bool
    qPLTrescale: bool
    f_cluster: float
    plt_rescale_base: float  # a_NL / a0
    plt_target_f: float  # continuum growth rate at f_cluster
    narray: int  # 1 (density-only), 2, or 4 (PLT velocities)
    just_density: bool

    @classmethod
    def from_params(cls, param: Parameters, fixed_power: bool) -> "SynthConfig":
        half = param.ppd // 2
        if param.qPLTrescale:
            a_NL = 1.0 / (1 + param.PLT_target_z)
            a0 = 1.0 / (1 + param.z_initial)
        else:
            a_NL = a0 = 1.0
        k2_cutoff = (
            param.nyquist * param.nyquist / (param.k_cutoff * param.k_cutoff)
        )
        fund2 = np.float64(param.fundamental) * np.float64(param.fundamental)
        # smallest integer n2 with n2 * fund^2 >= k2_cutoff under float64
        # arithmetic (exactly the reference's double comparison)
        n2_cut = int(np.ceil(k2_cutoff / float(fund2)))
        while n2_cut > 0 and np.float64(n2_cut - 1) * fund2 >= k2_cutoff:
            n2_cut -= 1
        while np.float64(n2_cut) * fund2 < k2_cutoff:
            n2_cut += 1
        return cls(
            ppd=param.ppd,
            fundamental=param.fundamental,
            kmax_int=int(half * (1.0 / param.k_cutoff) + 0.5),
            k2_cutoff=k2_cutoff,
            n2_cutoff=n2_cut,
            corner_modes=bool(param.CornerModes),
            qonemode=bool(param.qonemode),
            one_mode=tuple(param.one_mode),
            fixed_power=fixed_power,
            qPLT=bool(param.qPLT),
            qPLTrescale=bool(param.qPLTrescale),
            f_cluster=param.f_cluster,
            plt_rescale_base=a_NL / a0,
            plt_target_f=(np.sqrt(1.0 + 24 * param.f_cluster) - 1) / 4.0,
            narray=param.narray,
            just_density=param.qdensity == 2,
        )


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class SynthTables:
    """Device arrays consumed by the kernel (host-precomputed)."""

    # RNG limb tables are TUPLES of four u32 limb-plane arrays (least-
    # significant first), never a trailing length-4 axis (see
    # ops/pcg_device.py).
    planes: tuple  # 4 x (ppd//2,) u32 per-y-plane RNG states
    # the z (outer) affine table carries one pre-folded LCG step
    # (pcg.prebump_axis_tables): applying the composed map yields the
    # state at the mode's FIRST draw directly
    mz: tuple  # 4 x (ppd,) u32 z-axis affine multipliers (pre-bumped)
    cz: tuple  # 4 x (ppd,) u32 z-axis affine increments (pre-bumped)
    mx: tuple  # 4 x (ppd,) u32 x-axis affine multipliers
    cx: tuple  # 4 x (ppd,) u32 x-axis affine increments
    pk_n2: jax.Array  # (3*(ppd/2)^2+1,) f64 P(|k|) by integer n2
    M_n2: jax.Array | None  # same-indexed f_NL M(k, a) factor
    eig: jax.Array | None  # (ppd_e, ppd_e, ppd_e//2+1, 4) PLT eigenmodes
    # precomposed (z, x) jump maps: 4 x (ppd, ppd) u32 -- with the
    # pre-bumped z table this cuts a mode's 128-bit multiplies from 5 to
    # 2 (one madd lands on the draw-1 state, one bump gives draw 2);
    # built once on device at setup
    mzx: tuple | None = None
    czx: tuple | None = None

    def tree_flatten(self):
        fields = (
            self.planes,
            self.mz,
            self.cz,
            self.mx,
            self.cx,
            self.pk_n2,
            self.M_n2,
            self.eig,
            self.mzx,
            self.czx,
        )
        return fields, None

    @classmethod
    def tree_unflatten(cls, aux, fields):
        return cls(*fields)

    @classmethod
    def build(
        cls,
        seed: int,
        ppd: int,
        pk_n2: np.ndarray,
        M_n2=None,
        eig=None,
        precompose: bool | None = None,
    ) -> "SynthTables":
        # the z (outer) table carries one pre-folded LCG step, so applying
        # the composed (z, x) map lands directly on the state at the
        # mode's first draw -- one fewer 128-bit madd per mode in every
        # draw chain (pcg.prebump_axis_tables)
        mz, cz = pcg.prebump_axis_tables(
            *pcg.axis_affine_tables(ppd, 2 * pcg.MAX_PPD)
        )
        mx, cx = pcg.axis_affine_tables(ppd, 2)

        def split(a, bcast=None):  # (n, 4) host -> 4 x (n,) device tuple
            t = tuple(jnp.asarray(np.ascontiguousarray(a[:, j])) for j in range(4))
            if bcast is not None:
                t = tuple(x[bcast] for x in t)
            return t

        if precompose is None:
            precompose = ppd <= 4096  # 2 * ppd^2 * 16 B of device memory
        mzx = czx = None
        if precompose:
            mzx, czx = jax.jit(pcg_device.compose_affine)(
                split(mz, (slice(None), None)),
                split(cz, (slice(None), None)),
                split(mx, (None, slice(None))),
                split(cx, (None, slice(None))),
            )
        return cls(
            planes=split(pcg.plane_state_table(seed, ppd)),
            mz=split(mz),
            cz=split(cz),
            mx=split(mx),
            cx=split(cx),
            pk_n2=jnp.asarray(pk_n2),
            M_n2=None if M_n2 is None else jnp.asarray(M_n2),
            eig=None if eig is None else jnp.asarray(eig),
            mzx=mzx,
            czx=czx,
        )


def zero_rules(kx, ky, kz, n2, cfg: SynthConfig, dtype=None):
    """Mode-zeroing mask (zeldovich.cpp:349-358): Nyquist index, k_cutoff
    sphere (unless CornerModes), one-mode filter.  THE single source of
    truth -- the complex, pair, pk_effective and source-resolved paths all
    call this so a rule change cannot desynchronize them.

    The sphere rule compares the exact integer n2 against the host-
    precomputed f64 threshold (cfg.n2_cutoff): dtype-independent, so the
    f32/df64 paths classify boundary modes identically to the f64
    reference comparison.
    """
    zero = (
        (jnp.abs(kx) == cfg.kmax_int)
        | (jnp.abs(ky) == cfg.kmax_int)
        | (jnp.abs(kz) == cfg.kmax_int)
    )
    if not cfg.corner_modes:
        zero |= n2 >= cfg.n2_cutoff
    if cfg.qonemode:
        om = cfg.one_mode
        zero |= ~((kx == om[0]) & (ky == om[1]) & (kz == om[2]))
    return zero


def hermitian_source(y, z, x, ppd: int):
    """Map an output grid index to its generating mode and conjugation flag.

    Returns (sy, sz, sx, mirror, hard_zero): the source index always lies in
    the generated half-space ``sy in [0, ppd/2)``; ``mirror`` marks entries
    that take the per-field conjugate of the source; ``hard_zero`` marks the
    y-Nyquist plane and the origin.
    """
    half = ppd // 2
    mirror = (y > half) | (
        (y == 0) & ((z > half) | ((z == 0) & (x > half)))
    )
    sy = jnp.where(mirror, (ppd - y) % ppd, y)
    sz = jnp.where(mirror, (ppd - z) % ppd, z)
    sx = jnp.where(mirror, (ppd - x) % ppd, x)
    hard_zero = (y == half) | ((y == 0) & (z == 0) & (x == 0))
    return sy, sz, sx, mirror, hard_zero


def _raw_fields(
    sy, sz, sx, cfg: SynthConfig, tables: SynthTables, dtype, phi_val=None,
    D_source=None,
):
    """Compute the four field coefficients (D, F, G, H) and PLT growth f at
    the *source* (generator half-space) index.  All elementwise.

    phi_val: phi(k) already evaluated at the source index (f_NL input pass).
    D_source: precomputed delta(k) on the generated half-space
    (ppd/2, ppd, ppd) -- the legacy ZD_Version=1 host-generated field.
    """
    ppd, half = cfg.ppd, cfg.ppd // 2
    fdt = dtype
    cdt = jnp.complex128 if dtype == jnp.float64 else jnp.complex64

    ky = sy  # generated planes have 0 <= sy < ppd/2: never wraps
    kz = jnp.where(sz > half, sz - ppd, sz)
    kx = jnp.where(sx > half, sx - ppd, sx)
    n2 = (kx * kx + ky * ky + kz * kz).astype(jnp.int32)
    k2 = n2.astype(fdt) * fdt(cfg.fundamental) ** 2

    if phi_val is not None:
        # f_NL input pass: D is unconditionally phi(k) * M(k) except at the
        # origin (zeldovich.cpp:393-400).  The mode-zeroing rules were
        # already applied when phi was generated; the f_NL mode coupling
        # repopulates those modes and the reference keeps that power.
        zero = n2 == 0
    else:
        zero = zero_rules(kx, ky, kz, n2, cfg)

    if phi_val is not None:
        pass
    elif D_source is not None:
        # legacy v1 field, generated host-side (ops/v1.py)
        D = D_source[sy, sz, sx].astype(
            jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        )
    else:
        # Gaussian deviate scaled by sqrt(P(k)): deterministic Box-Muller,
        # exactly 2 draws per mode (power_spectrum.cpp:338-359).
        sy_rng = jnp.minimum(sy, half - 1)  # y-Nyquist rows are zeroed anyway
        gather = pcg_device.gather
        if tables.mzx is not None:
            R, T = pcg_device.uniform_pair_from_affine(
                gather(tables.planes, sy_rng),
                gather(tables.mzx, (sz, sx)),
                gather(tables.czx, (sz, sx)),
                dtype=fdt,
            )
        else:
            R, T = pcg_device.mode_uniform_pair(
                gather(tables.planes, sy_rng),
                gather(tables.mz, sz),
                gather(tables.cz, sz),
                gather(tables.mx, sx),
                gather(tables.cx, sx),
                dtype=fdt,
            )
        Pk = tables.pk_n2[n2].astype(fdt)
        if cfg.fixed_power:
            amp = jnp.sqrt(Pk)
        else:
            amp = jnp.sqrt(-Pk * jnp.log(R))
        cosv, sinv = pcg_device.sincos_2pi(T, fdt)
        D = jax.lax.complex(amp * cosv, amp * sinv).astype(cdt)
    if phi_val is not None:
        # f_NL input pass: delta(k) = phi(k) * M(k)  (zeldovich.cpp:393-400)
        D = phi_val * tables.M_n2[n2].astype(fdt)

    D = jnp.where(zero, cdt(0), D)

    # Displacement kernel i k / k^2 (continuum) or PLT eigenmode projection.
    ik2 = jnp.where(n2 == 0, fdt(0), 1.0 / jnp.where(n2 == 0, fdt(1), k2))
    if cfg.qPLT:
        from .plt import eigenmode_lookup  # local import to avoid cycle

        evec, eval_ = eigenmode_lookup(kx, ky, kz, ppd, tables.eig, dtype=fdt)
        f = (jnp.sqrt(1.0 + 24.0 * eval_ * fdt(cfg.f_cluster)) - 1.0) * fdt(0.25)
        if cfg.qPLTrescale:
            rescale = fdt(cfg.plt_rescale_base) ** (fdt(cfg.plt_target_f) - f)
        else:
            rescale = fdt(1.0)
    else:
        evec = (kx.astype(fdt), ky.astype(fdt), kz.astype(fdt))
        eval_ = fdt(1.0)
        f = fdt(1.0)  # unused without PLT velocity arrays
        rescale = fdt(1.0)

    scale = rescale * fdt(cfg.fundamental) * ik2
    iD = jax.lax.complex(-D.imag, D.real)  # i * D
    F = (evec[0] * scale) * iD
    G = (evec[1] * scale) * iD
    H = (evec[2] * scale) * iD
    return D, F, G, H, f


def synthesize(
    y,
    z,
    x,
    cfg: SynthConfig,
    tables: SynthTables,
    dtype=jnp.float64,
    gen_phi: bool = False,
    phi_k=None,
    D_source=None,
):
    """Synthesize the packed k-space arrays for output grid indices.

    y, z, x: broadcastable integer index arrays (e.g. an open meshgrid).
    Returns a complex array of shape (narray, *broadcast_shape) -- or
    (1, ...) carrying phi(k) when ``gen_phi``.

    phi_k (f_NL input pass) is either the full global phi(k) grid (gathered
    at the Hermitian source index) or, for sharded execution, a tuple
    ``(phi_block, phi_refl_block)`` of local blocks matching the output
    shape -- phi at (y,z,x) and at the reflected index -- so no cross-shard
    gather is needed.
    """
    cdt = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    ppd = cfg.ppd
    y, z, x = jnp.broadcast_arrays(
        jnp.asarray(y), jnp.asarray(z), jnp.asarray(x)
    )
    sy, sz, sx, mirror, hard_zero = hermitian_source(y, z, x, ppd)

    phi_val = None
    if phi_k is not None and not gen_phi:
        if isinstance(phi_k, tuple):
            phi_same, phi_refl = phi_k
            phi_val = jnp.where(mirror, phi_refl, phi_same)
        else:
            phi_val = phi_k[sy, sz, sx]

    if gen_phi:
        # phi(k) = D / M  (zeldovich.cpp:385-391), narray = 1
        D, _, _, _, _ = _raw_fields(
            sy, sz, sx, cfg, tables, dtype, D_source=D_source
        )
        half = ppd // 2
        ky = sy
        kz = jnp.where(sz > half, sz - ppd, sz)
        kx = jnp.where(sx > half, sx - ppd, sx)
        n2 = (kx * kx + ky * ky + kz * kz).astype(jnp.int32)
        M = tables.M_n2[n2].astype(dtype)
        phi = D / jnp.where(n2 == 0, dtype(1.0), M)
        phi = jnp.where(mirror, phi.conj(), phi)
        phi = jnp.where(hard_zero, cdt(0), phi)
        return phi[None]

    D, F, G, H, f = _raw_fields(
        sy, sz, sx, cfg, tables, dtype, phi_val=phi_val, D_source=D_source
    )

    def C(w):
        return jnp.where(mirror, w.conj(), w)

    def iC(w):  # i * C(w)
        w = C(w)
        return jax.lax.complex(-w.imag, w.real)

    if cfg.just_density:
        out = C(D)[None]
    else:
        A = C(D) + iC(F)
        B = C(G) + iC(H)
        if cfg.qPLT:
            A2 = iC(F * f)
            B2 = C(G * f) + iC(H * f)
            out = jnp.stack([A, B, A2, B2])
        else:
            out = jnp.stack([A, B])
    return jnp.where(hard_zero[None], cdt(0), out)


@partial(jax.jit, static_argnames=("cfg", "dtype", "gen_phi", "ny"))
def synthesize_slab(
    y0,
    ny: int,
    cfg: SynthConfig,
    tables: SynthTables,
    dtype=jnp.float64,
    gen_phi: bool = False,
    phi_k=None,
    D_source=None,
):
    """Synthesize a y-slab [y0, y0+ny) of the full k-grid: (narray, ny, ppd, ppd)."""
    ppd = cfg.ppd
    y = (y0 + jnp.arange(ny))[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]
    return synthesize(
        y, z, x, cfg, tables, dtype=dtype, gen_phi=gen_phi, phi_k=phi_k,
        D_source=D_source,
    )
