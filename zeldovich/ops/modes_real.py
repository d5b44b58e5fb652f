"""Complex-free mode synthesis: (re, im) real-pair kernels.

Same math as ops/modes (elementwise, shardable) and ops/modes_fast
(half-space + reflection assembly) with every complex number carried as an
explicit (re, im) pair, so the compiled graph contains no complex dtypes.
This is the real-pair route's synthesis (``--pair`` and ``--dtype df64``);
the pair layout is what the matmul FFT (ops/mmfft) consumes.

Equality with the complex paths is asserted in tests; changes here must
keep the complex twins in sync.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import pcg_device
from .modes import SynthConfig, SynthTables, hermitian_source, zero_rules
from .modes_fast import _reflect_zx


def pk_effective(cfg: SynthConfig, tables: SynthTables, dtype):
    """Static per-run amplitude field: zero-rule mask folded into P(k).

    The n2 -> P(k) table gather is a per-mode gather, but its result
    is constant for a given configuration -- like the reference's FFTW
    planning, it belongs in setup.  pk = 0 exactly zeroes the Box-Muller
    output (sqrt(-0 * log R) == 0), so the mask needs no separate array.
    Returns (half, Z, X) in ``dtype``.
    """
    ppd, half = cfg.ppd, cfg.ppd // 2
    fdt = dtype
    y = jnp.arange(half)[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]
    kz = jnp.where(z > half, z - ppd, z)
    kx = jnp.where(x > half, x - ppd, x)
    n2 = (kx * kx + y * y + kz * kz).astype(jnp.int32)
    k2 = n2.astype(fdt) * fdt(cfg.fundamental) ** 2
    zero = zero_rules(kx, y, kz, n2, cfg)
    pk = tables.pk_n2[n2].astype(fdt)
    return jnp.where(zero, fdt(0), pk)


def _raw_fields_pair(
    sy, sz, sx, cfg: SynthConfig, tables: SynthTables, dtype, phi_pair_val=None,
    pk_eff=None, accurate=False,
):
    """Real-pair twin of modes._raw_fields at source indices (sy, sz, sx).

    phi_pair_val: optional (re, im) tuple of phi(k) at the source index.
    Returns (D, F, G, H, f) where each field is an (re, im) tuple.
    """
    ppd, half = cfg.ppd, cfg.ppd // 2
    fdt = dtype

    ky = sy
    kz = jnp.where(sz > half, sz - ppd, sz)
    kx = jnp.where(sx > half, sx - ppd, sx)
    n2 = (kx * kx + ky * ky + kz * kz).astype(jnp.int32)
    k2 = n2.astype(fdt) * fdt(cfg.fundamental) ** 2

    if phi_pair_val is not None:
        zero = n2 == 0
    else:
        zero = zero_rules(kx, ky, kz, n2, cfg)

    if phi_pair_val is not None:
        M = tables.M_n2[n2].astype(fdt)
        D_re = phi_pair_val[0] * M
        D_im = phi_pair_val[1] * M
    else:
        sy_rng = jnp.minimum(sy, half - 1)
        gather = pcg_device.gather
        plane = gather(tables.planes, sy_rng)
        if tables.mzx is not None:
            m = gather(tables.mzx, (sz, sx))
            c = gather(tables.czx, (sz, sx))
        else:
            m, c = pcg_device.compose_affine(
                gather(tables.mz, sz), gather(tables.cz, sz),
                gather(tables.mx, sx), gather(tables.cx, sx),
            )
        if pk_eff is not None:
            # precomputed amplitude field (zero rules folded in)
            Pk = pk_eff
            zf = fdt(1.0)
        else:
            Pk = tables.pk_n2[n2].astype(fdt)
            zf = jnp.where(zero, fdt(0), fdt(1))
        if accurate:
            # --dtype df64 draw chain: exact-primitive f32 replacements for
            # the stock transcendentals (ops/accurate.py), consuming the
            # full 64-bit draw via split hi/lo uniforms.
            from . import accurate as acc

            R_hi, R_lo, T_hi, T_lo = pcg_device.uniform_pair_split_from_affine(
                plane, m, c
            )
            Pk_b = (
                jnp.broadcast_to(Pk, R_hi.shape) if pk_eff is not None else Pk
            )
            if cfg.fixed_power:
                amp = jnp.sqrt(Pk_b)
            else:
                amp = jnp.sqrt(-Pk_b * acc.log_uniform(R_hi, R_lo))
            cosv, sinv = acc.sincos_2pi(T_hi, T_lo)
            D_re = amp * cosv
            D_im = amp * sinv
            if pk_eff is None:
                zf = jnp.where(zero, fdt(0), fdt(1))
                D_re = D_re * zf
                D_im = D_im * zf
            return _finish_fields(
                D_re, D_im, cfg, tables, fdt, n2, k2, kx, ky, kz, ppd
            )
        R, T = pcg_device.uniform_pair_from_affine(plane, m, c, dtype=fdt)
        Pk_b = jnp.broadcast_to(Pk, R.shape) if pk_eff is not None else Pk
        amp = jnp.sqrt(Pk_b) if cfg.fixed_power else jnp.sqrt(-Pk_b * jnp.log(R))
        cosv, sinv = pcg_device.sincos_2pi(T, fdt)
        D_re = amp * cosv
        D_im = amp * sinv

    zf = jnp.where(zero, fdt(0), fdt(1))
    D_re = D_re * zf
    D_im = D_im * zf
    return _finish_fields(D_re, D_im, cfg, tables, fdt, n2, k2, kx, ky, kz, ppd)


def _finish_fields(D_re, D_im, cfg, tables, fdt, n2, k2, kx, ky, kz, ppd):
    """Displacement kernel / PLT projection applied to a zero-ruled D."""
    ik2 = jnp.where(n2 == 0, fdt(0), 1.0 / jnp.where(n2 == 0, fdt(1), k2))
    if cfg.qPLT:
        from .plt import eigenmode_lookup

        evec, eval_ = eigenmode_lookup(kx, ky, kz, ppd, tables.eig, dtype=fdt)
        f = (jnp.sqrt(1.0 + 24.0 * eval_ * fdt(cfg.f_cluster)) - 1.0) * fdt(0.25)
        if cfg.qPLTrescale:
            rescale = fdt(cfg.plt_rescale_base) ** (fdt(cfg.plt_target_f) - f)
        else:
            rescale = fdt(1.0)
    else:
        evec = (kx.astype(fdt), ky.astype(fdt), kz.astype(fdt))
        f = fdt(1.0)
        rescale = fdt(1.0)

    scale = rescale * fdt(cfg.fundamental) * ik2
    # F_j = evec_j * scale * (i D) -> re = -coef*D_im, im = coef*D_re
    def field(coef):
        c = coef * scale
        return (-c * D_im, c * D_re)

    return (
        (D_re, D_im),
        field(evec[0]),
        field(evec[1]),
        field(evec[2]),
        f,
    )


def _phi_of_D(D, n2_args, tables, dtype):
    """phi = D / M (gen_phi pass); zero where M undefined (origin)."""
    kx, ky, kz = n2_args
    n2 = (kx * kx + ky * ky + kz * kz).astype(jnp.int32)
    M = tables.M_n2[n2].astype(dtype)
    invM = jnp.where(n2 == 0, dtype(0), 1.0 / jnp.where(n2 == 0, dtype(1), M))
    return (D[0] * invM, D[1] * invM)


def _pack(Dp, Fp):
    """(D + iF): returns (re, im)."""
    return (Dp[0] - Fp[1], Dp[1] + Fp[0])


def synthesize_slab_pair_identity(
    y0, ny, cfg: SynthConfig, tables: SynthTables, dtype=jnp.float32,
):
    """Identity fast path of synthesize_pair for y-slabs inside [0, half).

    Valid only when ``y0 + ny <= ppd // 2``: mirror-half rows need the
    wrapped ky, the reflected RNG planes and the conjugation that only
    synthesize_pair applies (synthesize_slab_pair chooses).

    The out-of-core slab kernels always synthesize rows
    y in [y0, y0 + ny) of the GENERATED half, for which hermitian_source
    is the identity everywhere except the in-plane mirror half of the
    ky = 0 plane.  The generic elementwise form cannot know that and
    gathers every mode's jump-table limbs (8 (Z, X)-table gathers at
    slab size).  Here the limb
    tables broadcast whole -- zero gathers except the 1-D n^2 -> P(k)
    lookup -- and the ky = 0 plane fixup is applied to the slab's first
    row iff y0 == 0: the conjugate-reflect of each FINAL field component
    (incl. the PLT f products), which reads the already-computed source
    value, so no symmetry assumption enters and the result is
    bit-identical to the hermitian_source path (tests/test_outofcore,
    test_modes_real).  Ref: the reference LoadPlane plane-0 rule
    (zeldovich.cpp:485-503).
    """
    from jax import lax

    ppd, half = cfg.ppd, cfg.ppd // 2
    fdt = dtype
    y = (jnp.asarray(y0) + jnp.arange(ny))[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]
    ky = y
    kz = jnp.where(z > half, z - ppd, z)
    kx = jnp.where(x > half, x - ppd, x)
    n2 = (kx * kx + ky * ky + kz * kz).astype(jnp.int32)
    k2 = n2.astype(fdt) * fdt(cfg.fundamental) ** 2
    zero = zero_rules(kx, ky, kz, n2, cfg)
    zf = jnp.where(zero, fdt(0), fdt(1))

    Pk = tables.pk_n2[n2].astype(fdt)
    planes_s = tuple(
        lax.dynamic_slice_in_dim(jnp.asarray(p), y0, ny)
        for p in tables.planes
    )
    plane_b = tuple(p[:, None, None] for p in planes_s)
    if tables.mzx is not None:
        m = tuple(a[None, :, :] for a in tables.mzx)
        c = tuple(a[None, :, :] for a in tables.czx)
    else:
        # ppd > 4096 (no precompose): mz limbs are (n, 1), mx (1, n)
        mzx, czx = pcg_device.compose_affine(
            tables.mz, tables.cz, tables.mx, tables.cx
        )
        m = tuple(a[None] for a in mzx)
        c = tuple(a[None] for a in czx)
    R, T = pcg_device.uniform_pair_from_affine(plane_b, m, c, dtype=fdt)
    Pk_b = jnp.broadcast_to(Pk, R.shape)
    amp = (
        jnp.sqrt(Pk_b) if cfg.fixed_power
        else jnp.sqrt(-Pk_b * jnp.log(R))
    )
    cosv, sinv = pcg_device.sincos_2pi(T, fdt)
    D_re = amp * cosv * zf
    D_im = amp * sinv * zf
    D, F, G, H, f = _finish_fields(
        D_re, D_im, cfg, tables, fdt, n2, k2, kx, ky, kz, ppd
    )

    # ky = 0 in-plane fixup, applied iff this slab contains row 0.
    # Matches the hermitian_source path byte-for-byte: mirror entries
    # take conj(source) = conjugate-reflect of the computed row; the
    # origin is zeroed by multiply (sign-of-zero-identical to live=0).
    z2 = jnp.arange(ppd)[:, None]
    x2 = jnp.arange(ppd)[None, :]
    fixm = (z2 > half) | ((z2 == 0) & (x2 > half))
    orig = (z2 == 0) & (x2 == 0)
    live0 = jnp.where(orig, fdt(0), fdt(1))
    take = jnp.asarray(y0) == 0

    def fix(w):
        re, im = w
        p_re, p_im = re[0], im[0]
        f_re = jnp.where(fixm, _reflect_zx(p_re), p_re) * live0
        f_im = jnp.where(fixm, -_reflect_zx(p_im), p_im) * live0
        return (
            re.at[0].set(jnp.where(take, f_re, p_re)),
            im.at[0].set(jnp.where(take, f_im, p_im)),
        )

    if cfg.just_density:
        return jnp.stack(fix(D))[None]

    A = _pack(fix(D), fix(F))
    B = _pack(fix(G), fix(H))
    if not cfg.qPLT:
        return jnp.stack([jnp.stack(A), jnp.stack(B)])
    Ff = (F[0] * f, F[1] * f)
    Gf = (G[0] * f, G[1] * f)
    Hf = (H[0] * f, H[1] * f)
    zero2 = (jnp.zeros_like(D[0]), jnp.zeros_like(D[1]))
    A2 = _pack(fix(zero2), fix(Ff))
    B2 = _pack(fix(Gf), fix(Hf))
    return jnp.stack(
        [jnp.stack(A), jnp.stack(B), jnp.stack(A2), jnp.stack(B2)]
    )


def synthesize_pair(
    y,
    z,
    x,
    cfg: SynthConfig,
    tables: SynthTables,
    dtype=jnp.float32,
    gen_phi: bool = False,
    phi_pair=None,
    accurate: bool = False,
):
    """Elementwise complex-free synthesis at output indices (shardable).

    Twin of modes.synthesize: mirror-half entries re-derive their source
    mode locally and conjugate (negate im) -- zero communication.

    phi_pair: (phi_same, phi_refl) tuples of (re, im) local blocks for the
    f_NL input pass (values at (y,z,x) and at the reflected index).
    ``accurate`` selects the exact-primitive f32 draw chain (the df64
    parity mode).  Returns (narray, 2, *shape).
    """
    ppd = cfg.ppd
    half = ppd // 2
    y, z, x = jnp.broadcast_arrays(jnp.asarray(y), jnp.asarray(z), jnp.asarray(x))
    sy, sz, sx, mirror, hard_zero = hermitian_source(y, z, x, ppd)

    phi_val = None
    if phi_pair is not None and not gen_phi:
        (same_re, same_im), (refl_re, refl_im) = phi_pair
        phi_val = (
            jnp.where(mirror, refl_re, same_re),
            jnp.where(mirror, refl_im, same_im),
        )

    D, F, G, H, f = _raw_fields_pair(
        sy, sz, sx, cfg, tables, dtype, phi_pair_val=phi_val,
        accurate=accurate,
    )

    sign = jnp.where(mirror, dtype(-1), dtype(1))  # conj = negate im
    live = jnp.where(hard_zero, dtype(0), dtype(1))

    def C(w):
        return (w[0] * live, w[1] * sign * live)

    if gen_phi:
        kz = jnp.where(sz > half, sz - ppd, sz)
        kx = jnp.where(sx > half, sx - ppd, sx)
        pr, pi = C(_phi_of_D(D, (kx, sy, kz), tables, dtype))
        return jnp.stack([pr, pi])[None]

    if cfg.just_density:
        return jnp.stack(C(D))[None]

    A = _pack(C(D), C(F))
    B = _pack(C(G), C(H))
    if not cfg.qPLT:
        return jnp.stack([jnp.stack(A), jnp.stack(B)])
    zero2 = (jnp.zeros_like(D[0]), jnp.zeros_like(D[1]))
    Ff = (F[0] * f, F[1] * f)
    Gf = (G[0] * f, G[1] * f)
    Hf = (H[0] * f, H[1] * f)
    A2 = _pack(C(zero2), C(Ff))
    B2 = _pack(C(Gf), C(Hf))
    return jnp.stack([jnp.stack(A), jnp.stack(B), jnp.stack(A2), jnp.stack(B2)])


def synthesize_slab_pair(y0, ny, cfg: SynthConfig, tables: SynthTables,
                         dtype=jnp.float32):
    """Rows y in [y0, y0 + ny) of the full pair grid: (narray, 2, ny, Z, X).

    Slabs inside the generated half take the gather-free identity path;
    any slab that reaches y >= ppd // 2 takes synthesize_pair.  ``y0`` may
    be traced: both forms compile into one program behind a cond.
    """
    ppd = cfg.ppd

    def generic(y0):
        y = (y0 + jnp.arange(ny))[:, None, None]
        z = jnp.arange(ppd)[None, :, None]
        x = jnp.arange(ppd)[None, None, :]
        return synthesize_pair(y, z, x, cfg, tables, dtype=dtype)

    def identity(y0):
        return synthesize_slab_pair_identity(y0, ny, cfg, tables, dtype=dtype)

    return jax.lax.cond(y0 + ny <= ppd // 2, identity, generic, y0)


def _fix_plane0_pair(re, im, half):
    """Self-conjugate fixup of a raw field's y=0 plane + zero-plane append.

    Input (.., half, Z, X) raw planes for y in [0, half); output
    (.., half+1, Z, X): plane 0 with the in-plane Hermitian fixup
    (zeldovich.cpp:485-503), planes 1..half-1 raw, plane half zero
    (the y-Nyquist rule).  This is the half-SPECTRUM form: the mirror
    planes are never materialized -- the c2r y-transform (ops/mmfft)
    consumes the conjugate symmetry analytically.
    """
    ppd = re.shape[-1]
    z = jnp.arange(ppd)[:, None]
    x = jnp.arange(ppd)[None, :]
    fix = (z > half) | ((z == 0) & (x > half))
    origin = (z == 0) & (x == 0)

    def one(a, flip_sign):
        p0 = a[..., 0, :, :]
        p0 = jnp.where(fix, flip_sign * _reflect_zx(p0), p0)
        p0 = jnp.where(origin, jnp.zeros_like(p0), p0)
        nyq = jnp.zeros_like(p0)[..., None, :, :]
        return jnp.concatenate(
            [p0[..., None, :, :], a[..., 1:, :, :], nyq], axis=-3
        )

    return one(re, 1.0), one(im, -1.0)


def _pack_pm(Dp, Fp):
    """Both packings of two real fields: (2, 2, ...) = (+/-, re/im).

    sp = D + iF, sm = D - iF; sp (+) and sm (-) on the half-spectrum
    together determine the full Hermitian grid (the mirror plane of
    D + iF is conj(D - iF) at the reflected index).
    """
    sp = jnp.stack([Dp[0] - Fp[1], Dp[1] + Fp[0]])
    sm = jnp.stack([Dp[0] + Fp[1], Dp[1] - Fp[0]])
    return jnp.stack([sp, sm])


def _pack_fix_pad(Dp, Fp, half):
    """Fused packing for the half-spectrum form: (2, 2, half+1, Z, X).

    Bit-equal to ``_pack_pm(fix(D), fix(F))`` (gathers commute with adds)
    but restructured to move fewer bytes: pack first (elementwise, fuses
    with the field math), fix ONLY the ky=0 plane via one
    dynamic-update-slice per component -- the conjugate-reflected plane of
    packing sp is exactly reflect(conj(sm)) and vice versa -- and append
    the zero Nyquist row with a single pad of the stacked result, instead
    of a concatenate per field.
    """
    sp_re = Dp[0] - Fp[1]
    sp_im = Dp[1] + Fp[0]
    sm_re = Dp[0] + Fp[1]
    sm_im = Dp[1] - Fp[0]
    ppd = sp_re.shape[-1]
    z = jnp.arange(ppd)[:, None]
    x = jnp.arange(ppd)[None, :]
    fixm = (z > half) | ((z == 0) & (x > half))
    orig = (z == 0) & (x == 0)

    def fixed0(a_re, a_im, o_re, o_im):
        p_re = jnp.where(
            fixm, _reflect_zx(o_re[..., 0, :, :]), a_re[..., 0, :, :]
        )
        p_im = jnp.where(
            fixm, -_reflect_zx(o_im[..., 0, :, :]), a_im[..., 0, :, :]
        )
        zero = jnp.zeros((), a_re.dtype)
        return jnp.where(orig, zero, p_re), jnp.where(orig, zero, p_im)

    spf = fixed0(sp_re, sp_im, sm_re, sm_im)
    smf = fixed0(sm_re, sm_im, sp_re, sp_im)
    sp = jnp.stack(
        [sp_re.at[..., 0, :, :].set(spf[0]),
         sp_im.at[..., 0, :, :].set(spf[1])]
    )
    sm = jnp.stack(
        [sm_re.at[..., 0, :, :].set(smf[0]),
         sm_im.at[..., 0, :, :].set(smf[1])]
    )
    out = jnp.stack([sp, sm])  # (2, 2, ..., half, Z, X)
    pad = [(0, 0)] * out.ndim
    pad[-3] = (0, 1)  # the zero y-Nyquist row
    return jnp.pad(out, pad)


@partial(jax.jit, static_argnames=("cfg", "dtype", "accurate"))
def synthesize_half_pair(
    cfg: SynthConfig,
    tables: SynthTables,
    dtype=jnp.float32,
    pk_eff=None,
    accurate: bool = False,
):
    """Half-SPECTRUM complex-free synthesis: (narray, 2, 2, half+1, Z, X).

    Axes: (packed array, +/- packing, re/im, ky in [0, half], Z, X).
    Never materializes the Hermitian mirror half: downstream, the z/x
    transforms run on (half+1)/ppd of the data and the y-axis transform is
    a c2r matmul (mmfft.c2r_y_pair) -- ~2.2x fewer FFT flops and half the
    k-space memory vs the full-grid path, with bit-equal output.

    Requires an exactly Hermitian spectrum, which every non-f_NL mode
    combination satisfies (the Nyquist zero rules guarantee it); the f_NL
    input pass does not (see pipeline.kspace_half_pair).
    """
    ppd = cfg.ppd
    half = ppd // 2
    y = jnp.arange(half)[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]

    D, F, G, H, f = _raw_fields_pair(
        y, z, x, cfg, tables, dtype, pk_eff=pk_eff, accurate=accurate,
    )

    if cfg.just_density:
        zero2 = (jnp.zeros_like(D[0]), jnp.zeros_like(D[1]))
        return _pack_fix_pad(D, zero2, half)[None]

    A = _pack_fix_pad(D, F, half)
    B = _pack_fix_pad(G, H, half)
    if not cfg.qPLT:
        return jnp.stack([A, B])
    Ff = (F[0] * f, F[1] * f)
    Gf = (G[0] * f, G[1] * f)
    Hf = (H[0] * f, H[1] * f)
    zero2 = (jnp.zeros_like(D[0]), jnp.zeros_like(D[1]))
    A2 = _pack_fix_pad(zero2, Ff, half)
    B2 = _pack_fix_pad(Gf, Hf, half)
    return jnp.stack([A, B, A2, B2])


def pk_effective_half_src(cfg: SynthConfig, tables: SynthTables, dtype):
    """Source-resolved amplitude field for the sharded half-spectrum kernel.

    (half+1, Z, X) pk_effective evaluated at hermitian_source indices: the
    ky=0 plane's in-plane mirrors read their SOURCE's zero rules (qonemode
    is not reflection-symmetric), and the hard zeros (y-Nyquist plane,
    origin) are folded in.  Setup work, like pk_effective.
    """
    ppd, half = cfg.ppd, cfg.ppd // 2
    fdt = dtype
    y = jnp.arange(half + 1)[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]
    sy, sz, sx, _, hard = hermitian_source(y, z, x, ppd)
    ky = sy
    kz = jnp.where(sz > half, sz - ppd, sz)
    kx = jnp.where(sx > half, sx - ppd, sx)
    n2 = (kx * kx + ky * ky + kz * kz).astype(jnp.int32)
    k2 = n2.astype(fdt) * fdt(cfg.fundamental) ** 2
    zero = zero_rules(kx, ky, kz, n2, cfg) | hard
    pk = tables.pk_n2[n2].astype(fdt)
    return jnp.where(zero, fdt(0), pk)


def synthesize_half_pair_at(
    y, z, x, cfg: SynthConfig, tables: SynthTables, dtype=jnp.float32,
    pk_eff=None, accurate: bool = False,
):
    """Elementwise half-SPECTRUM synthesis at output indices (shardable).

    Twin of synthesize_half_pair for arbitrary index blocks with
    y in [0, half]: the ky=0 in-plane mirror and the hard zeros come from
    hermitian_source instead of the full-plane fixup, so any (y, z, x)
    box -- an x-column shard of a device mesh -- generates locally.
    pk_eff, if given, must be the SOURCE-RESOLVED field
    (pk_effective_half_src) sliced to the same block.
    Returns (narray, 2, 2, *shape) = (array, +/- packing, re/im, ...).
    """
    ppd = cfg.ppd
    half = ppd // 2
    y, z, x = jnp.broadcast_arrays(jnp.asarray(y), jnp.asarray(z), jnp.asarray(x))
    sy, sz, sx, mirror, hard_zero = hermitian_source(y, z, x, ppd)

    D, F, G, H, f = _raw_fields_pair(
        sy, sz, sx, cfg, tables, dtype, pk_eff=pk_eff, accurate=accurate,
    )

    sign = jnp.where(mirror, dtype(-1), dtype(1))  # conj = negate im
    live = jnp.where(hard_zero, dtype(0), dtype(1))

    def C(w):
        return (w[0] * live, w[1] * sign * live)

    if cfg.just_density:
        zD = C(D)
        zero2 = (jnp.zeros_like(zD[0]), zD[0] * 0)
        return _pack_pm(zD, zero2)[None]

    A = _pack_pm(C(D), C(F))
    B = _pack_pm(C(G), C(H))
    if not cfg.qPLT:
        return jnp.stack([A, B])
    Ff = (F[0] * f, F[1] * f)
    Gf = (G[0] * f, G[1] * f)
    Hf = (H[0] * f, H[1] * f)
    zero2 = (jnp.zeros_like(D[0]), jnp.zeros_like(D[1]))
    A2 = _pack_pm(C(zero2), C(Ff))
    B2 = _pack_pm(C(Gf), C(Hf))
    return jnp.stack([A, B, A2, B2])


def _assemble_pair(re, im, half):
    """Full-space (re, im) from half-space raw fields (conj = negate im)."""
    ppd = re.shape[-1]
    z = jnp.arange(ppd)[:, None]
    x = jnp.arange(ppd)[None, :]
    fix = (z > half) | ((z == 0) & (x > half))
    origin = (z == 0) & (x == 0)

    def one(a, flip_sign):
        p0 = a[..., 0, :, :]
        fixed = jnp.where(fix, flip_sign * _reflect_zx(p0), p0)
        fixed = jnp.where(origin, jnp.zeros_like(fixed), fixed)
        top = jnp.concatenate([fixed[..., None, :, :], a[..., 1:, :, :]], axis=-3)
        nyq = jnp.zeros_like(fixed)[..., None, :, :]
        bottom = flip_sign * _reflect_zx(jnp.flip(a[..., 1:, :, :], axis=-3))
        return jnp.concatenate([top, nyq, bottom], axis=-3)

    return one(re, 1.0), one(im, -1.0)


@partial(jax.jit, static_argnames=("cfg", "dtype", "gen_phi"))
def synthesize_full_fast_pair(
    cfg: SynthConfig,
    tables: SynthTables,
    dtype=jnp.float32,
    gen_phi: bool = False,
    phi_pair=None,
    pk_eff=None,
):
    """Full k-grid as real pairs via half-space generation + reflection.

    Returns (narray, 2, ppd, ppd, ppd).
    phi_pair: (2, ppd, ppd, ppd) phi(k) pair for the f_NL input pass.
    """
    ppd = cfg.ppd
    half = ppd // 2
    y = jnp.arange(half)[:, None, None]
    z = jnp.arange(ppd)[None, :, None]
    x = jnp.arange(ppd)[None, None, :]

    phi_val = None
    if phi_pair is not None and not gen_phi:
        phi_val = (phi_pair[0, :half], phi_pair[1, :half])

    D, F, G, H, f = _raw_fields_pair(
        y, z, x, cfg, tables, dtype, phi_pair_val=phi_val, pk_eff=pk_eff,
    )

    def asm(w):
        return _assemble_pair(w[0], w[1], half)

    if gen_phi:
        kz = jnp.where(z > half, z - ppd, z)
        kx = jnp.where(x > half, x - ppd, x)
        pr, pi = asm(_phi_of_D(D, (kx, y, kz), tables, dtype))
        return jnp.stack([pr, pi])[None]

    if cfg.just_density:
        return jnp.stack(asm(D))[None]

    def pack_full(Dp, Fp):
        dr, di = asm(Dp)
        fr, fi = asm(Fp)
        return jnp.stack([dr - fi, di + fr])

    A = pack_full(D, F)
    B = pack_full(G, H)
    if not cfg.qPLT:
        return jnp.stack([A, B])
    Ff = (F[0] * f, F[1] * f)
    Gf = (G[0] * f, G[1] * f)
    Hf = (H[0] * f, H[1] * f)
    zero2 = (jnp.zeros_like(D[0]), jnp.zeros_like(D[1]))
    A2 = pack_full(zero2, Ff)
    B2 = pack_full(Gf, Hf)
    return jnp.stack([A, B, A2, B2])
