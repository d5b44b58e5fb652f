"""Matmul FFT: complex transforms as real matmuls (no complex dtypes).

The real-pair route (``--pair``, and every ``--dtype df64`` run): each
1-D transform is a dense DFT matmul, or a four-step (Bailey) split
N = N1*N2 into two smaller dense matmuls plus an elementwise twiddle, and
every complex array is carried as a stacked (re, im) pair with the complex
arithmetic written out in real math.  It does ~2 sqrt(N)/log2 N more flops
than Cooley-Tukey; the default route is ``jnp.fft`` (see utils/backend).

Convention: ``sign=+1`` matches the reference's unnormalized inverse
(FFTW backward), ``sign=-1`` the forward transform; no 1/N anywhere.

All functions take/return real arrays with a leading length-2 (re, im)
axis immediately before the batch/data axes: shape (2, ...).
"""

from __future__ import annotations

import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def precision_name() -> str:
    """The ZT_FFT_PRECISION knob: "highest" (default), "high" or "default".

    float32 dots run at HIGHEST unless asked otherwise, so no product
    silently drops to TF32 on a GPU.
    """
    return os.environ.get("ZT_FFT_PRECISION", "").lower() or "highest"


def _resolve_precision(p):
    """None -> the ZT_FFT_PRECISION knob (see precision_name).

    The df64 mode is untouched by this knob: its transforms run on the
    int8-limb ozaki matmuls.  Explicit precision arguments are passed
    through untouched.
    """
    if p is not None:
        return p
    return {
        "default": lax.Precision.DEFAULT,
        "high": lax.Precision.HIGH,
        "highest": lax.Precision.HIGHEST,
    }[precision_name()]


#: Below this length a single dense N x N DFT matmul is used instead of the
#: four-step split.  The dense form does N/(2 sqrt N) more flops but keeps
#: the contraction dimension large enough for an efficient matmul.
DENSE_MAX = 1024


def _factor(n: int) -> tuple[int, int]:
    """Balanced factorization n = n1 * n2 with n1 <= n2."""
    n1 = int(math.isqrt(n))
    while n % n1:
        n1 -= 1
    return n1, n // n1


def _dft_mats(n: int, sign: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """cos / sin matrices of the length-n DFT: W[j,k] = exp(sign*2pi i jk/n)."""
    j = np.arange(n)
    ang = (sign * 2.0 * np.pi / n) * np.outer(j, j)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def _twiddle(n1: int, n2: int, sign: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """T[k1, n2] = exp(sign*2pi i k1 n2 / (n1 n2))."""
    ang = (sign * 2.0 * np.pi / (n1 * n2)) * np.outer(np.arange(n1), np.arange(n2))
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def _cmatmul(ar, ai, br, bi, precision):
    """(ar + i ai) @ (br + i bi) -> (re, im) with 3 real matmuls (Karatsuba)."""
    dot = partial(jnp.matmul, precision=precision)
    k1 = dot(ar, br + bi)
    k2 = dot(ai + ar, bi)
    k3 = dot(ai - ar, br)
    # re = ar@br - ai@bi = k1 - k2;  im = ar@bi + ai@br = k1 + k3
    return k1 - k2, k1 + k3


# -- f64 transforms from int8 matmuls (ops/ozaki.py) -----------------------

from functools import lru_cache

from . import ozaki


@lru_cache(maxsize=None)
def _dft_sliced(n: int, sign: int, transposed: bool = False):
    """Host-precomputed int8 limb slices of the length-n DFT matrices.

    Karatsuba needs (Wr+Wi, Wi, Wr); ``transposed`` serves the four-step
    matrix-on-the-left contraction as data @ W^T.
    """
    wr, wi = _dft_mats(n, sign, np.float64)
    if transposed:
        wr, wi = wr.T.copy(), wi.T.copy()  # symmetric, but keep it general
    return (
        ozaki.slice_static(wr + wi),
        ozaki.slice_static(wi),
        ozaki.slice_static(wr),
    )


def _cmatmul_ozaki(ar, ai, sliced):
    """Karatsuba complex matmul with f64-grade int8 (Ozaki) real matmuls."""
    s_rpi, s_i, s_r = sliced
    k1 = ozaki.omatmul(ar, s_rpi)
    k2 = ozaki.omatmul(ai + ar, s_i)
    k3 = ozaki.omatmul(ai - ar, s_r)
    return k1 - k2, k1 + k3


def _cfft_last_ozaki(re, im, sign: int):
    """float64 DFT along the last axis via exact-accumulation int8 matmuls.

    Mirrors cfft_last's dense/four-step split; the twiddle and recombine
    stay f64 elementwise (cheap even when emulated).
    """
    n = re.shape[-1]
    n1, n2 = _factor(n)
    if n1 == 1 or n <= DENSE_MAX:
        return _cmatmul_ozaki(re, im, _dft_sliced(n, sign))

    shape = re.shape[:-1]
    ar = re.reshape(*shape, n1, n2)
    ai = im.reshape(*shape, n1, n2)
    # step 1 (W @ A over n1) as A^T @ W^T
    art, ait = jnp.swapaxes(ar, -1, -2), jnp.swapaxes(ai, -1, -2)
    crt, cit = _cmatmul_ozaki(art, ait, _dft_sliced(n1, sign, transposed=True))
    cr, ci = jnp.swapaxes(crt, -1, -2), jnp.swapaxes(cit, -1, -2)
    tr, ti = (jnp.asarray(m) for m in _twiddle(n1, n2, sign, np.float64))
    dr = cr * tr - ci * ti
    di = cr * ti + ci * tr
    er, ei = _cmatmul_ozaki(dr, di, _dft_sliced(n2, sign))
    er = jnp.swapaxes(er, -1, -2).reshape(*shape, n)
    ei = jnp.swapaxes(ei, -1, -2).reshape(*shape, n)
    return er, ei


def cfft_last(re, im, sign: int, precision=None):
    """Complex DFT along the last axis of (re, im) real arrays.

    re, im: (..., N).  Returns (re, im) transformed, unnormalized.
    """
    n = re.shape[-1]
    dtype = re.dtype
    if ozaki.use_ozaki(dtype):
        return _cfft_last_ozaki(re, im, sign)
    precision = _resolve_precision(precision)
    n1, n2 = _factor(n)
    if n1 == 1 or n <= DENSE_MAX:
        # prime or moderate size: one dense DFT matmul (x @ W^T, W[k,j])
        wr, wi = (jnp.asarray(m) for m in _dft_mats(n, sign, dtype))
        return _cmatmul(re, im, wr, wi, precision)

    # four-step: x[n1*N2 + n2] viewed as A[n1][n2]
    shape = re.shape[:-1]
    ar = re.reshape(*shape, n1, n2)
    ai = im.reshape(*shape, n1, n2)

    # step 1: DFT over n1 (columns): C[k1][n2] = sum_n1 W_N1^{n1 k1} A[n1][n2]
    w1r, w1i = (jnp.asarray(m) for m in _dft_mats(n1, sign, dtype))
    # contract A's n1 axis with the DFT matrix: (k1, n1) @ (..., n1, n2)
    cr, ci = _cmatmul(
        w1r, w1i, ar, ai, precision
    )  # matmul broadcasting: (n1,n1) @ (...,n1,n2) -> (...,n1->k1, n2)

    # step 2: twiddle T[k1][n2]
    tr, ti = (jnp.asarray(m) for m in _twiddle(n1, n2, sign, dtype))
    dr = cr * tr - ci * ti
    di = cr * ti + ci * tr

    # step 3: DFT over n2 (rows): E[k1][k2] = sum_n2 D[k1][n2] W_N2^{n2 k2}
    w2r, w2i = (jnp.asarray(m) for m in _dft_mats(n2, sign, dtype))
    er, ei = _cmatmul(dr, di, w2r, w2i, precision)

    # output order: X[k1 + N1*k2] => [k2][k1] row-major
    er = jnp.swapaxes(er, -1, -2).reshape(*shape, n)
    ei = jnp.swapaxes(ei, -1, -2).reshape(*shape, n)
    return er, ei


# -- two-float (df64) transforms: f32 pairs + int8 matmuls, no f64 ---------
# Each real component is an (hi, lo) f32 pair; matmuls go through
# ozaki.omatmul_pair and elementwise combines through error-free two-sums.
# This is the --dtype df64 transform path: ~2^-40-grade accuracy from f32
# and int8 arithmetic only.


def _padd(x, y):
    return ozaki.pair_add(x[0], x[1], y[0], y[1])


def _psub(x, y):
    return ozaki.pair_add(x[0], x[1], -y[0], -y[1])


def _cmatmul_df64(arp, aip, sliced):
    """Karatsuba complex matmul on f32 pairs (3 pair-ozaki matmuls)."""
    s_rpi, s_i, s_r = sliced
    k1 = ozaki.omatmul_pair(arp, s_rpi)
    k2 = ozaki.omatmul_pair(_padd(aip, arp), s_i)
    k3 = ozaki.omatmul_pair(_psub(aip, arp), s_r)
    return _psub(k1, k2), _padd(k1, k3)


@lru_cache(maxsize=None)
def _twiddle_pair(n1: int, n2: int, sign: int):
    """Four-step twiddles as (hi, lo) f32 pairs (host-split from f64)."""
    tr, ti = _twiddle(n1, n2, sign, np.float64)

    def split(v):
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        return hi, lo

    return split(tr), split(ti)


def _cfft_last_df64(rep, imp, sign: int):
    """Pair DFT along the last axis: dense matmul or four-step split.

    The four-step form (n > DENSE_MAX) matches _cfft_last_ozaki's
    structure with the twiddle rotation done in error-free pair
    arithmetic (ozaki.pair_mul) so the elementwise step stays at the
    ~2^-40 accuracy of the int8 limb matmuls.
    """
    n = rep[0].shape[-1]
    n1, n2 = _factor(n)
    if n1 == 1 or n <= DENSE_MAX:
        return _cmatmul_df64(rep, imp, _dft_sliced(n, sign))

    shape = rep[0].shape[:-1]
    resh = lambda p: tuple(c.reshape(*shape, n1, n2) for c in p)
    swap = lambda p: tuple(jnp.swapaxes(c, -1, -2) for c in p)
    arp, aip = resh(rep), resh(imp)
    # step 1 (W @ A over n1) as A^T @ W^T
    crt, cit = _cmatmul_df64(
        swap(arp), swap(aip), _dft_sliced(n1, sign, transposed=True)
    )
    crp, cip = swap(crt), swap(cit)
    (trh, trl), (tih, til) = jax.tree.map(
        jnp.asarray, _twiddle_pair(n1, n2, sign)
    )
    # d = c * t (complex pair rotation)
    rr = ozaki.pair_mul(crp[0], crp[1], trh, trl)
    ii = ozaki.pair_mul(cip[0], cip[1], tih, til)
    ri = ozaki.pair_mul(crp[0], crp[1], tih, til)
    ir = ozaki.pair_mul(cip[0], cip[1], trh, trl)
    drp = _psub(rr, ii)
    dip = _padd(ri, ir)
    erp, eip = _cmatmul_df64(drp, dip, _dft_sliced(n2, sign))
    fin = lambda p: tuple(
        jnp.swapaxes(c, -1, -2).reshape(*shape, n) for c in p
    )
    return fin(erp), fin(eip)


def _cfft_axis_df64(rep, imp, axis: int, sign: int):
    rep = tuple(jnp.moveaxis(c, axis, -1) for c in rep)
    imp = tuple(jnp.moveaxis(c, axis, -1) for c in imp)
    rep, imp = _cfft_last_df64(rep, imp, sign)
    back = lambda p: tuple(jnp.moveaxis(c, -1, axis) for c in p)
    return back(rep), back(imp)


def _c2r_y_df64(rep, imp):
    """Pair c2r transform along the ky axis (the df64 twin of c2r_y_pair).

    rep, imp: (hi, lo) pairs with component shape (.., 2pm, h+1, Z, X).
    Returns (out_re, out_im) pairs of shape (.., Y, Z, X).  Above
    DENSE_MAX the full y-spectrum is assembled (exact concatenation of
    pair components) and one four-step pair transform inverts it.
    """
    n = 2 * (rep[0].shape[-3] - 1)  # ky axis sets the length, not Z

    def pm(p, k):  # select +/- packing k of a pair
        return (p[0][..., k, :, :, :], p[1][..., k, :, :, :])

    spr, smr = pm(rep, 0), pm(rep, 1)
    spi, smi = pm(imp, 0), pm(imp, 1)

    if n > DENSE_MAX:
        # assembled form (see _c2r_y_pair_assembled): rows k > h of the
        # packed field D + iF equal conj(sm[n-k]); component-wise concat
        # of the pairs is exact
        def cat(top, mid, neg):
            m = tuple(c[..., 1:-1, :, :][..., ::-1, :, :] for c in mid)
            if neg:
                m = tuple(-c for c in m)
            return tuple(
                jnp.concatenate([t, x], axis=-3) for t, x in zip(top, m)
            )

        fre = cat(spr, smr, neg=False)
        fim = cat(spi, smi, neg=True)
        fre, fim = _cfft_axis_df64(fre, fim, -3, +1)
        return fre, fim

    CT_s, ST_s = _c2r_sliced(n)
    twoDr, twoDi = _padd(spr, smr), _padd(spi, smi)
    twoFr, twoFi = _psub(spi, smi), _psub(smr, spr)

    def mm(M_sliced, a):
        moved = tuple(jnp.moveaxis(c, -3, -1) for c in a)
        out = ozaki.omatmul_pair(moved, M_sliced)
        return tuple(jnp.moveaxis(c, -1, -3) for c in out)

    out_re = _padd(mm(CT_s, twoDr), mm(ST_s, twoDi))
    out_im = _padd(mm(CT_s, twoFr), mm(ST_s, twoFi))
    return out_re, out_im


def _pair_to_f64(p):
    return p[0].astype(jnp.float64) + p[1].astype(jnp.float64)


def ifft3_half_df64(spm):
    """Two-float inverse half-spectrum transform (the --dtype df64 path).

    spm: (narray, 2, 2, h+1, Z, X) float32 (exact synthesis values; the
    low components start at zero).  Returns (narray, 2, Y, Z, X) float64
    assembled from the final (hi, lo) pairs -- the only f64 ops are the
    output conversion.
    """
    z = jnp.zeros_like(spm[..., 0, :, :, :])
    rep = (spm[..., 0, :, :, :], z)  # (narray, 2pm, h+1, Z, X) pairs
    imp = (spm[..., 1, :, :, :], z)
    for ax in (-2, -1):
        rep, imp = _cfft_axis_df64(rep, imp, ax, +1)
    out_re, out_im = _c2r_y_df64(rep, imp)
    return jnp.stack([_pair_to_f64(out_re), _pair_to_f64(out_im)], axis=-4)


def _cmatmul_axis(ar, ai, wr, wi, axis: int, precision):
    """Complex DFT contraction over data axis ``axis`` with no transposes.

    Gauss 3-multiplication form with both matrix-side combines on the
    (tiny) DFT matrix; the single data-side combine (ar + ai) is the only
    extra full-array pass.  einsum contracts the target axis in place:
    the moveaxis round trip of the last-axis form costs 4 extra
    full-array passes over device memory per axis.
    """
    nd = ar.ndim
    ax = axis % nd
    tail = "abcdefg"[: nd - 1 - ax]  # axes minor of the contraction
    sub = f"kj,...j{tail}->...k{tail}"
    es = partial(jnp.einsum, sub, precision=precision)
    k1 = es(wr, ar + ai)
    k2 = es(wi - wr, ar)
    k3 = es(wr + wi, ai)
    # re = wr@ar - wi@ai;  im = wr@ai + wi@ar  (Gauss: k1 -/+ k3/k2)
    return k1 - k3, k1 + k2


def cfft_axis(re, im, axis: int, sign: int, precision=None):
    """Complex DFT along ``axis``.

    Dense sizes contract the axis in place (_cmatmul_axis, no layout
    copies); the last axis and four-step sizes go through cfft_last.
    """
    n = re.shape[axis]
    if (
        axis % re.ndim != re.ndim - 1
        and not ozaki.use_ozaki(re.dtype)
        and (_factor(n)[0] == 1 or n <= DENSE_MAX)
    ):
        precision = _resolve_precision(precision)
        wr, wi = (jnp.asarray(m) for m in _dft_mats(n, sign, re.dtype))
        return _cmatmul_axis(re, im, wr, wi, axis, precision)
    re = jnp.moveaxis(re, axis, -1)
    im = jnp.moveaxis(im, axis, -1)
    re, im = cfft_last(re, im, sign, precision)
    return jnp.moveaxis(re, -1, axis), jnp.moveaxis(im, -1, axis)


def cfft3(pair, sign: int, axes=(-3, -2, -1), precision=None):
    """3-D complex DFT of a stacked pair: pair shape (2, ..., Y, Z, X)."""
    re, im = pair[0], pair[1]
    for ax in axes:
        re, im = cfft_axis(re, im, ax, sign, precision)
    return jnp.stack([re, im])


def ifft3_pair(pair, axes=(-3, -2, -1), precision=None):
    """Unnormalized inverse (FFTW +1) -- the reference convention."""
    return cfft3(pair, +1, axes, precision)


# -- half-spectrum (c2r) path ---------------------------------------------

def _c2r_mats(n: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """The c2r (irfft-like, unnormalized +1) y-axis matmul matrices.

    For a Hermitian length-n spectrum g (g[n-k] = conj(g[k]), g[0] and
    g[h] real), the inverse transform is
        x[y] = g[0] + g[h] cos(pi y)
             + 2 sum_{k=1}^{h-1} (Re g[k] cos t - Im g[k] sin t),
    t = 2 pi k y / n.  Returned C, S are (n, h+1) with the 1/2 for the
    doubled +/- packing combination folded in: x = C @ (2 Re g) + S @ (2 Im g).
    """
    h = n // 2
    y = np.arange(n)[:, None]
    k = np.arange(h + 1)[None, :]
    t = 2.0 * np.pi / n * (y * k)
    C = np.cos(t)
    C[:, 0] *= 0.5
    C[:, h] *= 0.5
    S = -np.sin(t)
    S[:, 0] = 0.0
    S[:, h] = 0.0
    return C.astype(dtype), S.astype(dtype)


@lru_cache(maxsize=None)
def _c2r_sliced(n: int):
    """int8 limb slices of the TRANSPOSED c2r matrices (data @ M^T form)."""
    C, S = _c2r_mats(n, np.float64)
    return ozaki.slice_static(C.T.copy()), ozaki.slice_static(S.T.copy())


def _c2r_y_pair_assembled(spm, precision):
    """Four-step-capable c2r: assemble the full y-spectrum, one cfft.

    The dense [n, h+1] c2r matmul costs 2 n^2 real MACs per skewer; above
    DENSE_MAX the assembled form wins: the packed complex field D + iF has
    full y-spectrum rows k <= h equal to sp and rows k > h equal to
    conj(sm[n-k]) (D, F real), so one length-n complex transform -- which
    four-steps to ~3 n (n1+n2) MACs -- inverts BOTH fields.  The z/x
    half-spectrum savings are unaffected.
    """
    spr, spi = spm[..., 0, 0, :, :, :], spm[..., 0, 1, :, :, :]
    smr, smi = spm[..., 1, 0, :, :, :], spm[..., 1, 1, :, :, :]
    mid_r = smr[..., 1:-1, :, :][..., ::-1, :, :]
    mid_i = -smi[..., 1:-1, :, :][..., ::-1, :, :]
    re = jnp.concatenate([spr, mid_r], axis=-3)
    im = jnp.concatenate([spi, mid_i], axis=-3)
    re, im = cfft_axis(re, im, -3, +1, precision)
    return jnp.stack([re, im], axis=-4)


def c2r_y_pair(spm, precision=None):
    """Half-spectrum inverse transform along the ky axis (unnormalized +1).

    spm: (..., 2, 2, h+1, Z, X) = (.., +/- packing, re/im, ky, Z, X) where
    sp = D + iF and sm = D - iF for two real (3-D Hermitian) fields D, F,
    with the z and x axes ALREADY transformed to configuration space (the
    per-plane transforms commute with the y transform, and conj-reflect in
    (kz, kx) becomes plain conj under them).

    Returns (..., 2, n, Z, X): the packed x-space pair (re = D_x, im = F_x)
    -- identical to the full-grid transform of the assembled mirror grid,
    at half the z/x transform cost and no assembly pass.

    Math: sp + sm = 2 D~, sp - sm = 2 i F~; each field's y-skewer is a 1-D
    Hermitian spectrum, inverted with two real [n, h+1] matmuls.
    """
    dtype = spm.dtype
    # the transform length is set by the ky axis (h+1 spectrum rows),
    # NOT the Z extent: callers may pass Z-sliced blocks (out-of-core
    # stripes, validation probes)
    n = 2 * (spm.shape[-3] - 1)
    precision = _resolve_precision(precision)
    if n > DENSE_MAX:
        return _c2r_y_pair_assembled(spm, precision)

    spr, spi = spm[..., 0, 0, :, :, :], spm[..., 0, 1, :, :, :]
    smr, smi = spm[..., 1, 0, :, :, :], spm[..., 1, 1, :, :, :]
    twoDr, twoDi = spr + smr, spi + smi
    twoFr, twoFi = spi - smi, smr - spr  # 2F = (sp - sm)/i

    if ozaki.use_ozaki(dtype):
        CT_s, ST_s = _c2r_sliced(n)

        def mm(M_sliced, a):
            moved = jnp.moveaxis(a, -3, -1)  # (..., Z, X, k)
            out = ozaki.omatmul(moved, M_sliced)
            return jnp.moveaxis(out, -1, -3)

        out_re = mm(CT_s, twoDr) + mm(ST_s, twoDi)
        out_im = mm(CT_s, twoFr) + mm(ST_s, twoFi)
        return jnp.stack([out_re, out_im], axis=-4)

    C, S = (jnp.asarray(m) for m in _c2r_mats(n, dtype))

    def mm(M, a):
        # contract a's ky axis (-3) with M[y, k] -> (..., y, Z, X)
        return jnp.einsum("yk,...kzx->...yzx", M, a, precision=precision)

    out_re = mm(C, twoDr) + mm(S, twoDi)
    out_im = mm(C, twoFr) + mm(S, twoFi)
    return jnp.stack([out_re, out_im], axis=-4)


def ifft3_half_pair(spm, precision=None):
    """Unnormalized inverse 3-D transform of a half-spectrum pm-pair.

    spm: (narray, 2, 2, h+1, Z, X) from modes_real.synthesize_half_pair.
    Returns (narray, 2, Y, Z, X) -- the same x-space pair layout as
    ifft3_pair of the full assembled grid.
    """
    re, im = spm[..., 0, :, :, :], spm[..., 1, :, :, :]
    for ax in (-2, -1):
        re, im = cfft_axis(re, im, ax, +1, precision)
    return c2r_y_pair(jnp.stack([re, im], axis=-4), precision)


def fft3_pair(pair, axes=(-3, -2, -1), precision=None):
    """Forward (FFTW -1), unnormalized."""
    return cfft3(pair, -1, axes, precision)
