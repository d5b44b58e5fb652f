"""Correctly-rounded-grade f32 transcendentals built from exact primitives.

Stock f32 cos/sin/log lowerings may trade accuracy for speed, several ulp
above correct rounding on some backends -- enough to dominate the <1e-6
displacement-parity budget at the k-mode level.  These replacements use only exact or
correctly-rounded f32 primitives -- multiply, add/FMA, round, integer
bit-twiddles -- with classic Cody-Waite range reduction and minimax
polynomials, giving ~1-3 ulp on every backend.

Used by the ``--dtype df64`` mixed parity mode (ops/modes_real.py with
``accurate=True``): the draw chain stays f32-fast while its float error
drops to the f32 representation floor.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

F = jnp.float32


def sincos_2pi(t_hi, t_lo=None):
    """(cos, sin) of 2*pi*(t_hi + t_lo) for t in (0, 1], ~2 ulp.

    t_hi: f32 fraction of a turn; t_lo: optional f32 low part (|t_lo| well
    below ulp(t_hi)).  Quadrant reduction is EXACT: q = round(4 t) is a
    small integer, and r = t - q/4 is Sterbenz-exact in f32.
    """
    t_hi = t_hi.astype(F)
    q = jnp.round(t_hi * F(4.0))  # exact product (t <= 1), exact round
    r = t_hi - q * F(0.25)  # both on the 2^-24 grid: exact
    if t_lo is not None:
        r = r + t_lo.astype(F)
    x = r * F(2.0 * np.pi)  # |x| <= pi/4 (+eps)
    x2 = x * x
    # minimax-grade Taylor: trunc error < 0.5 ulp at |x| <= pi/4
    s = x * (
        F(1.0)
        + x2 * (F(-1.0 / 6) + x2 * (F(1.0 / 120) + x2 * F(-1.0 / 5040)))
    )
    c = F(1.0) + x2 * (
        F(-0.5)
        + x2 * (F(1.0 / 24) + x2 * (F(-1.0 / 720) + x2 * F(1.0 / 40320)))
    )
    qm = jnp.mod(q, F(4.0))
    cos = jnp.where(
        qm == 0, c, jnp.where(qm == 1, -s, jnp.where(qm == 2, -c, s))
    )
    sin = jnp.where(
        qm == 0, s, jnp.where(qm == 1, c, jnp.where(qm == 2, -s, -c))
    )
    return cos, sin


_LN2_HI = np.float32(0.69314575195)  # 17 explicit bits: e * LN2_HI is exact
_LN2_LO = np.float32(1.428606765330187045e-06)


def log_f32(x):
    """Natural log of f32 x > 0, ~2 ulp (Cody-Waite + atanh-form poly).

    Exponent/mantissa split via integer bits; the mantissa is folded into
    [sqrt(1/2), sqrt(2)) so the poly argument z = (m-1)/(m+1) satisfies
    |z| <= 0.1716.
    """
    import jax

    x = jnp.asarray(x, F)
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    e = (bits >> 23) - 127  # unbiased exponent (x > 0: no sign bit)
    m_bits = (bits & jnp.int32(0x007FFFFF)) | jnp.int32(0x3F800000)
    m = jax.lax.bitcast_convert_type(m_bits, F)  # mantissa in [1, 2)
    fold = m > F(np.sqrt(2.0))
    m = jnp.where(fold, m * F(0.5), m)
    e = (e + fold.astype(jnp.int32)).astype(F)
    z = (m - F(1.0)) / (m + F(1.0))
    z2 = z * z
    # 2*atanh(z) series: error < 0.5 ulp for |z| <= 0.1716
    p = F(2.0) + z2 * (
        F(2.0 / 3) + z2 * (F(2.0 / 5) + z2 * (F(2.0 / 7) + z2 * F(2.0 / 9)))
    )
    return e * _LN2_HI + (z * p + e * _LN2_LO)


def log_uniform(r_hi, r_lo):
    """ln(r_hi + r_lo) for a split (0, 1] uniform, ~2 ulp.

    r_hi carries the top 24 bits (possibly zero for tiny draws); r_lo the
    next ~40.  For r_hi large enough the low part enters as a first-order
    correction; for tiny draws (r_hi < 2^-16, probability ~2^-40 per mode)
    the plain f32 value is already 1-ulp accurate relative to |ln r| >= 11.
    """
    r_hi = r_hi.astype(F)
    r_lo = r_lo.astype(F)
    small = r_hi < F(2.0**-16)
    safe_hi = jnp.where(small, F(1.0), r_hi)
    main = log_f32(safe_hi) + r_lo / safe_hi
    tiny = log_f32(jnp.maximum(r_hi + r_lo, F(2.0**-64)))
    return jnp.where(small, tiny, main)
