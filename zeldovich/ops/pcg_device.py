"""Vectorized on-device pcg64: 128-bit limb arithmetic in JAX.

XLA has no 128-bit integer type, so the 128-bit LCG state is carried as
four little-endian uint32 limbs and all products are formed as exact
32x32->64 partial products in uint64.

Limb LAYOUT: a 128-bit value is a TUPLE of four u32 arrays (limb-planes),
least-significant first -- never a trailing length-4 array axis, which
would make every elementwise op a strided one over a tiny minor axis.
Tuples of planes keep every array at its natural (..., X) shape.  ``pack``/``unpack`` convert to/from the (..., 4) form at
host boundaries (tests, table construction).

The host precomputes, per grid axis, the affine jump-ahead coefficients
``(m_i, c_i)`` that position the generator at logical slot ``i`` of the
virtual 65536-wide axis (see ``zeldovich/ops/pcg.py``); the z (outer)
table additionally folds in one LCG step (``pcg.prebump_axis_tables``) so
the composed map lands directly on the state at the mode's first output
draw.  On device, a mode's two uniforms then cost: one state application
(madd128 -- the (z, x) compose itself is one-time setup work when the 2-D
tables are precomposed), one LCG bump for the second draw, and two XSL-RR
output permutations -- all elementwise work with no cross-element traffic.

Semantics are bit-exact with the reference's vendored pcg_random.hpp
(``setseq_xsl_rr_128_64``): verified in tests/test_pcg_device.py against the
pure-Python implementation (itself verified against a compiled oracle).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import pcg

_U32 = jnp.uint32
_U64 = jnp.uint64
_LO32 = np.uint64(0xFFFFFFFF)

# LCG constants as numpy limb arrays (closed over by jitted callers).
MULT_LIMBS = pcg.to_limbs32(pcg.PCG64_MULT)
INC_LIMBS = pcg.to_limbs32(pcg.PCG64_INC)


def unpack(a):
    """(..., 4) u32 array -> limb-plane tuple (host-boundary helper)."""
    a = jnp.asarray(a)
    return a[..., 0], a[..., 1], a[..., 2], a[..., 3]


def pack(t):
    """Limb-plane tuple -> (..., 4) u32 array (host-boundary helper)."""
    return jnp.stack(list(t), axis=-1)


def gather(t, idx):
    """Index every limb plane of tuple ``t`` with ``idx`` (tuple = multi-dim)."""
    return tuple(a[idx] for a in t)


def _limbs64(a):
    """Limb-plane tuple -> tuple of 4 u64 arrays."""
    return tuple(x.astype(_U64) for x in a)


def madd16_on() -> bool:
    """Trace-time gate for the u16-limb mul128 form (ZT_MADD16)."""
    import os

    return os.environ.get("ZT_MADD16", "0") != "0"


def _mul128_u16(a, b):
    """Low 128 bits of a*b via 16-bit limb schoolbook -- all-u32 arithmetic.

    The u64-limb form below leans on XLA's u64 multiply; where u64 is
    emulated, each 32x32->64 partial product becomes a full 64x64
    emulation (the compiler cannot see that the high words are zero).
    Here the 128-bit operands are split into eight 16-bit pieces held in
    u32 lanes; every product of two pieces is < 2^32 (exact in one u32
    multiply), product halves are binned per 16-bit output column (at
    most 15 summands of < 2^16 each, so column sums stay < 2^20 in u32),
    and one carry sweep re-packs the eight columns into four u32 limbs.
    ~36 hardware multiplies instead of the emulation's ~10 u64 ones.
    Bit-exact with _mul128_u64 (tests/test_pcg_device.py).
    """
    M16 = _U32(0xFFFF)
    S16 = _U32(16)

    def pieces(t):
        out = []
        for limb in t:
            out.append(limb & M16)
            out.append(limb >> S16)
        return out  # little-endian base-2^16 limbs, len 8

    A, B = pieces(a), pieces(b)
    # bin product halves per output column k (mod 2^128 keeps k = 0..7)
    cols = [[] for _ in range(8)]
    for i in range(8):
        for j in range(8 - i):
            k = i + j
            p = A[i] * B[j]
            if k < 7:
                cols[k].append(p & M16)
                cols[k + 1].append(p >> S16)
            else:  # the high half of column 7 falls off the top
                cols[k].append(p & M16)
    # one carry sweep, then re-pack pairs of 16-bit columns into u32 limbs
    carry = None
    digs = []
    for k in range(8):
        t = sum(cols[k][1:], cols[k][0])
        if carry is not None:
            t = t + carry
        digs.append(t & M16)
        carry = t >> S16
    return tuple(
        digs[2 * w] | (digs[2 * w + 1] << S16) for w in range(4)
    )


def mul128(a, b):
    """Low 128 bits of a*b over limb-plane tuples.

    Dispatches to the u16-limb form when ZT_MADD16 is set; default is the
    u64-emulation schoolbook below.  Both are bit-exact.
    """
    if madd16_on():
        return _mul128_u16(a, b)
    return _mul128_u64(a, b)


def _mul128_u64(a, b):
    """Low 128 bits of a*b over limb-plane tuples.

    Schoolbook multiply over 32-bit limbs; each 32x32 partial product is an
    exact uint64.  Products' low/high halves are accumulated per column (max
    8 summands < 2^32 each, so column sums stay well under 2^64) and carries
    are propagated once at the end.
    """
    a0, a1, a2, a3 = _limbs64(a)
    b0, b1, b2, b3 = _limbs64(b)

    p00 = a0 * b0
    p01 = a0 * b1
    p02 = a0 * b2
    p03 = a0 * b3
    p10 = a1 * b0
    p11 = a1 * b1
    p12 = a1 * b2
    p20 = a2 * b0
    p21 = a2 * b1
    p30 = a3 * b0

    c0 = p00 & _LO32
    c1 = (p00 >> np.uint64(32)) + (p01 & _LO32) + (p10 & _LO32)
    c2 = (
        (p01 >> np.uint64(32))
        + (p10 >> np.uint64(32))
        + (p02 & _LO32)
        + (p11 & _LO32)
        + (p20 & _LO32)
    )
    c3 = (
        (p02 >> np.uint64(32))
        + (p11 >> np.uint64(32))
        + (p20 >> np.uint64(32))
        + (p03 & _LO32)
        + (p12 & _LO32)
        + (p21 & _LO32)
        + (p30 & _LO32)
    )

    r0 = c0
    c1 = c1 + (r0 >> np.uint64(32))
    c2 = c2 + (c1 >> np.uint64(32))
    c3 = c3 + (c2 >> np.uint64(32))
    return (
        (r0 & _LO32).astype(_U32),
        (c1 & _LO32).astype(_U32),
        (c2 & _LO32).astype(_U32),
        (c3 & _LO32).astype(_U32),
    )


def add128(a, b):
    """(a + b) mod 2^128 over limb-plane tuples."""
    a0, a1, a2, a3 = _limbs64(a)
    b0, b1, b2, b3 = _limbs64(b)
    s0 = a0 + b0
    s1 = a1 + b1 + (s0 >> np.uint64(32))
    s2 = a2 + b2 + (s1 >> np.uint64(32))
    s3 = a3 + b3 + (s2 >> np.uint64(32))
    return (
        (s0 & _LO32).astype(_U32),
        (s1 & _LO32).astype(_U32),
        (s2 & _LO32).astype(_U32),
        (s3 & _LO32).astype(_U32),
    )


def madd128(m, s, c):
    """(m*s + c) mod 2^128."""
    return add128(mul128(m, s), c)


def compose_affine(ma, ca, mb, cb):
    """Compose jump maps: advancing by delta_b then delta_a -> (m, c)."""
    return mul128(ma, mb), madd128(ma, cb, ca)


def _const_tuple(limbs):
    """128-bit constant -> tuple of scalar u32 arrays (broadcast in ops)."""
    return tuple(jnp.asarray(v, dtype=_U32) for v in limbs)


def bump(state):
    """One LCG step in limb-tuple form."""
    return madd128(_const_tuple(MULT_LIMBS), state, _const_tuple(INC_LIMBS))


def output_u64(state):
    """XSL-RR permutation -> uint64 values. state: limb tuple -> array u64."""
    s0, s1, s2, s3 = _limbs64(state)
    lo = s0 | (s1 << np.uint64(32))
    hi = s2 | (s3 << np.uint64(32))
    rot = (s3 >> np.uint64(26)).astype(_U64)  # top 6 bits of the state
    x = hi ^ lo
    return (x >> rot) | (x << ((np.uint64(64) - rot) & np.uint64(63)))


def uniform_from_u64(r, dtype=jnp.float64):
    """uint64 -> (0, 1] exactly as the reference one_rand<2>.

    ``ldexp((double)(r+1), -64)`` with the all-ones guard returning 1.0
    (power_spectrum.cpp:284-308).

    The uint64 -> double conversion must round to nearest like C.  An
    emulated u64->f64 convert need not (observed mis-rounding for values
    >= 2^53 on one backend), so the double is assembled from two *exact* u32->f64
    converts: hi*2^32 and lo are both exact doubles, and their one f64
    addition is correctly rounded -- giving round-to-nearest(r+1) on any
    backend.
    """
    if dtype == jnp.float32 and draw_fast():
        return fast_uniform_f32_from_u64(r)
    r1 = r + np.uint64(1)  # wraps to 0 exactly when r == 2^64-1
    hi = (r1 >> np.uint64(32)).astype(_U32)
    lo = (r1 & np.uint64(0xFFFFFFFF)).astype(_U32)
    v = (hi.astype(dtype) * dtype(2.0**32) + lo.astype(dtype)) * dtype(2.0**-64)
    return jnp.where(r == np.uint64(0xFFFFFFFFFFFFFFFF), dtype(1.0), v)


# ---------------------------------------------------------------------------
# Fast f32 draw semantics (ZT_DRAW_FAST): the headline f32 path's uniform
# conversion and Box-Muller trig, redefined for elementwise op count.  The f64 and
# split-f32 (df64) paths keep the reference-exact semantics; this is the
# documented approximation budget of the fast path:
#   uniform: |v - (x+1)*2^-64| <= ~2^-25 absolute (one rounded i32->f32
#            convert per half instead of two exact 16-bit converts each);
#            range (0, 1 + 2^-32], strictly positive.
#   sincos:  minimax polynomials on the quadrant-reduced argument,
#            max abs error 4.7e-8 (cos) / 3.4e-9 (sin) -- below 1 f32 ulp
#            of unit amplitude, vs jnp.cos/sin's generic range reduction.
# ---------------------------------------------------------------------------


def draw_fast() -> bool:
    """Trace-time gate for the fast f32 draw semantics (default ON)."""
    import os

    return os.environ.get("ZT_DRAW_FAST", "1") != "0"


def _i32f(v):
    """u32 array -> f32 of (v - 2^31), one signed convert."""
    import jax.lax as lax

    return lax.bitcast_convert_type(
        v ^ _U32(0x80000000), jnp.int32
    ).astype(jnp.float32)


def fast_uniform_f32(lo, hi):
    """(hi:lo) u32 halves -> ~(x+1)*2^-64 in (0, 1 + 2^-32], f32.

    v = fl(fl((hi-2^31)*2^-32 + 0.5) + fl((lo-2^31)*2^-64 + C2)) with
    C2 = 2^-33 * (1 + 2^-23): the +2^-56 overshoot keeps v strictly
    positive even at hi == lo == 0 (log never sees 0), below f32
    resolution everywhere else.  11 elementwise ops vs ~27 for the exact form.
    """
    F = jnp.float32
    a = _i32f(hi) * F(2.0**-32) + F(0.5)
    b = _i32f(lo) * F(2.0**-64) + F(2.0**-33 * (1.0 + 2.0**-23))
    return a + b


def fast_uniform_f32_from_u64(r):
    """XLA twin of fast_uniform_f32 (identical float ops, so identical
    bits) taking the packed u64 draw."""
    hi = (r >> np.uint64(32)).astype(_U32)
    lo = (r & _LO32).astype(_U32)
    return fast_uniform_f32(lo, hi)


# minimax fits of cos(2 pi r) and sin(2 pi r)/r on r in [-1/4, 1/4]
# (even polynomials in u = r^2; Chebyshev-node lstsq, scripts history):
# max abs errors 4.7e-8 and 3.4e-9
_COS2PI = (0.9999999532476083, -19.739171322478587, 64.93458164580112,
           -85.24010035715638, 56.240540440829314)
_SIN2PI = (6.283185159611168, -41.34165492934352, 81.6009981926163,
           -76.54965682070578, 39.535813712149924)


def sincos_2pi(T, fdt):
    """(cos(2 pi T), sin(2 pi T)) -- fast f32 form when enabled.

    Fast form: quadrant-reduce with T's known O(1) range (two rounds)
    instead of the lowering's generic large-argument reduction, then one
    degree-8/9 polynomial pair.  Falls back to jnp.cos/sin for f64 or
    when ZT_DRAW_FAST=0.
    """
    theta = lambda: fdt(2 * np.pi) * T
    if fdt != np.float32 or not draw_fast():
        return jnp.cos(theta()), jnp.sin(theta())
    F = jnp.float32
    t = T - jnp.round(T)              # [-1/2, 1/2]
    q = jnp.round(t + t)              # {-1, 0, 1}
    r = t - q * F(0.5)                # [-1/4, 1/4]
    u = r * r
    c = F(_COS2PI[4])
    s = F(_SIN2PI[4])
    for k in (3, 2, 1, 0):
        c = c * u + F(_COS2PI[k])
        s = s * u + F(_SIN2PI[k])
    s = s * r
    sign = F(1.0) - (jnp.abs(q) + jnp.abs(q))  # +1 for q==0, -1 for |q|==1
    return sign * c, sign * s


def split_uniform_f32(r):
    """uint64 -> (hi, lo) f32 pair: hi + lo == the (0, 1] uniform to 2^-64.

    hi carries the top 24 bits (exact int->f32 converts), lo the next 40
    (one rounded f32 add, ~2^-72 absolute error).  Lets f32 pipelines
    consume the full 64-bit draw (the single-f32 uniform quantizes angles
    at 2^-24, which alone costs ~2e-7 displacement error).
    """
    r1 = r + np.uint64(1)  # wraps to 0 exactly when r == 2^64-1 (-> 1.0)
    a = (r1 >> np.uint64(40)).astype(jnp.int32)  # < 2^24: exact in f32
    b = ((r1 >> np.uint64(16)) & np.uint64(0xFFFFFF)).astype(jnp.int32)
    c = (r1 & np.uint64(0xFFFF)).astype(jnp.int32)
    F = jnp.float32
    hi = a.astype(F) * F(2.0**-24)
    lo = b.astype(F) * F(2.0**-48) + c.astype(F) * F(2.0**-64)
    all_ones = r == np.uint64(0xFFFFFFFFFFFFFFFF)
    hi = jnp.where(all_ones, F(1.0), hi)
    lo = jnp.where(all_ones, F(0.0), lo)
    return hi, lo


def uniform_pair_split_from_affine(plane_state, m, c):
    """Split-f32 twin of uniform_pair_from_affine.

    Returns (R_hi, R_lo, T_hi, T_lo): both 64-bit draws as f32 hi/lo pairs.
    """
    s1 = madd128(m, plane_state, c)  # (m, c) is pre-bumped: draw-1 state
    s2 = bump(s1)
    return (*split_uniform_f32(output_u64(s1)), *split_uniform_f32(output_u64(s2)))


def mode_uniform_pair(plane_state, mz, cz, mx, cx, dtype=jnp.float64):
    """The two uniforms (R, theta_frac) for a batch of modes.

    plane_state: limb tuple -- the y-plane start state per mode
    mz, cz:      limb tuples -- PRE-BUMPED z-axis affine coefficients per
                 mode (pcg.prebump_axis_tables)
    mx, cx:      limb tuples -- x-axis affine coefficients per mode

    Returns (R, theta_frac) arrays of the broadcast shape, in (0, 1].
    """
    m, c = compose_affine(mz, cz, mx, cx)
    return uniform_pair_from_affine(plane_state, m, c, dtype)


def uniform_pair_from_affine(plane_state, m, c, dtype=jnp.float64):
    """Uniforms from a precomposed per-mode jump map (m, c).

    CONTRACT: (m, c) is a *pre-bumped* map (pcg.prebump_axis_tables folds
    one LCG step into the z-axis table at build), so the single madd lands
    directly on the state at the mode's first output draw; the second
    draw is one further bump.  With the (z, x) maps also precomposed into
    2-D tables at setup, a mode costs 2 mul128 instead of 5.
    """
    s1 = madd128(m, plane_state, c)
    s2 = bump(s1)
    return (
        uniform_from_u64(output_u64(s1), dtype),
        uniform_from_u64(output_u64(s2), dtype),
    )
