"""f64-accurate matmuls from int8 products (Ozaki-scheme mantissa slicing).

A float32 transform carries ~21-24 effective mantissa bits, outside the
<1e-6 displacement parity target (BASELINE.md).  The Ozaki scheme
recovers f64-grade accuracy from EXACT integer matmuls:

  1. scale each operand by a power of two so |x| <= 1;
  2. slice the mantissa into base-64 limbs: x = s * sum_i q_i 64^-(i+1)
     with q_i integer, |q_i| <= 64 -- an int8-exact representation;
  3. multiply limb pairs as int8 matmuls.  int32 accumulation is exact
     (k * 64^2 < 2^31 for k < 512k), so the ONLY errors are the dropped
     limb tails -- ~2^-36 relative for 6 limbs / cross-order cutoff 5;
  4. recombine the int32 partial products in float64 (cheap elementwise).

For DFT matmuls the matrix side is static, so its limbs are precomputed
exactly on host at trace time; only the data side is sliced at runtime.

The ``--dtype df64`` transforms (ops/mmfft.py) are built on it.  Plain
float64 pair transforms use native f64 dots unless ``ZT_OZAKI=1``.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BASE_BITS = 6
BASE = 1 << BASE_BITS  # 64: |round(r * 64)| <= 64 fits int8 with no clipping

#: limbs per operand / max cross order kept.  6/5 -> ~2^-36 input
#: representation, ~2^-42 dropped-tail error: ~1e-11 relative, 5 orders
#: beyond the 1e-6 parity bar, at 21 int8 matmuls per real f64 matmul.
NLIMB = int(os.environ.get("ZT_OZAKI_LIMBS", "6"))


def _pow2_ceil(m: float) -> float:
    if not np.isfinite(m) or m <= 0.0:
        return 1.0
    return float(2.0 ** np.ceil(np.log2(m)))


def slice_static(W: np.ndarray, nlimb: int = NLIMB):
    """Exact host-side limb decomposition of a static matrix.

    Returns (scale, [int8 arrays]): W ~= scale * sum_i limbs[i] * 64^-(i+1)
    to nlimb * 6 bits.
    """
    W = np.asarray(W, dtype=np.float64)
    scale = _pow2_ceil(np.abs(W).max())
    r = W / scale
    limbs = []
    for _ in range(nlimb):
        r = r * BASE
        q = np.rint(r)
        limbs.append(q.astype(np.int8))
        r = r - q
    return scale, limbs


def _slice_dynamic(X, nlimb: int):
    """Traced limb decomposition of the data side (f64 in, int8 limbs out).

    The power-of-two scale is PER ROW (the matmul batch element): results
    are then invariant to how the batch is sharded or chunked -- a device
    mesh or lax.map boundary never changes a row's rounding -- and rows
    far below the global maximum keep their full limb precision (k-space
    rows span many decades of P(k)).
    """
    m = jnp.max(jnp.abs(X), axis=-1, keepdims=True)
    # power-of-two scale: exact division, no rounding introduced
    scale = jnp.exp2(jnp.ceil(jnp.log2(jnp.maximum(m, jnp.float64(1e-300)))))
    scale = jnp.where(m == 0.0, jnp.float64(1.0), scale)
    r = X / scale
    limbs = []
    for _ in range(nlimb):
        r = r * BASE
        q = jnp.round(r)
        limbs.append(q.astype(jnp.int8))
        r = r - q
    return scale, limbs


#: target int32 elements per limb-product chunk.  The limb products are
#: the memory hot spot (nlimb+ int32 temps the size of the output live at
#: once); batches whose per-product size exceeds this stream through
#: lax.map in row chunks instead -- at 512^3 the unchunked df64 transform
#: holds ~15 GB of int32 partials.
CHUNK_ELEMS = int(os.environ.get("ZT_OZAKI_CHUNK_ELEMS", str(1 << 26)))


def _chunked_rows(core, args, n_out: int):
    """Run ``core`` over row chunks of (..., k) pytree ``args`` via lax.map.

    Bounds live memory to ~CHUNK_ELEMS int32 per limb-product group while
    keeping each chunk matmul-sized.  Returns outputs with leading dims
    restored; ``core`` must be elementwise in the rows (true for a matmul's
    batch side).  Falls through to one direct call for small batches.
    """
    leaves = jax.tree.leaves(args)
    lead, k = leaves[0].shape[:-1], leaves[0].shape[-1]
    B = 1
    for d in lead:
        B *= int(d)
    rows = max(CHUNK_ELEMS // max(n_out, 1), 1)
    if B <= 2 * rows:
        return core(args)
    nch = -(-B // rows)
    pad = nch * rows - B

    def prep(a):
        f = a.reshape(B, k)
        if pad:
            f = jnp.concatenate([f, jnp.zeros((pad, k), f.dtype)])
        return f.reshape(nch, rows, k)

    out = jax.lax.map(core, jax.tree.map(prep, args))
    return jax.tree.map(
        lambda o: o.reshape(nch * rows, n_out)[:B].reshape(*lead, n_out), out
    )


def imatmul(a, b):
    """int8 ``a @ b`` (b 2-D) with exact int32 accumulation.

    The contraction is zero-padded to a multiple of 4: XLA's GPU int8
    matmul returned wrong sums for other lengths (on an H100 at K = 17
    and 65; 68, 80, 128 and 512 were exact), and zero limbs add nothing.
    """
    pad = -a.shape[-1] % 4
    if pad:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        b = jnp.pad(b, [(0, pad), (0, 0)])
    return jnp.matmul(a, b, preferred_element_type=jnp.int32)


def omatmul(X, W_sliced, nlimb: int = NLIMB, cutoff: int | None = None):
    """X @ W with f64-grade accuracy via int8 matmuls.

    X: (..., k) float64; W_sliced: (scale, limbs) from slice_static with
    limbs of shape (k, n).  Keeps cross terms i + j <= cutoff
    (default nlimb - 1).  Large batches stream through row chunks.
    """
    if cutoff is None:
        cutoff = nlimb - 1
    n_out = W_sliced[1][0].shape[-1]
    return _chunked_rows(
        lambda x: _omatmul_core(x, W_sliced, nlimb, cutoff), X, n_out
    )


def _omatmul_core(X, W_sliced, nlimb, cutoff):
    sw, wl = W_sliced
    sx, xl = _slice_dynamic(X, nlimb)
    out = None
    for i in range(min(nlimb, cutoff + 1)):
        for j in range(min(len(wl), cutoff + 1 - i)):
            p = imatmul(xl[i], wl[j])
            term = p.astype(jnp.float64) * (2.0 ** (-BASE_BITS * (i + j + 2)))
            out = term if out is None else out + term
    return out * (sx * sw)


# -- f32-pair (two-float) form: no f64 anywhere -----------------------------
# The f64 form above spends ~60 f64 elementwise ops per element on slicing
# and recombination, which is slow wherever f64 is emulated.  The pair form keeps data as (hi, lo) f32 throughout: slicing is exact f32
# arithmetic, limb products group-reduce in int32 (exact), and the groups
# recombine through an error-free two-sum cascade.  ~2^-40-grade results
# from pure f32 + int8 ops.


def two_sum(a, b):
    """Error-free f32 addition: s + e == a + b exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free addition assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def pair_add(xh, xl, yh, yl):
    """Accurate double-f32 addition (Hida et al.), error O(eps^2).

    Requires NORMALIZED inputs (|lo| <~ ulp(hi)); normalize unnormalized
    term pairs with two_sum first (exact for any magnitudes).
    """
    sh, se = two_sum(xh, yh)
    te, tf = two_sum(xl, yl)
    se = se + te
    sh, se = fast_two_sum(sh, se)
    se = se + tf
    sh, se = fast_two_sum(sh, se)
    return sh, se


def pair_scale(xh, xl, c: float):
    """Multiply a pair by an exactly-representable constant (power of two)."""
    return xh * np.float32(c), xl * np.float32(c)


def _split(a):
    """Veltkamp split: a == hi + lo with hi carrying the top 12 mantissa
    bits -- so hi * hi products of two splits are exact in f32."""
    c = jnp.float32(4097.0) * a  # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free f32 product: p + e == a * b exactly (Dekker, no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def pair_mul(xh, xl, yh, yl):
    """Double-f32 multiplication (Hida et al.), error O(eps^2).

    Used for the four-step df64 twiddle factors (ops/mmfft), where the
    complex rotation must not drop below the ~2^-40 pair accuracy the
    int8 matmuls deliver.
    """
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def _slice_pair_dynamic(hi, lo, nlimb: int):
    """(hi, lo) f32 pair -> power-of-two scale + int8 limbs, all-f32 math.

    The first min(4, nlimb) limbs consume hi's 24-bit mantissa; lo then
    joins the residual (one rounded add at ~2^-48) and feeds the rest.
    ``r - round(r)`` and the base-64 shifts are exact in f32.
    """
    F = jnp.float32
    # per-row scale: sharding/chunk-invariant rounding + full limb
    # precision for small-norm rows (see _slice_dynamic)
    m = jnp.max(jnp.abs(hi), axis=-1, keepdims=True)
    scale = jnp.exp2(jnp.ceil(jnp.log2(jnp.maximum(m, F(1e-30)))))
    scale = jnp.where(m == 0.0, F(1.0), scale)
    r = hi / scale
    limbs = []
    for i in range(nlimb):
        if i == 4:
            # r runs in the 64^i-scaled frame: inject lo at matching scale
            r = r + (lo / scale) * F(float(BASE) ** 4)
        r = r * F(BASE)
        q = jnp.round(r)
        limbs.append(q.astype(jnp.int8))
        r = r - q
    return scale, limbs


def _int32_to_f32_pair(g):
    """Exact f32 pair from an int32 (|g| can exceed 2^24)."""
    g1 = (g >> 12) << 12  # top bits: |g1| < 2^31, g1/2^12 < 2^19 exact
    g2 = g - g1  # |g2| < 2^12: exact
    return g1.astype(jnp.float32), g2.astype(jnp.float32)


def omatmul_pair(x_pair, W_sliced, nlimb: int = NLIMB, cutoff: int | None = None):
    """f32-pair X @ W via int8 matmuls; returns an (hi, lo) f32 pair.

    x_pair: (hi, lo) f32 arrays (..., k); W_sliced from slice_static.
    Limb products with equal cross-order d = i + j are reduced in int32
    (exact: k * 64^2 * (d+1) < 2^31 through k = 16k), then the per-order
    terms -- strictly ~64x decreasing -- accumulate through two-sum.
    Large batches stream through row chunks (see _chunked_rows).
    """
    if cutoff is None:
        cutoff = nlimb - 1
    n_out = W_sliced[1][0].shape[-1]
    return _chunked_rows(
        lambda p: _omatmul_pair_core(p, W_sliced, nlimb, cutoff), x_pair, n_out
    )


def _omatmul_pair_core(x_pair, W_sliced, nlimb, cutoff):
    sw, wl = W_sliced
    xh, xl = x_pair
    sx, xq = _slice_pair_dynamic(xh, xl, nlimb)
    groups = {}
    for i in range(min(nlimb, cutoff + 1)):
        for j in range(min(len(wl), cutoff + 1 - i)):
            p = imatmul(xq[i], wl[j])
            d = i + j
            groups[d] = p if d not in groups else groups[d] + p
    hi = jnp.float32(0.0)
    lo = jnp.float32(0.0)
    for d in sorted(groups, reverse=True):  # smallest terms first
        c = np.float32(2.0 ** (-BASE_BITS * (d + 2)))
        g1, g2 = _int32_to_f32_pair(groups[d])
        th, tl = two_sum(g1 * c, g2 * c)  # normalize the term pair (exact)
        hi, lo = pair_add(hi, lo, th, tl)
    # power-of-two product: exact scaling of both components
    s = sx * np.float32(sw)
    return hi * s, lo * s


def use_ozaki(dtype) -> bool:
    """Whether float64 pair-route matmuls go through the int8 scheme.

    Off unless ``ZT_OZAKI=1``: the CPU and the GPU both have native f64
    dots, and on an H100 they beat the int8 scheme at 512^3 (PERF.md,
    "Route timings").
    """
    return dtype == jnp.float64 and os.environ.get("ZT_OZAKI") == "1"
