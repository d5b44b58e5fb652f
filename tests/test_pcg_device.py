"""Device (jnp limb-math) pcg64 vs the verified host implementation."""

import jax.numpy as jnp
import numpy as np

from zeldovich.ops import pcg, pcg_device


def rand128(rng, shape):
    vals = [int.from_bytes(rng.bytes(16), "little") for _ in range(np.prod(shape))]
    arr = np.stack([pcg.to_limbs32(v) for v in vals]).reshape(*shape, 4)
    return vals, pcg_device.unpack(jnp.asarray(arr))


def test_mul_add_128():
    rng = np.random.RandomState(0)
    av, a = rand128(rng, (17,))
    bv, b = rand128(rng, (17,))
    got_mul = np.asarray(pcg_device.pack(pcg_device.mul128(a, b)))
    got_add = np.asarray(pcg_device.pack(pcg_device.add128(a, b)))
    for i in range(17):
        assert pcg.from_limbs32(got_mul[i]) == (av[i] * bv[i]) & pcg.MASK128
        assert pcg.from_limbs32(got_add[i]) == (av[i] + bv[i]) & pcg.MASK128


def test_bump_and_output():
    rng = np.random.RandomState(1)
    sv, s = rand128(rng, (9,))
    bumped = np.asarray(pcg_device.pack(pcg_device.bump(s)))
    outs = np.asarray(pcg_device.output_u64(s))
    for i in range(9):
        assert pcg.from_limbs32(bumped[i]) == pcg.bump(sv[i])
        assert int(outs[i]) == pcg.output(sv[i])


def test_uniform_conversion():
    r = jnp.asarray(
        np.array([0, 1, 2**63, 2**64 - 2, 2**64 - 1], dtype=np.uint64)
    )
    got = np.asarray(pcg_device.uniform_from_u64(r))
    want = [pcg.one_rand(int(v)) for v in np.asarray(r)]
    np.testing.assert_array_equal(got, want)


def test_mode_uniforms_match_host():
    """Full pipeline: tables + device compose == host scalar advance."""
    seed, ppd = 12346, 16
    # mode_uniform_pair's contract: the z table is pre-bumped
    mzt, czt = pcg.prebump_axis_tables(
        *pcg.axis_affine_tables(ppd, 2 * pcg.MAX_PPD)
    )
    mxt, cxt = pcg.axis_affine_tables(ppd, 2)
    planes = pcg.plane_state_table(seed, ppd)

    ys, zs, xs = np.meshgrid(
        np.arange(ppd // 2), np.arange(ppd), np.arange(ppd), indexing="ij"
    )
    u = lambda t: pcg_device.unpack(jnp.asarray(t))
    g = pcg_device.gather
    R, T = pcg_device.mode_uniform_pair(
        g(u(planes), ys),
        g(u(mzt), zs),
        g(u(czt), zs),
        g(u(mxt), xs),
        g(u(cxt), xs),
    )
    R, T = np.asarray(R), np.asarray(T)

    rng = np.random.RandomState(7)
    for _ in range(30):
        y = rng.randint(ppd // 2)
        z = rng.randint(ppd)
        x = rng.randint(ppd)
        r_host, t_host = pcg.mode_uniforms(seed, y, z, x, ppd)
        assert R[y, z, x] == r_host, (y, z, x)
        assert T[y, z, x] == t_host, (y, z, x)


def test_fast_uniform_f32_semantics():
    """The fast f32 uniform (ZT_DRAW_FAST, the f32-path default): strictly
    positive, <= 1 + 2^-32, and within ~2^-24 absolute of the exact
    (x+1)*2^-64 -- the documented approximation budget."""
    rng = np.random.RandomState(2)
    r = np.concatenate([
        rng.randint(0, 2**63, size=5000).astype(np.uint64) * np.uint64(2),
        np.array([0, 1, 63, 64, 2**32 - 1, 2**32, 2**63,
                  2**64 - 2, 2**64 - 1], dtype=np.uint64),
    ])
    got = np.asarray(pcg_device.fast_uniform_f32_from_u64(jnp.asarray(r)))
    exact = np.asarray(
        pcg_device.uniform_from_u64(jnp.asarray(r), jnp.float64)
    )
    assert got.min() > 0.0  # log() must never see 0
    assert got.max() <= 1.0 + 2.0**-31
    np.testing.assert_allclose(got, exact, atol=2.0**-24)
    # halves form == u64 form (the kernel uses the halves entry point)
    lo = jnp.asarray((r & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((r >> np.uint64(32)).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(pcg_device.fast_uniform_f32(lo, hi)), got
    )


def test_sincos_2pi_accuracy_and_fallback():
    """Fast sincos: few-ulp accuracy on the uniform's range; exact
    jnp fallback for f64."""
    T = np.concatenate([
        np.random.RandomState(3).uniform(2**-30, 1.0, 20000),
        np.array([2.0**-64, 0.25, 0.5, 0.75, 1.0, 1.0 + 2.0**-32]),
    ])
    c, s = pcg_device.sincos_2pi(jnp.asarray(T, jnp.float32), np.float32)
    np.testing.assert_allclose(np.asarray(c), np.cos(2 * np.pi * T), atol=5e-7)
    np.testing.assert_allclose(np.asarray(s), np.sin(2 * np.pi * T), atol=5e-7)
    # unit amplitude to poly accuracy (angles aside): c^2 + s^2 == 1
    np.testing.assert_allclose(
        np.asarray(c) ** 2 + np.asarray(s) ** 2, 1.0, atol=1e-6
    )
    c64, s64 = pcg_device.sincos_2pi(jnp.asarray(T, jnp.float64), np.float64)
    np.testing.assert_array_equal(np.asarray(c64), np.cos(2 * np.pi * T))
    np.testing.assert_array_equal(np.asarray(s64), np.sin(2 * np.pi * T))


def test_draw_fast_gate_off_restores_exact_f32(monkeypatch):
    """ZT_DRAW_FAST=0 routes uniform_from_u64(f32) back to the exact
    reference rounding."""
    monkeypatch.setenv("ZT_DRAW_FAST", "0")
    r = jnp.asarray(np.array([0, 1, 2**63, 2**64 - 1], dtype=np.uint64))
    got = np.asarray(pcg_device.uniform_from_u64(r, jnp.float32))
    want = np.array([pcg.one_rand(int(v)) for v in np.asarray(r)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_mul128_u16_form_bit_exact(monkeypatch):
    """The u16-limb mul128 (ZT_MADD16) is bit-exact with the u64 form,
    including the all-ones / zero / constant edges, and the full draw
    chain routes through it unchanged."""
    rng = np.random.RandomState(7)
    av, a = rand128(rng, (33,))
    bv, b = rand128(rng, (33,))
    edge_vals = [0, 1, pcg.MASK128, pcg.PCG64_MULT, pcg.PCG64_INC,
                 (1 << 64) - 1, 1 << 64, (1 << 127) | 1]
    ev = np.stack([pcg.to_limbs32(v) for v in edge_vals]).reshape(-1, 4)
    e = pcg_device.unpack(jnp.asarray(ev))
    got = np.asarray(pcg_device.pack(pcg_device._mul128_u16(a, b)))
    for i in range(33):
        assert pcg.from_limbs32(got[i]) == (av[i] * bv[i]) & pcg.MASK128
    ge = np.asarray(pcg_device.pack(pcg_device._mul128_u16(e, e)))
    for i, v in enumerate(edge_vals):
        assert pcg.from_limbs32(ge[i]) == (v * v) & pcg.MASK128
    # full-chain: uniforms identical under the gate
    sv, s = rand128(rng, (16,))
    mv, m = rand128(rng, (16,))
    cv, c = rand128(rng, (16,))
    base = [np.asarray(x) for x in
            pcg_device.uniform_pair_from_affine(s, m, c, jnp.float64)]
    monkeypatch.setenv("ZT_MADD16", "1")
    gated = [np.asarray(x) for x in
             pcg_device.uniform_pair_from_affine(s, m, c, jnp.float64)]
    np.testing.assert_array_equal(base[0], gated[0])
    np.testing.assert_array_equal(base[1], gated[1])
