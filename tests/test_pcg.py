"""Bit-exactness tests for the pcg64 reimplementation.

Golden vectors were produced by compiling a tiny oracle against the
reference's vendored pcg_random.hpp (setseq_xsl_rr_128_64) and recording
its outputs for fixed seeds/advances.
"""

import numpy as np
import pytest

from zeldovich.ops import pcg

GOLDEN_SEED12346_FIRST10 = [
    13376226141762278320,
    13264298068723250620,
    14189328008317063736,
    6008591607947420752,
    5915180481659425402,
    10739605856075980974,
    3442506061410066939,
    9818942624179824377,
    263005239767887297,
    13662061688106079182,
]

GOLDEN_SEED0_FIRST5 = [
    74029666500212977,
    8088122161323000979,
    16521829690994476282,
    10814004662382438494,
    9052198920789078554,
]

# pcg64(12346).advance(2*65536^2) then 4 draws == start of y-plane 1
GOLDEN_PLANE1_FIRST4 = [
    14931042480954944222,
    11793439614003161146,
    1179788419242137123,
    1715222084089466587,
]

GOLDEN_ONE_RAND_FIRST6 = [
    7.25126672127802907e-01,
    7.19059039130251487e-01,
    7.69205012636338781e-01,
    3.25726403745738191e-01,
    3.20662576442950098e-01,
    5.82195200039781202e-01,
]

GOLDEN_SEED777_ADV = {
    1: 4500165699736595558,
    2: 10726901010135783074,
    3: 6455959980016750265,
    12345: 7902588474115069799,
    2 * 65536: 4206294156916089939,
    1 << 40: 7464981977453899010,
}


def draws(state, n):
    out = []
    for _ in range(n):
        v, state = pcg.next_draw(state)
        out.append(v)
    return out


def test_seed12346_stream():
    assert draws(pcg.seed_state(12346), 10) == GOLDEN_SEED12346_FIRST10


def test_seed0_stream():
    assert draws(pcg.seed_state(0), 5) == GOLDEN_SEED0_FIRST5


def test_advance_matches_oracle():
    for delta, want in GOLDEN_SEED777_ADV.items():
        s = pcg.advance(pcg.seed_state(777), delta)
        assert draws(s, 1)[0] == want, delta


def test_advance_equals_stepping():
    s = pcg.seed_state(42)
    stepped = s
    for _ in range(1000):
        stepped = pcg.bump(stepped)
    assert pcg.advance(s, 1000) == stepped


def test_affine_compose():
    a = pcg.advance_affine(123)
    b = pcg.advance_affine(4567)
    m, c = pcg.compose_affine(a, b)
    s = pcg.seed_state(9)
    assert (m * s + c) & pcg.MASK128 == pcg.advance(s, 123 + 4567)


def test_distance():
    s = pcg.seed_state(5)
    assert pcg.distance(s, pcg.advance(s, 98765)) == 98765


def test_plane_states_match_reference_ctor():
    # v2rng[i] = v2rng[i-1].advance(2*MAX_PPD^2)  (power_spectrum.cpp:26-38)
    states = pcg.plane_states(12346, 3)
    assert draws(states[1], 4) == GOLDEN_PLANE1_FIRST4
    assert states[2] == pcg.advance(states[0], 2 * pcg.DRAWS_PER_PLANE)


def test_one_rand_rounding():
    got = [pcg.one_rand(r) for r in draws(pcg.seed_state(12346), 6)]
    assert got == GOLDEN_ONE_RAND_FIRST6
    assert pcg.one_rand(pcg.MASK64) == 1.0
    assert pcg.one_rand(0) == 2.0**-64


def test_logical_index():
    assert pcg.logical_index(0, 64) == 0
    assert pcg.logical_index(32, 64) == 32
    assert pcg.logical_index(33, 64) == pcg.MAX_PPD - 64 + 33
    assert pcg.logical_index(63, 64) == pcg.MAX_PPD - 1


def test_mode_offset_matches_serial_walk():
    """The closed-form offset must equal the reference's serial nskip walk."""
    ppd = 8
    half = ppd // 2
    off = 0  # draws consumed/skipped since plane start, walked serially
    for z in range(ppd):
        if z == half + 1:  # crossed the z wrap: skip MAX_PPD-ppd logical rows
            off += 2 * (pcg.MAX_PPD - ppd) * pcg.MAX_PPD
        for x in range(ppd):
            if x == half + 1:  # crossed the x wrap within the row
                off += 2 * (pcg.MAX_PPD - ppd)
            assert pcg.mode_draw_offset(0, z, x, ppd) == off, (z, x)
            off += 2
    # x=ppd-1 lands on logical slot MAX_PPD-1, so the plane ends exactly at
    # the boundary the reference asserts (zeldovich.cpp:478)
    assert off == pcg.DRAWS_PER_PLANE


def test_axis_affine_tables():
    ppd = 16
    mz, cz = pcg.axis_affine_tables(ppd, 2 * pcg.MAX_PPD)
    mx, cx = pcg.axis_affine_tables(ppd, 2)
    s0 = pcg.seed_state(12346)
    rng = np.random.default_rng(0)
    for _ in range(20):
        z = int(rng.integers(0, ppd))
        x = int(rng.integers(0, ppd))
        m = (pcg.from_limbs32(mz[z]) * pcg.from_limbs32(mx[x])) & pcg.MASK128
        c = (
            pcg.from_limbs32(mz[z]) * pcg.from_limbs32(cx[x]) + pcg.from_limbs32(cz[z])
        ) & pcg.MASK128
        got = (m * s0 + c) & pcg.MASK128
        want = pcg.advance(s0, pcg.mode_draw_offset(0, z, x, ppd))
        assert got == want, (z, x)


def test_limb_roundtrip():
    v = pcg.seed_state(31337)
    assert pcg.from_limbs32(pcg.to_limbs32(v)) == v


def test_prebump_axis_tables():
    """The pre-bumped z table composed with x lands on the draw-1 state:
    advance(s0, offset) followed by ONE LCG bump (pcg64 advance-then-
    output), for every (z, x)."""
    ppd = 16
    mz, cz = pcg.prebump_axis_tables(
        *pcg.axis_affine_tables(ppd, 2 * pcg.MAX_PPD)
    )
    mx, cx = pcg.axis_affine_tables(ppd, 2)
    s0 = pcg.seed_state(777)
    rng = np.random.default_rng(5)
    for _ in range(20):
        z = int(rng.integers(0, ppd))
        x = int(rng.integers(0, ppd))
        m = (pcg.from_limbs32(mz[z]) * pcg.from_limbs32(mx[x])) & pcg.MASK128
        c = (
            pcg.from_limbs32(mz[z]) * pcg.from_limbs32(cx[x])
            + pcg.from_limbs32(cz[z])
        ) & pcg.MASK128
        got = (m * s0 + c) & pcg.MASK128
        jumped = pcg.advance(s0, pcg.mode_draw_offset(0, z, x, ppd))
        want = (jumped * pcg.PCG64_MULT + pcg.PCG64_INC) & pcg.MASK128
        assert got == want, (z, x)
