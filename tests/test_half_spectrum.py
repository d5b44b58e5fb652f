"""Half-spectrum (c2r) path == full-grid complex path, bit-for-bit physics.

The half path never materializes the Hermitian mirror half: both packings
D+iF / D-iF are carried on ky in [0, half] and the y transform is a c2r
matmul (ops/mmfft.c2r_y_pair).  These tests pin it against the complex
full-grid pipeline across every mode combination it supports.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from zeldovich.models.pipeline import Zeldovich
from zeldovich.utils.params import Parameters

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"


def make_params(ppd=16, **over):
    d = dict(
        BoxSize=100.0,
        NP=ppd**3,
        CPD=100,
        ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/ic_half",
        InitialRedshift=49.0,
        ZD_Seed=12346,
        ZD_NumBlock=2,
        ZD_Pk_scale=1.0,
        ZD_Pk_norm=8.0,
        ZD_Pk_sigma=0.02,
        ZD_Pk_smooth=0.0,
        ZD_Pk_filename=str(ASSETS / "wmap1new.pow"),
        ZD_Version=2,
    )
    d.update(over)
    return Parameters.from_dict(d)


def check(model, atol_scale=1e-12):
    pair = np.asarray(model.xspace_half_pair())
    got = pair[:, 0] + 1j * pair[:, 1]
    want = np.asarray(model.xspace())
    np.testing.assert_allclose(
        got, want, atol=atol_scale * np.abs(want).max(), rtol=0
    )


CASES = {
    "plain": {},
    "fixed_power": {"ZD_qPk_fix_to_mean": 1},
    "k_cutoff": {"ZD_k_cutoff": 2.0},
    "onemode": {"ZD_qonemode": 1, "ZD_one_mode": (2, 3, 1)},
    "density_only": {"ZD_qdensity": 2, "ICFormat": "RVZel"},
    "plt": {
        "ZD_qPLT": 1,
        "ZD_PLT_filename": str(ASSETS / "eigmodes128"),
        "ZD_qPLT_rescale": 1,
        "ZD_PLT_target_z": 5.0,
    },
    "f_NL": {"ZD_f_NL": 30.0, "ZD_n_s": 0.96, "Omega_M": 0.3},
}


@pytest.mark.parametrize(
    "case",
    [
        # plt is the slowest case (~7 s) and PLT half-spectrum parity is
        # also covered by test_sharded_half_matches_incore_half[plt]
        # (f_NL/fixed_power/k_cutoff half parity is also covered by the
        # pipeline- and mode-level fast tests; plain/onemode/density stay)
        pytest.param(c, marks=pytest.mark.slow)
        if c in ("plt", "f_NL", "fixed_power", "k_cutoff")
        else c
        for c in sorted(CASES)
    ],
)
def test_half_matches_complex(case):
    model = Zeldovich(make_params(**CASES[case]), dtype=jnp.float64)
    check(model)


def test_half_matches_pair_f32():
    """f32 half path vs f32 full pair path (identical draw chain)."""
    model = Zeldovich(make_params(), dtype=jnp.float32)
    half = np.asarray(model.xspace_half_pair())
    full = np.asarray(model.xspace_pair())
    np.testing.assert_allclose(
        half, full, atol=2e-5 * np.abs(full).max(), rtol=0
    )


def test_c2r_y_pair_matches_dense():
    """The c2r y matmul == complex transform of the assembled spectrum."""
    from zeldovich.ops import mmfft

    rng = np.random.default_rng(7)
    n, h = 16, 8
    # random Hermitian-in-3D fields D, F on the half-spectrum:
    # build full Hermitian grids, then take ky in [0, h]
    def herm():
        g = rng.normal(size=(n, n, n)) + 1j * rng.normal(size=(n, n, n))
        gr = np.conj(
            g[(-np.arange(n)) % n][:, (-np.arange(n)) % n][
                :, :, (-np.arange(n)) % n
            ]
        )
        out = 0.5 * (g + gr)
        out[h] = 0.0  # y-Nyquist rule
        return out

    D, F = herm(), herm()
    full = D + 1j * F
    want = np.fft.ifftn(full) * full.size  # unnormalized +1 == numpy ifft*N

    sp = (D + 1j * F)[: h + 1]
    sm = (D - 1j * F)[: h + 1]
    spm = np.stack(
        [
            np.stack([sp.real, sp.imag]),
            np.stack([sm.real, sm.imag]),
        ]
    )  # (2, 2, h+1, n, n)
    got = np.asarray(mmfft.ifft3_half_pair(jnp.asarray(spm)[None]))[0]
    np.testing.assert_allclose(
        got[0] + 1j * got[1], want, atol=1e-10 * np.abs(want).max()
    )


def test_corner_cutoff_routes_to_full_grid():
    """CornerModes + k_cutoff leaves non-Hermitian Nyquist lines (matching
    the reference); the half path must fall back to the full grid."""
    import jax.numpy as jnp

    param = make_params(ZD_k_cutoff=2.0, ZD_CornerModes=1)
    model = Zeldovich(param, dtype=jnp.float64)
    assert not model.half_exact
    full = np.asarray(model.xspace_pair())
    via_half_api = np.asarray(model.xspace_half_pair())  # falls back
    np.testing.assert_array_equal(via_half_api, full)
    with pytest.raises(NotImplementedError):
        model.kspace_half_pair()


def test_c2r_y_pair_z_sliced():
    """c2r_y_pair on a Z-sliced stripe == the full-grid result sliced.

    The transform length must come from the ky axis (2*(h+1-1)), never
    the Z extent: out-of-core stripes and validation probes pass blocks
    whose Z extent differs from the grid size.  Covers the dense matmul
    and df64 forms.
    """
    from zeldovich.ops import mmfft

    rng = np.random.default_rng(23)
    n, h, Z, X = 16, 8, 4, 16  # Z extent != transform length on purpose
    D = rng.normal(size=(n, n, X))
    F = rng.normal(size=(n, n, X))
    Dk = np.fft.fft(D, axis=-3)
    Fk = np.fft.fft(F, axis=-3)
    sp = (Dk + 1j * Fk)[: h + 1]
    sm = (Dk - 1j * Fk)[: h + 1]
    spm = np.stack(
        [np.stack([sp.real, sp.imag]), np.stack([sm.real, sm.imag])]
    )  # (2, 2, h+1, n, X)
    full = np.asarray(mmfft.c2r_y_pair(jnp.asarray(spm)))
    stripe = np.asarray(mmfft.c2r_y_pair(jnp.asarray(spm[..., 2 : 2 + Z, :])))
    assert stripe.shape == (2, n, Z, X)
    scale = np.abs(full).max()
    np.testing.assert_allclose(
        stripe, full[..., 2 : 2 + Z, :], atol=1e-12 * scale, rtol=0
    )
    # df64 pair form (the --dtype df64 transform path)
    s32 = jnp.asarray(spm[..., 2 : 2 + Z, :], jnp.float32)
    z = jnp.zeros_like(s32[..., 0, :, :, :])
    rep = (s32[..., 0, :, :, :], z)
    imp = (s32[..., 1, :, :, :], z)
    out_re, out_im = mmfft._c2r_y_df64(rep, imp)
    got64 = np.stack(
        [np.asarray(mmfft._pair_to_f64(out_re)),
         np.asarray(mmfft._pair_to_f64(out_im))]
    )
    np.testing.assert_allclose(
        got64, full[..., 2 : 2 + Z, :], atol=2e-6 * scale, rtol=0
    )


def test_c2r_assembled_matches_dense():
    """The four-step-capable assembled c2r (the > DENSE_MAX y path) ==
    the dense [n, h+1] matmul form, and both match numpy ground truth."""
    import jax

    from zeldovich.ops import mmfft

    rng = np.random.default_rng(11)
    n, h = 32, 16
    D = rng.normal(size=(2, n, n, n))
    F = rng.normal(size=(2, n, n, n))
    Dk = np.fft.fft(D, axis=-3)
    Fk = np.fft.fft(F, axis=-3)
    sp = (Dk + 1j * Fk)[..., : h + 1, :, :]
    sm = (Dk - 1j * Fk)[..., : h + 1, :, :]
    spm = np.stack(
        [
            np.stack([sp.real, sp.imag], axis=-4),
            np.stack([sm.real, sm.imag], axis=-4),
        ],
        axis=-5,
    )
    dense = np.asarray(mmfft.c2r_y_pair(jnp.asarray(spm)))
    asm = np.asarray(
        mmfft._c2r_y_pair_assembled(jnp.asarray(spm), jax.lax.Precision.HIGHEST)
    )
    want = np.stack(
        [
            np.fft.ifft(Dk, axis=-3).real * n,
            np.fft.ifft(Fk, axis=-3).real * n,
        ],
        axis=-4,
    )
    scale = np.abs(want).max()
    np.testing.assert_allclose(asm, dense, atol=1e-12 * scale, rtol=0)
    np.testing.assert_allclose(asm, want, atol=1e-12 * scale, rtol=0)


@pytest.mark.parametrize("case", ["plain", "plt", "fixed_power", "density"])
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_half_pair_forward_matches_complex(dtype, case):
    """The pair route's fused step (_half_pair_forward) == the default
    complex route (synthesis + jnp.fft), plain, PLT, fixed power and
    density-only."""
    from helpers import model, plt_model

    over = {"fixed_power": {"ZD_qPk_fix_to_mean": 1},
            "density": {"ZD_qdensity": 2}}.get(case, {})
    build = plt_model if case == "plt" else model
    m = build(16, dtype, **over)
    pair = np.asarray(m.xspace_half_pair())
    got = pair[:, 0] + 1j * pair[:, 1]
    want = np.asarray(m.xspace())
    assert got.shape == want.shape
    rel = 1e-12 if dtype == jnp.float64 else 2e-5
    np.testing.assert_allclose(
        got, want, atol=rel * np.abs(want).max(), rtol=0
    )
