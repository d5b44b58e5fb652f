"""Vectorized mode synthesis vs the serial reference emulator."""

import numpy as np
import pytest

import jax.numpy as jnp

from reference_emulator import emulate_kgrid
from zeldovich.ops.modes import SynthConfig, SynthTables, synthesize_slab
from zeldovich.utils.params import Parameters
from zeldovich.utils.power import PowerSpectrum, mode_amplitude_tables

from pathlib import Path

ASSETS = Path(__file__).parent.parent / "zeldovich" / "assets"


def make_setup(ppd=8, **over):
    d = dict(
        BoxSize=100.0,
        NP=ppd**3,
        CPD=100,
        ICFormat="RVZel",
        InitialConditionsDirectory="/tmp/ic",
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
    param = Parameters.from_dict(d)
    Pk = PowerSpectrum(param)
    pk_n2, M_n2 = mode_amplitude_tables(Pk, param)
    cfg = SynthConfig.from_params(param, Pk.fixed_power)
    tables = SynthTables.build(param.seed, param.ppd, pk_n2, M_n2)
    return param, Pk, cfg, tables


def full_grid(cfg, tables, **kw):
    return np.asarray(
        synthesize_slab(0, cfg.ppd, cfg, tables, **kw)
    )


def assert_grids_match(got, want, tol=1e-13):
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol * max(scale, 1e-30), rtol=tol)


@pytest.mark.parametrize("ppd", [8, 12])
def test_matches_emulator_basic(ppd):
    param, Pk, cfg, tables = make_setup(ppd=ppd)
    want = emulate_kgrid(param, Pk)
    got = full_grid(cfg, tables)
    assert_grids_match(got, want)


def test_matches_emulator_seed_and_boxsize():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_Seed=999, BoxSize=250.0)
    assert_grids_match(full_grid(cfg, tables), emulate_kgrid(param, Pk))


def test_matches_emulator_fixed_power():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_qPk_fix_to_mean=1)
    assert cfg.fixed_power
    assert_grids_match(full_grid(cfg, tables), emulate_kgrid(param, Pk))


def test_matches_emulator_k_cutoff():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_k_cutoff=2.0)
    assert_grids_match(full_grid(cfg, tables), emulate_kgrid(param, Pk))


def test_matches_emulator_corner_modes():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_CornerModes=1)
    assert_grids_match(full_grid(cfg, tables), emulate_kgrid(param, Pk))


def test_matches_emulator_corner_modes_with_cutoff():
    """CornerModes + k_cutoff: the self-conjugate Nyquist lines of the
    ky=0 plane escape every zero rule (non-Hermitian, like the reference);
    the full-grid path must still match the serial walk elementwise."""
    param, Pk, cfg, tables = make_setup(
        ppd=8, ZD_CornerModes=1, ZD_k_cutoff=2.0
    )
    assert_grids_match(full_grid(cfg, tables), emulate_kgrid(param, Pk))


def test_matches_emulator_onemode():
    param, Pk, cfg, tables = make_setup(
        ppd=8, ZD_qonemode=1, ZD_one_mode=[2, 1, -1]
    )
    assert_grids_match(full_grid(cfg, tables), emulate_kgrid(param, Pk))


def test_matches_emulator_density_only():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_qdensity=2)
    assert cfg.narray == 1
    assert_grids_match(full_grid(cfg, tables), emulate_kgrid(param, Pk))


def test_matches_emulator_smoothing():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_Pk_smooth=5.0)
    assert_grids_match(full_grid(cfg, tables), emulate_kgrid(param, Pk))


def test_gen_phi_matches_emulator():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_f_NL=10.0)
    want = emulate_kgrid(param, Pk, gen_phi=True)
    got = full_grid(cfg, tables, gen_phi=True)
    assert_grids_match(got, want)


def test_input_phi_matches_emulator():
    param, Pk, cfg, tables = make_setup(ppd=8, ZD_f_NL=10.0)
    rng = np.random.default_rng(3)
    phi = rng.normal(size=(8, 8, 8)) + 1j * rng.normal(size=(8, 8, 8))
    want = emulate_kgrid(param, Pk, phi_k=phi)
    got = full_grid(cfg, tables, phi_k=jnp.asarray(phi))
    assert_grids_match(got, want)


def test_oversampling_phase_match():
    """ppd=16 with k_cutoff=2 must contain exactly the ppd=8 modes."""
    p8, Pk8, cfg8, t8 = make_setup(ppd=8)
    p16, Pk16, cfg16, t16 = make_setup(ppd=16, ZD_k_cutoff=2.0)
    g8 = full_grid(cfg8, t8)
    g16 = full_grid(cfg16, t16)
    # mode (kx,ky,kz) lives at index (k mod ppd); amplitudes differ only by
    # the box-volume normalization (same box => identical)
    for (kx, ky, kz) in [(1, 2, 3), (-2, 1, 1), (3, 0, -3), (1, 0, 0)]:
        i8 = (ky % 8, kz % 8, kx % 8)
        i16 = (ky % 16, kz % 16, kx % 16)
        np.testing.assert_allclose(
            g16[(0, *i16)], g8[(0, *i8)], rtol=1e-12,
            err_msg=f"mode {(kx, ky, kz)}",
        )


def test_hermitian_symmetry_gives_real_field():
    """The packed arrays must inverse-FFT to fields with zero imaginary
    part... actually to *pairs* of real fields: A -> delta + i q_x with both
    delta and q_x real, which holds iff D and F are separately Hermitian."""
    param, Pk, cfg, tables = make_setup(ppd=12)
    G = full_grid(cfg, tables)
    n = param.ppd
    xspace = np.fft.ifftn(G, axes=(1, 2, 3)) * n**3
    # Re and Im of each array are independent real fields; Hermitianity of
    # the packing means the *decoded* fields are real automatically. Check
    # via the k-space symmetry of the unpacked components:
    for a in range(G.shape[0]):
        A = G[a]
        refl = np.conj(
            A[(-np.arange(n)) % n][:, (-np.arange(n)) % n][:, :, (-np.arange(n)) % n]
        )
        D = 0.5 * (A + refl)  # should equal the Hermitian part = delta-like
        F = -0.5j * (A - refl)
        # D and F Hermitian <=> their x-space transforms are real
        Dx = np.fft.ifftn(D, axes=(0, 1, 2))
        Fx = np.fft.ifftn(F, axes=(0, 1, 2))
        assert np.abs(Dx.imag).max() < 1e-15 * max(np.abs(Dx.real).max(), 1e-30)
        assert np.abs(Fx.imag).max() < 1e-15 * max(np.abs(Fx.real).max(), 1e-30)


def test_v1_matches_emulator():
    """Legacy ZD_Version=1 (MT19937 + rejection) vs the serial emulator."""
    import jax.numpy as jnp
    from zeldovich.ops import v1 as v1_ops

    param, Pk, cfg, tables = make_setup(ppd=8, ZD_Version=1, ZD_NumBlock=4)
    from zeldovich.utils.power import mode_amplitude_tables

    pk_n2, _ = mode_amplitude_tables(Pk, param)
    D = jnp.asarray(v1_ops.generate_D_half(param, Pk, pk_n2))
    got = np.asarray(synthesize_slab(0, 8, cfg, tables, D_source=D))
    want = emulate_kgrid(param, Pk)
    assert_grids_match(got, want)


def test_v1_numblock_changes_phases():
    """v1 phases depend on ZD_NumBlock (the documented v1 defect)."""
    import jax.numpy as jnp
    from zeldovich.ops import v1 as v1_ops
    from zeldovich.utils.power import mode_amplitude_tables

    outs = []
    for nb in (2, 4):
        param, Pk, cfg, tables = make_setup(ppd=8, ZD_Version=1, ZD_NumBlock=nb)
        pk_n2, _ = mode_amplitude_tables(Pk, param)
        D = v1_ops.generate_D_half(param, Pk, pk_n2)
        outs.append(D)
    assert not np.allclose(outs[0], outs[1])


def test_precompose_off_matches():
    """1-D compose path (big-ppd fallback) equals the precomposed tables."""
    param, Pk, cfg, tables = make_setup(ppd=12)
    t1 = SynthTables.build(
        param.seed, 12, np.asarray(tables.pk_n2), precompose=False
    )
    assert t1.mzx is None and tables.mzx is not None
    np.testing.assert_array_equal(
        full_grid(cfg, t1), full_grid(cfg, tables)
    )


def test_float32_fast_path_accuracy():
    """The f32 path reproduces f64 displacements to ~1e-5 relative."""
    param, Pk, cfg, tables = make_setup(ppd=16)
    g64 = full_grid(cfg, tables, dtype=jnp.float64)
    g32 = full_grid(cfg, tables, dtype=jnp.float32)
    assert g32.dtype == np.complex64
    scale = np.abs(g64).max()
    err = np.abs(g32 - g64).max() / scale
    assert err < 5e-5, err
